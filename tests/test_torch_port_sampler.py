"""The port's training data path against the JAX package's on the CPU,
bitwise for the same seeds: nnU-Net's class locations, patch sampling and
foreground-oversampled patch dataset; the cascade's structuring element,
pyramid augmentations and dataset; the single-modal MM-WHS dataset; and the
loader's spawned process workers against its threads.
"""

import os

import numpy as np
import pytest
import torch

from micformer_tpu.data import cascade as jcas
from micformer_tpu.data import mmwhs as jmm
from micformer_tpu.data import patch_sampler as jps
from micformer_tpu_torch.data import cascade as tcas
from micformer_tpu_torch.data import mmwhs as tmm
from micformer_tpu_torch.data import patch_sampler as tps
from micformer_tpu_torch.data.loader import DataLoader
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset


def _label(seed, shape=(14, 12, 16), classes=5):
    """An integer map of a few blobs of each class on background."""
    rng = np.random.default_rng(seed)
    lab = np.zeros(shape, np.int64)
    for c in range(1, classes):
        for _ in range(2):
            centre = rng.integers(0, shape)
            r = rng.integers(1, 4)
            z, y, x = np.ogrid[:shape[0], :shape[1], :shape[2]]
            lab[(z - centre[0]) ** 2 + (y - centre[1]) ** 2 + (x - centre[2]) ** 2 <= r * r] = c
    return lab


def _onehot(lab, classes=8):
    return np.moveaxis(np.eye(classes, dtype=np.uint8)[lab], -1, 0).copy()


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


class _Cases:
    """A case-level dataset of sample dicts (image [2, ...] float32, label
    [8, ...] uint8 one-hot), as MMWHSDataset gives them."""

    def __init__(self, n=3, shape=(14, 12, 16)):
        self.samples = []
        for i in range(n):
            rng = np.random.default_rng(100 + i)
            self.samples.append(dict(patient_id=f"{1001 + i}",
                                     image=rng.uniform(0, 1, (2,) + shape).astype(np.float32),
                                     label=_onehot(_label(i, shape))))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return dict(self.samples[i])


@pytest.mark.parametrize("max_per_class", [10000, 7], ids=["all", "subsampled"])
@pytest.mark.parametrize("onehot", [False, True], ids=["map", "onehot"])
def test_class_locations_match_jax(max_per_class, onehot):
    lab = _label(0)
    lab = _onehot(lab) if onehot else lab
    want = jps.compute_class_locations(lab, range(1, 8), max_per_class, seed=3)
    got = tps.compute_class_locations(lab, range(1, 8), max_per_class, seed=3)
    assert list(got) == list(want) == [1, 2, 3, 4]
    for c in want:
        _assert_same(got[c], want[c])


@pytest.mark.parametrize("force_fg", [False, True], ids=["random", "foreground"])
@pytest.mark.parametrize("patch", [(8, 6, 10), (16, 14, 12)], ids=["crop", "padded"])
def test_sample_patch_matches_jax(force_fg, patch):
    cases = _Cases(1)
    image, label = cases[0]["image"], cases[0]["label"].astype(np.float32)
    locs = jps.compute_class_locations(label, range(1, 8))
    for seed in range(6):
        want = jps.sample_patch(image, label, patch, force_fg, locs, np.random.default_rng(seed))
        got = tps.sample_patch(image, label, patch, force_fg, locs, np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.shape[1:] == patch
            _assert_same(g, w)


def test_oversampled_patch_dataset_matches_jax_and_forces_foreground():
    """Three visits of every item (a visit counter a position), batch 3 at
    p 0.33: positions 2 mod 3 (>= round(3·0.67)) hold foreground."""
    kw = dict(patch_size=(6, 6, 6), batch_size=3, oversample_foreground_percent=0.33,
              num_classes=8, seed=5)
    want, got = jps.OversampledPatchDataset(_Cases(9), **kw), tps.OversampledPatchDataset(
        _Cases(9), **kw)
    assert len(got) == len(want) == 9
    assert [got._force_fg(p) for p in range(3)] == [want._force_fg(p) for p in range(3)] == [
        False, False, True]
    for _ in range(3):
        for i in range(len(got)):
            w, g = want[i], got[i]
            assert g["patient_id"] == w["patient_id"]
            _assert_same(g["image"], w["image"])
            _assert_same(g["label"], w["label"])
            assert g["label"].dtype == np.float32
            if i % 3 == 2:
                assert g["label"][1:].any()


def test_ball_and_binary_operator_match_jax():
    for r in (1.0, 2.5, 3.7):
        _assert_same(tcas.ball(r), jcas.ball(r))
    oh = tcas.seg_to_onehot(_label(1), range(1, 5))
    for seed in range(12):
        kw = dict(p_per_sample=1.0 if seed % 2 else 0.4, strel_size=(1, 3))
        _assert_same(tcas.apply_random_binary_operator(oh, np.random.default_rng(seed), **kw),
                     jcas.apply_random_binary_operator(oh, np.random.default_rng(seed), **kw))


@pytest.mark.parametrize("swap", [False, True], ids=["intent", "moreda_swap"])
def test_remove_connected_component_matches_jax(swap):
    oh = tcas.seg_to_onehot(_label(2), range(1, 5))
    changed = 0
    for seed in range(12):
        kw = dict(p_per_sample=1.0, fill_with_other_class_p=0.5,
                  dont_do_if_covers_more_than=0.15, faithful_moreda_swap=swap)
        got = tcas.remove_random_connected_component(oh, np.random.default_rng(seed), **kw)
        _assert_same(got, jcas.remove_random_connected_component(
            oh, np.random.default_rng(seed), **kw))
        changed += int(not np.array_equal(got, oh))
    assert changed > 0


def test_cascade_augment_matches_jax():
    oh = tcas.seg_to_onehot(_label(3), range(1, 8))
    changed = 0
    for seed in range(16):
        got = tcas.cascade_augment_onehot(oh, np.random.default_rng(seed))
        _assert_same(got, jcas.cascade_augment_onehot(oh, np.random.default_rng(seed)))
        changed += int(not np.array_equal(got, oh))
    assert changed > 0


@pytest.mark.parametrize("augment", [False, True], ids=["val", "train"])
def test_cascade_dataset_matches_jax(tmp_path, augment):
    """Previous-stage maps at half resolution, resized nearest to the image
    grid; two visits of each item draw two augmentation streams."""
    base = _Cases()
    for s in base.samples:
        lab = np.argmax(s["label"], axis=0).astype(np.uint8)
        np.save(tmp_path / f"{s['patient_id']}_segFromPrevStage.npy", lab[::2, ::2, ::2])
    want = jcas.CascadeDataset(base, str(tmp_path), 8, augment=augment, seed=7)
    got = tcas.CascadeDataset(base, str(tmp_path), 8, augment=augment, seed=7)
    for _ in range(2):
        for i in range(len(base)):
            g, w = got[i], want[i]
            assert g["image"].shape == (9, 14, 12, 16)
            _assert_same(g["image"], w["image"])
            _assert_same(g["label"], w["label"])


@pytest.fixture(scope="module")
def mm_root(tmp_path_factory):
    # a directory name free of "ct" and "image", which the JAX package's
    # CasePaths rewrites across the whole path
    root = tmp_path_factory.mktemp("mm")
    write_synthetic_dataset(str(root / "data"), n_cases=6, shape=(20, 18, 22), seed=0)
    return root


@pytest.mark.parametrize("single_modal", [False, True], ids=["two_modal", "single_modal"])
def test_mmwhs_datasets_match_jax(mm_root, tmp_path, single_modal):
    """The sample dicts of the three splits, bitwise, over one preprocessed
    cache: the JAX datasets write it, the port's read it. (Preprocessing's
    trilinear resize differs from JAX's by an ulp; test_torch_port_train_data
    holds it within 1e-6.)"""
    kw = dict(cache_dir=str(tmp_path / "cache"), target_shape=(16, 16, 16),
              single_modal=single_modal)
    want = jmm.get_datasets(str(mm_root / "data"), **kw)
    got = tmm.get_datasets(str(mm_root / "data"), **kw)
    for w_ds, g_ds in zip(want, got):
        assert len(g_ds) == len(w_ds)
        for i in range(len(g_ds)):
            w, g = w_ds[i], g_ds[i]
            assert g["image"].shape[0] == (1 if single_modal else 2)
            assert g["patient_id"] == w["patient_id"]
            assert g["crop_indexes"] == w["crop_indexes"]
            _assert_same(g["image"], w["image"])
            _assert_same(g["label"], w["label"])


def test_mmwhs_training_crop_to_a_patch_matches_jax(mm_root, tmp_path):
    """A training dataset whose patch is smaller than the target shape draws
    its random crops from its seeded generator, as JAX's does."""
    kw = dict(training=True, target_shape=(16, 16, 16), cache_dir=str(tmp_path / "cache"),
              patch_size=(12, 10, 14), seed=5)
    jcases = jmm.discover_cases(str(mm_root / "data"))
    want = jmm.MMWHSDataset(jcases, **kw)
    got = tmm.MMWHSDataset(tmm.discover_cases(str(mm_root / "data")), **kw)
    for _ in range(2):
        for i in range(len(got)):
            w, g = want[i], got[i]
            assert g["image"].shape == (2, 12, 10, 14)
            _assert_same(g["image"], w["image"])
            _assert_same(g["label"], w["label"])


def _batches(loader, epochs=2):
    out = [b for _ in range(epochs) for b in loader]
    loader.close()
    return out


@pytest.mark.parametrize("wrap", ["plain", "cascade"])
def test_process_workers_give_the_thread_batches(mm_root, tmp_path, wrap):
    """Two shuffled epochs of batch 2: spawned process workers (each sent a
    pickled copy of the dataset) give the thread workers' batches. The
    cascade's validation form has no visit-dependent draws."""
    ds, _, _ = tmm.get_datasets(str(mm_root / "data"), cache_dir=str(tmp_path / "c"),
                                target_shape=(16, 16, 16))
    if wrap == "cascade":
        for i in range(len(ds)):
            s = ds[i]
            np.save(tmp_path / f"{s['patient_id']}_segFromPrevStage.npy",
                    np.argmax(s["label"], axis=0).astype(np.uint8)[::2, ::2, ::2])
        ds = tcas.CascadeDataset(ds, str(tmp_path), 8, augment=False)
    kw = dict(batch_size=2, shuffle=True, seed=3, workers=2)
    threads = _batches(DataLoader(ds, worker_mode="thread", **kw))
    procs = _batches(DataLoader(ds, worker_mode="process", **kw))
    assert len(procs) == len(threads) == 4
    for (ti, tl, tm), (pi, pl, pm) in zip(threads, procs):
        assert tm["patient_id"] == pm["patient_id"]
        assert ti.shape[1] == (9 if wrap == "cascade" else 2)
        assert torch.equal(ti, pi) and torch.equal(tl, pl)


def test_process_pool_shuts_down_on_close(mm_root, tmp_path):
    ds, _, _ = tmm.get_datasets(str(mm_root / "data"), cache_dir=str(tmp_path / "c"),
                                target_shape=(16, 16, 16))
    loader = DataLoader(ds, batch_size=2, workers=2, worker_mode="process")
    next(iter(loader))
    procs = list(loader._pool._processes.values())
    loader.close()
    for p in procs:
        p.join(timeout=30)
        assert not p.is_alive()
    assert os.path.exists(tmp_path / "c")
