"""The training slice's losses, metrics, schedules, optimizers and data path
against the JAX package on the CPU.

Inputs come from numpy with a seed; both sides get the same arrays. The
augmentations cannot share a PRNG, so the JAX draws are read off its keys
and handed to the port's transforms. The JAX package reads its MICFORMER_*
flags at import; they are cleared here first.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from micformer_tpu.data import loader as jloader  # noqa: E402
from micformer_tpu.data import mmwhs as jmmwhs  # noqa: E402
from micformer_tpu.data import synthetic as jsyn  # noqa: E402
from micformer_tpu.data import transforms as jtf  # noqa: E402
from micformer_tpu.losses import dice as jdice  # noqa: E402
from micformer_tpu.losses.metrics import meandice as jmeandice  # noqa: E402
from micformer_tpu.train import schedules as jsched  # noqa: E402
from micformer_tpu.train.trainer import TrainConfig as JConfig  # noqa: E402
from micformer_tpu.train.trainer import _make_tx  # noqa: E402
from micformer_tpu_torch.data import loader as tloader  # noqa: E402
from micformer_tpu_torch.data import mmwhs as tmmwhs  # noqa: E402
from micformer_tpu_torch.data import synthetic as tsyn  # noqa: E402
from micformer_tpu_torch.data import transforms as ttf  # noqa: E402
from micformer_tpu_torch.losses import dice as tdice  # noqa: E402
from micformer_tpu_torch.losses.metrics import meandice as tmeandice  # noqa: E402
from micformer_tpu_torch.train import schedules as tsched  # noqa: E402
from micformer_tpu_torch.train.trainer import (  # noqa: E402
    TrainConfig, clip_by_global_norm, make_optimizer, unit_schedule,
)


def _logits_and_onehot(seed, shape=(2, 8, 6, 7, 5)):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=shape)).astype(np.float32)
    idx = rng.integers(0, shape[1], size=(shape[0],) + shape[2:])
    onehot = np.moveaxis(np.eye(shape[1], dtype=np.float32)[idx], -1, 1)
    return logits, onehot, idx


# f32 reductions over a few hundred voxels in another order
@pytest.mark.parametrize("name", ["mdice_loss", "mdice_val_loss", "hard_dice_metric"])
def test_losses_match_jax(name):
    logits, onehot, _ = _logits_and_onehot(0)
    onehot[1, 3] = 0.0                       # an empty target channel
    logits[1, 3] = -5.0                      # ... predicted empty: scores 1
    onehot[0, 4] = 0.0                       # an empty target channel
    logits[0, 4, 0, 0, 0] = 5.0              # ... with one predicted voxel: 0
    want = np.asarray(getattr(jdice, name)(jnp.asarray(logits), jnp.asarray(onehot)))
    got = getattr(tdice, name)(torch.from_numpy(logits), torch.from_numpy(onehot))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if name == "hard_dice_metric":
        assert got[1, 3] == 1.0 and got[0, 4] == 0.0
    bf = getattr(tdice, name)(torch.from_numpy(logits).bfloat16(), torch.from_numpy(onehot))
    assert bf.dtype == torch.float32


def test_meandice_and_one_hot_match_jax():
    logits, onehot, idx = _logits_and_onehot(1)
    pred = logits.argmax(1)
    for num_class in (8, 5):
        want = float(jmeandice(jnp.asarray(pred), jnp.asarray(idx), num_class))
        got = tmeandice(torch.from_numpy(pred), torch.from_numpy(idx), num_class)
        assert got.item() == pytest.approx(want, rel=1e-6)
    np.testing.assert_array_equal(
        tdice.one_hot(torch.from_numpy(idx.astype(np.uint8)), 8).numpy(), onehot)


def test_schedules_match_jax():
    """JAX evaluates the schedules in f32, the port in f64: equal to 1e-6 of
    the base rate."""
    for per_batch in (True, False):
        j = jsched.cosine_annealing(1e-3, 7, eta_min=1e-5, steps_per_epoch=3,
                                    per_batch=per_batch)
        t = tsched.cosine_annealing(1e-3, 7, eta_min=1e-5, steps_per_epoch=3,
                                    per_batch=per_batch)
        for step in range(40):
            assert t(step) == pytest.approx(float(j(step)), rel=0, abs=1e-9)
    j, t = jsched.poly_lr(0.01, 25), tsched.poly_lr(0.01, 25)
    for step in range(40):
        assert t(step) == pytest.approx(float(j(step)), rel=0, abs=1e-8)


@pytest.mark.parametrize("cfg", [
    dict(optimizer="adam"),
    dict(optimizer="adam", weight_decay=0.05, scheduler="poly"),
    dict(optimizer="adamw", weight_decay=0.1, grad_clip_norm=0.5),
    dict(optimizer="sgd_nesterov", scheduler_per_batch=False, grad_clip_norm=100.0),
    dict(optimizer="sgd_nesterov", scheduler="constant", grad_clip_norm=0.3),
])
def test_optimizer_steps_match_optax(cfg):
    """Three steps on one fixed gradient tree: the optimizer, then the
    schedule multiplier (LambdaLR, first step at schedule(0)), after global
    norm clipping where set. f32, atol 1e-6 on unit-scale parameters."""
    kw = dict(lr=0.01, epochs=4, steps_per_epoch=2, **cfg)
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx, _ = _make_tx(JConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)

    tcfg = TrainConfig(**kw)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    opt = make_optimizer(tp, tcfg)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, unit_schedule(tcfg))
    for g in grads:
        for p, k in zip(tp, ("a", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        if tcfg.grad_clip_norm:
            clip_by_global_norm(tp, tcfg.grad_clip_norm)
        opt.step()
        sched.step()
    for p, k in zip(tp, ("a", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6)


def test_kfold_split_matches_jax_and_sklearn():
    try:
        from sklearn.model_selection import KFold
    except ImportError:
        KFold = None
    for n in (5, 6, 7, 11, 20):
        for seed in (0, 1234):
            for fold in range(5):
                got = tmmwhs.kfold_split(n, 5, seed, fold)
                want = jmmwhs.kfold_split(n, 5, seed, fold)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
                if KFold is not None:
                    tr, held = list(KFold(5, shuffle=True, random_state=seed)
                                    .split(np.arange(n)))[fold]
                    np.testing.assert_array_equal(got[0], tr)
                    np.testing.assert_array_equal(np.concatenate(got[1:]), held)


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mmwhs")
    paths = tsyn.write_synthetic_dataset(str(root), n_cases=6, shape=(20, 18, 22), seed=3)
    return root, paths


def test_synthetic_cases_match_jax():
    for a, b in zip(tsyn.make_case(np.random.default_rng(4), (12, 10, 14)),
                    jsyn.make_case(np.random.default_rng(4), (12, 10, 14))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsyn.synthetic_batch(5, 2, (4, 6, 5)), jsyn.synthetic_batch(5, 2, (4, 6, 5))):
        np.testing.assert_array_equal(a, b)


def test_preprocess_and_dataset_match_jax(synthetic_root, tmp_path):
    root, _ = synthetic_root
    tcases, jcases = tmmwhs.discover_cases(str(root)), jmmwhs.discover_cases(str(root))
    assert [c.patient_id for c in tcases] == [c.patient_id for c in jcases]
    timg, tlab = tmmwhs.preprocess_case(tcases[0], (16, 16, 16))
    jimg, jlab = jmmwhs.preprocess_case(jcases[0], (16, 16, 16))
    # the JAX package may resize with its native library: f32, another order
    np.testing.assert_allclose(timg, jimg, atol=1e-6)
    np.testing.assert_array_equal(tlab, jlab)
    tsets = tmmwhs.get_datasets(str(root), seed=7, cache_dir=str(tmp_path / "t"),
                                target_shape=(16, 12, 16))
    jsets = jmmwhs.get_datasets(str(root), seed=7, cache_dir=str(tmp_path / "j"),
                                target_shape=(16, 12, 16))
    for tds, jds in zip(tsets, jsets):
        assert len(tds) == len(jds) and tds.training == jds.training
        for i in range(len(tds)):
            for _ in range(2):                  # the second read is the cache's
                t, j = tds[i], jds[i]
                assert t["patient_id"] == j["patient_id"]
                assert t["crop_indexes"] == j["crop_indexes"]
                np.testing.assert_allclose(t["image"], j["image"], atol=1e-6)
                np.testing.assert_array_equal(t["label"], j["label"])
    assert [len(s) for s in tsets] == [4, 1, 1]


def test_stack_batch_and_loader_match_jax(synthetic_root):
    root, _ = synthetic_root
    ds = tmmwhs.MMWHSDataset(tmmwhs.discover_cases(str(root)), training=False,
                             target_shape=(8, 8, 8))
    samples = [ds[0], ds[1]]
    ti, tl, tm = tloader._stack_batch(samples)
    ji, jl, jm = jloader._stack_batch(samples, compact=True)
    assert ti.dtype == torch.float16 and tl.dtype == torch.uint8
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert tm == jm
    loader = tloader.DataLoader(ds, batch_size=4, shuffle=True, seed=3, workers=2)
    jl = jloader.DataLoader(ds, batch_size=4, shuffle=True, seed=3, device_put=False)
    assert len(loader) == 2
    for _ in range(2):                        # two epochs, a new order each
        for (ti, tl, tm), (ji, jl_, jm) in zip(loader, jl):
            assert tm["patient_id"] == jm["patient_id"]
            np.testing.assert_array_equal(ti.numpy(), ji)
            np.testing.assert_array_equal(tl.numpy(), jl_)


def _aug_batch(seed, B=2, C=2, K=4, shape=(5, 6, 4)):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, C) + shape).astype(np.float32)
    img[rng.random(img.shape) < 0.3] = 0.0        # zeros the normalisation skips
    idx = rng.integers(0, K, size=(B,) + shape)
    lab = np.moveaxis(np.eye(K, dtype=np.float32)[idx], -1, 1)
    return img, lab


def test_transforms_match_jax_given_the_same_draws():
    img, lab = _aug_batch(0)
    key = jax.random.key(9)
    # single transforms on one sample, the draw read off the JAX key
    for axis in range(3):
        do = bool(jax.random.bernoulli(key, 0.5))
        ji, jl = jtf.rand_flip(key, jnp.asarray(img[0]), jnp.asarray(lab[0]), axis)
        ti, tl = ttf.flip(torch.from_numpy(img[0]), torch.from_numpy(lab[0]), axis, do)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(tl.numpy(), jl)
        key = jax.random.split(key)[0]
    kf, _ = jax.random.split(key)
    f = float(jax.random.uniform(kf, (), minval=-0.1, maxval=0.1))
    np.testing.assert_allclose(ttf.scale_intensity(torch.from_numpy(img), f).numpy(),
                               jtf.rand_scale_intensity(key, jnp.asarray(img)), rtol=1e-6)
    np.testing.assert_allclose(ttf.shift_intensity(torch.from_numpy(img), f).numpy(),
                               jtf.rand_shift_intensity(key, jnp.asarray(img)), atol=1e-6)
    np.testing.assert_allclose(
        ttf.normalize_intensity_nonzero(torch.from_numpy(img)).numpy(),
        jtf.normalize_intensity_nonzero(jnp.asarray(img)), atol=1e-5)
    for nm in (None, 1):
        np.testing.assert_allclose(ttf.val_normalize(torch.from_numpy(img), nm).numpy(),
                                   jtf.val_normalize(jnp.asarray(img), nm), atol=1e-5)


def test_rand_transforms_apply_their_generator_draw():
    """rand_flip / rand_scale_intensity / rand_shift_intensity are the
    deterministic transforms applied to one draw from the generator: a coin
    at prob, U(-0.1, 0.1) factors and offsets."""
    img, lab = (torch.from_numpy(a[0]) for a in _aug_batch(2))
    for seed in range(6):
        for axis in range(3):
            do = torch.rand((), generator=torch.Generator().manual_seed(seed)) < 0.5
            got = ttf.rand_flip(torch.Generator().manual_seed(seed), img, lab, axis)
            for g, w in zip(got, ttf.flip(img, lab, axis, do)):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
        u = torch.rand((), generator=torch.Generator().manual_seed(seed)) * 0.2 - 0.1
        torch.testing.assert_close(
            ttf.rand_scale_intensity(torch.Generator().manual_seed(seed), img),
            ttf.scale_intensity(img, u), rtol=0, atol=0)
        torch.testing.assert_close(
            ttf.rand_shift_intensity(torch.Generator().manual_seed(seed), img),
            ttf.shift_intensity(img, u), rtol=0, atol=0)
        assert -0.1 <= u <= 0.1


@pytest.mark.parametrize("num_modalities", [None, 1])
def test_batched_train_augment_matches_jax_given_the_same_draws(num_modalities):
    img, lab = _aug_batch(1, B=3)
    key = jax.random.key(4)
    want_i, want_l = jtf.batched_train_augment(key, jnp.asarray(img), jnp.asarray(lab),
                                               num_modalities)
    flips, scales, shifts = [], [], []
    for k in jax.random.split(key, img.shape[0]):
        ks = jax.random.split(k, 5)
        flips.append([bool(jax.random.bernoulli(ks[i], 0.5)) for i in range(3)])
        scales.append(float(jax.random.uniform(jax.random.split(ks[3])[0], (),
                                               minval=-0.1, maxval=0.1)))
        shifts.append(float(jax.random.uniform(jax.random.split(ks[4])[0], (),
                                               minval=-0.1, maxval=0.1)))
    draws = {"flip": torch.tensor(flips), "scale": torch.tensor(scales),
             "shift": torch.tensor(shifts)}
    got_i, got_l = ttf.apply_train_augment(torch.from_numpy(img), torch.from_numpy(lab),
                                           draws, num_modalities)
    np.testing.assert_allclose(got_i.numpy(), want_i, atol=1e-5)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    # the port's own draws: a flip is a coin, the intensity terms U(-0.1, 0.1)
    gen = torch.Generator().manual_seed(0)
    d = ttf.draw_train_augment(gen, 4000)
    assert d["flip"].dtype == torch.bool and 0.45 < d["flip"].float().mean() < 0.55
    for k in ("scale", "shift"):
        assert -0.1 <= d[k].min() and d[k].max() <= 0.1 and abs(d[k].mean()) < 0.01
