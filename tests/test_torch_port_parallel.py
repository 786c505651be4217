"""The port's data-parallel building blocks on the CPU: the global-batch
losses over gloo ranks against one process on the whole batch, and
`global_dice_sums` against the JAX one under shard_map; the loader's rank
rows; the augmentation and DropPath draws of a rank's rows; the mesh
helpers.

The ranks are spawned processes that import no JAX (`torch_port_ranks`);
the JAX side runs here, on the conftest's virtual CPU devices.
Tolerances: the losses and their gradients are f32 sums taken in another
order (per rank, then over the ranks): 1e-6 relative to the loss and
1e-5 of the largest gradient.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from micformer_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from micformer_tpu.parallel.mesh import global_dice_sums as jglobal_dice_sums  # noqa: E402
from micformer_tpu_torch.data.loader import DataLoader  # noqa: E402
from micformer_tpu_torch.data.transforms import (  # noqa: E402
    batched_nnunet_train_augment, batched_train_augment,
)
from micformer_tpu_torch.models.layers import DropPath, batch_rows  # noqa: E402
from micformer_tpu_torch.parallel import mesh as tmesh  # noqa: E402

import torch_port_ranks as ranks  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[2, 3], ids=["W2", "W3"])
def spawned(request, tmp_path_factory):
    """(world, each rank's losses, the whole batch's losses)."""
    world = request.param
    torch.set_num_threads(1)
    out = ranks.run_ranks(world, tmp_path_factory.mktemp(f"losses{world}"),
                          ranks.losses_worker)
    return world, out, ranks.whole_batch_losses(world)


@pytest.mark.parametrize("name", ranks.LOSS_NAMES)
def test_global_batch_loss_equals_the_whole_batch(spawned, name):
    """Every rank reports the whole batch's loss; the ranks' gradients,
    stacked in rank order and divided by W (the mean DDP takes over the
    ranks), are the whole batch's gradient."""
    world, out, whole = spawned
    want, gwant, glow = whole[name]
    for r in out:
        assert abs(r[name][0] - want) <= 1e-6 * max(abs(want), 1.0), (r[name][0], want)
    got = np.concatenate([r[name][1] for r in out]) / world
    np.testing.assert_allclose(got, gwant, rtol=0, atol=1e-5 * np.abs(gwant).max())
    if name == "pyramid":
        got = np.concatenate([r[name][2] for r in out]) / world
        np.testing.assert_allclose(got, glow, rtol=0, atol=1e-5 * np.abs(glow).max())
    assert not np.allclose(out[0][name][1], 0.0)


def test_global_dice_sums_match_jax_under_shard_map(spawned):
    world, out, _ = spawned
    logits, target, _ = ranks.loss_batch(world)
    probs = 1.0 / (1.0 + np.exp(-logits))
    mesh = jmake_mesh(data=world, devices=jax.devices()[:world])
    want = jax.jit(jax.shard_map(
        lambda p, t: jglobal_dice_sums(p, t), mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=P(), check_vma=False))(jnp.asarray(probs), jnp.asarray(target))
    for r in out:
        for got, w in zip(r["global_dice_sums"], want):
            np.testing.assert_allclose(got, np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_rank_rows_concatenate_to_the_single_process_batches(mode):
    ds = ranks.Items()
    whole = [m["patient_id"] for _, _, m in DataLoader(ds, batch_size=6, shuffle=True, seed=3)]
    for world in (2, 3) if mode == "thread" else (2,):
        loaders = [DataLoader(ds, batch_size=6, shuffle=True, seed=3, workers=2,
                              worker_mode=mode, rank=r, world=world) for r in range(world)]
        try:
            assert {len(ld) for ld in loaders} == {2}
            per_rank = [list(ld) for ld in loaders]
        finally:
            for ld in loaders:
                ld.close()
        for b, want in enumerate(whole):
            got = sum((per_rank[r][b][2]["patient_id"] for r in range(world)), [])
            assert got == want
            images = torch.cat([per_rank[r][b][0] for r in range(world)])
            np.testing.assert_array_equal(images[:, 0, 0, 0, 0].numpy(),
                                          [int(p[1:]) for p in want])
    with pytest.raises(ValueError, match="global batch of 3 .* data=2"):
        DataLoader(ds, batch_size=3, rank=0, world=2)
    with pytest.raises(ValueError, match="global batch of 1 .* data=2"):
        DataLoader(ranks.Items(11), batch_size=2, rank=0, world=2)    # the last batch


@pytest.mark.parametrize("stack", ["monai", "nnunet"])
def test_rank_rows_of_augmentation_draws_equal_the_single_process(stack):
    """A rank drawing for the global batch and keeping its rows transforms
    them as a single process transforms the whole batch."""
    fn = batched_train_augment if stack == "monai" else batched_nnunet_train_augment
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(4, 2, 8, 8, 8)).astype(np.float32))
    labels = torch.from_numpy(np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 8, 8, 8))]
                              ).permute(0, 4, 1, 2, 3)
    img, lab = fn(torch.Generator().manual_seed(1), images, labels)
    for world in (2, 4):
        per = 4 // world
        for r in range(world):
            rows = slice(r * per, (r + 1) * per)
            gi, gl = fn(torch.Generator().manual_seed(1), images[rows], labels[rows],
                        rows=(r * per, 4))
            torch.testing.assert_close(gi, img[rows], rtol=0, atol=0)
            torch.testing.assert_close(gl, lab[rows], rtol=0, atol=0)


def test_drop_path_draws_the_global_rows():
    dp = DropPath(0.5).train()
    x = torch.ones(6, 3, 2)
    whole = dp(x, torch.Generator().manual_seed(4))
    for first in (0, 2, 4):
        with batch_rows(first, 6):
            part = dp(x[:2], torch.Generator().manual_seed(4))
        torch.testing.assert_close(part, whole[first:first + 2], rtol=0, atol=0)
    assert 0 < int((whole[:, 0, 0] != 0).sum()) < 6


def test_mesh_helpers():
    assert tmesh.parse_mesh("data=4,space=2") == {"data": 4, "space": 2}
    for bad in ("data=4,model=2", "data", "data=0", "data=2,data=2"):
        with pytest.raises(ValueError):
            tmesh.parse_mesh(bad)
    m = tmesh.make_mesh("data=1")
    assert (m.data, m.space, m.rank) == (1, 1, 0) and tmesh.is_primary()
    with pytest.raises(ValueError, match="world size 1"):
        tmesh.make_mesh("data=2")
    assert tmesh.shard_cases(range(10)) == list(range(10))
    assert tmesh.shard_cases(range(10), 1, 3) == [1, 4, 7]
    assert tmesh.rank_rows(6, 2, 3) == slice(4, 6)
    with pytest.raises(ValueError):
        tmesh.rank_rows(5, 0, 2)
    assert tmesh.Mesh(2, 2, 3).data_index == 1 and tmesh.Mesh(4, 1, 3).data_index == 3


def test_an_interrupted_cache_write_leaves_no_file_a_later_load_takes(tmp_path, monkeypatch):
    """Ranks (and runs) share the preprocessing cache: a write cut short
    must leave no file that a later load takes for a whole one. The cache
    writes through a temporary file renamed into place; before, a label file
    cut short stayed under its final name and the next load failed on it."""
    from micformer_tpu_torch.data import mmwhs
    from micformer_tpu_torch.data.synthetic import write_synthetic_dataset

    write_synthetic_dataset(str(tmp_path / "d"), n_cases=6, shape=(12, 12, 12), seed=0)
    ds = mmwhs.get_datasets(str(tmp_path / "d"), cache_dir=str(tmp_path / "c"),
                            target_shape=(8, 8, 8))[2]
    want = mmwhs.get_datasets(str(tmp_path / "d"), target_shape=(8, 8, 8))[2][0]
    save = np.save

    def cut_short(path, array):
        if "_lab" in str(path):
            with open(path, "wb") as f:
                f.write(b"\x93NUMPY")
            raise OSError("no space left on device")
        save(path, array)

    monkeypatch.setattr(np, "save", cut_short)
    with pytest.raises(OSError):
        ds[0]
    monkeypatch.undo()
    assert not [p for p in os.listdir(tmp_path / "c") if "_lab" in p]
    got = ds[0]
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["label"], want["label"])
