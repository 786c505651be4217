"""GenericUNet and the spatial engine on the CPU: the port's GenericUNet
against the JAX one on the same weights (f32; isotropic and anisotropic
schedules, deep supervision on and off, 2D); `build_from_plan`; the
halo exchange at W = 4 with the JAX test's expectations
(`tests/test_spatial_parallel.py`); one spatial forward slabbed over 4 and
2 gloo ranks against the single forward, for both of that test's
schedules (and against the JAX GenericUNet's forward), and its refusal of
a misaligned depth; `cli/predict --engine spatial` over two ranks against
one process.

Tolerances: 1e-5 against JAX (f32 sums in another order); the spatial
forward 2e-4 against the single one (the JAX test's); the CLIs' softmax
files 1e-3 (f16). The ranks are spawned processes that import no JAX
(`torch_port_ranks`).
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from micformer_tpu.models import generic_unet as jg  # noqa: E402
from micformer_tpu_torch import config as tcfg  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.cli import predict as tpredict  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.data.nifti import read_nifti  # noqa: E402
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from micformer_tpu_torch.models import generic_unet as tg  # noqa: E402
from micformer_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

import torch_port_ranks as ranks  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_params(model, x, seed=0):
    """Weights drawn with numpy into the tree `init` makes (nothing compiled)."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for key, sd in flatten_dict(shapes).items():
        z = rng.normal(size=sd.shape).astype(np.float32)
        flat[key] = (z / np.sqrt(np.prod(sd.shape[:-1])) if key[-1] == "kernel"
                     else 0.1 * z + (1.0 if key[-1] == "scale" else 0.0))
    return unflatten_dict(flat)


@pytest.mark.parametrize("case", [
    ("isotropic", False, (1, 2, 32, 16, 16)), ("anisotropic", True, (2, 2, 16, 16, 16)),
    ("2d", True, (2, 3, 32, 24)), ("2d_plan", False, (1, 1, 16, 32))],
    ids=["isotropic", "anisotropic_ds", "2d_ds", "2d_plan"])
def test_generic_unet_matches_jax(case):
    name, ds, shape = case
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    if name.startswith("2d"):
        pools, convs = ((2, 2), (2, 2)), ((3, 3),) * 3
    else:
        pools, convs = ranks.SCHEDULES[name]
    if name == "2d_plan":
        plan = {"pool_op_kernel_sizes": [[2, 2], [1, 2]],
                "conv_kernel_sizes": [[3, 3], [3, 3], [1, 3]], "base_num_features": 4,
                "classes": [1, 2]}
        jm = jg.build_from_plan(plan)
        tm = treg.build("generic_unet", device="cpu", plan=plan, num_classes=None,
                        in_channels=shape[1])
        assert (tm.pool_kernels, tm.conv_kernels) == ([(2, 2), (1, 2)],
                                                      [(3, 3), (3, 3), (1, 3)])
        assert tm.seg0.out_channels == 2 and tm.enc2_conv0.conv.out_channels == 16
    else:
        kw = dict(num_classes=3, base_num_features=4, pool_kernels=pools, conv_kernels=convs,
                  deep_supervision=ds, max_features=320 if len(convs[0]) == 3 else 512)
        jm = jg.GenericUNet(**kw)
        tm = treg.build("generic_unet", device="cpu", in_channels=shape[1], **kw)
    params = _flax_params(jm, x)
    tm.load_state_dict(state_dict_from_flax(params, tm))
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    if not ds:
        want, got = [want], [got]
    assert len(got) == len(want) == (len(pools) if ds else 1)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_same_pads_are_flax_same():
    assert tg.same_pads(32, 3, 2) == (0, 1) and tg.same_pads(32, 3, 1) == (1, 1)
    assert tg.same_pads(31, 3, 2) == (1, 1) and tg.same_pads(8, 1, 1) == (0, 0)


@pytest.fixture(scope="module")
def schedules():
    """Per schedule of tests/test_spatial_parallel.py: (the port's weights,
    the JAX GenericUNet's logits) of the same drawn weights."""
    x = ranks.spatial_input()
    out = {}
    for name, (pools, convs) in ranks.SCHEDULES.items():
        jm = jg.GenericUNet(num_classes=3, base_num_features=4, pool_kernels=pools,
                            conv_kernels=convs)
        params = _flax_params(jm, x, seed=7)
        state = state_dict_from_flax(params, ranks.small_unet(name))
        out[name] = (state, np.asarray(jm.apply({"params": params}, jnp.asarray(x))))
    return out


@pytest.fixture(scope="module", params=[4, 2], ids=["W4", "W2"])
def spawned(request, tmp_path_factory, schedules):
    world = request.param
    torch.set_num_threads(1)
    states = {k: v[0] for k, v in schedules.items()}
    return world, ranks.run_ranks(world, tmp_path_factory.mktemp(f"spatial{world}"),
                                  ranks.spatial_worker, states=states)


def test_halo_exchange_neighbours_and_edges(spawned):
    world, out = spawned
    halos = [r["halo"] for r in out]
    if world == 4:       # tests/test_spatial_parallel.py's expectations
        assert halos[0] == [0.0, 0.0, 1.0, 2.0]
        assert halos[1] == [1.0, 2.0, 3.0, 4.0]
        assert halos[3] == [5.0, 6.0, 7.0, 0.0]
    else:
        assert halos == [[0.0, 0.0, 1.0, 2.0, 3.0, 4.0], [3.0, 4.0, 5.0, 6.0, 7.0, 0.0]]


@pytest.mark.parametrize("schedule", list(ranks.SCHEDULES))
def test_spatial_forward_matches_the_single_forward(spawned, schedules, schedule):
    """Against the port's single forward and the JAX GenericUNet's."""
    _, out = spawned
    state, jax_out = schedules[schedule]
    with torch.no_grad():
        want = ranks.small_unet(schedule, state)(torch.from_numpy(ranks.spatial_input()))
    for r in out:
        got = r[schedule]
        assert got.shape == want.shape == (1, 3, 32, 16, 16)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-4, atol=2e-4)


def test_spatial_rejects_a_misaligned_depth(spawned):
    world, out = spawned
    for r in out:         # 24 % (4 x 4) != 0 at W = 4; at W = 2 24 % 8 == 0
        if world == 4:
            assert r["misaligned"] == "D=24 must divide shards(4) x cumulative z-stride(4)"
        else:
            assert r["misaligned"] is None


def test_cli_predict_engine_spatial_over_two_ranks_matches_one_process(tmp_path):
    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_cases=15, shape=(20, 24, 28), seed=4)
    run = str(tmp_path / "run")
    kw = dict(base_num_features=4, pool_kernels=[[2, 2, 2]] * 2,
              conv_kernels=[[3, 3, 3]] * 3, in_channels=2)
    cfg = tcfg.Config()
    cfg.model.name = "generic_unet"
    cfg.model.extra = kw
    tcfg.save_config(cfg, os.path.join(run, "config.json"))
    model = treg.build("generic_unet", device="cpu", generator=torch.Generator().manual_seed(3),
                       **kw)
    CheckpointManager(run).save("best_dice", {"params": model.state_dict(), "step": 1})
    base = ["--data", data, "--cache", str(tmp_path / "cache"), "--run-dirs", run,
            "--device", "cpu", "--target-shape", "32", "--engine", "spatial", "--save-softmax"]
    single = str(tmp_path / "single")
    tpredict.main(base + ["--out", single])
    out = ranks.run_ranks(2, tmp_path / "ranks", ranks.predict_worker,
                          argv=base + ["--out", str(tmp_path / "two"), "--spatial-shards", "2"])
    assert [len(r) for r in out] == [2, 2]
    files = sorted(os.listdir(single))
    assert files == sorted(os.listdir(tmp_path / "two")) and len(files) == 4
    for f in files:
        if f.endswith(".npz"):
            a = np.load(os.path.join(single, f))["softmax"].astype(np.float32)
            b = np.load(os.path.join(tmp_path / "two", f))["softmax"].astype(np.float32)
            np.testing.assert_allclose(b, a, atol=1e-3)
            sure = np.diff(np.sort(a, axis=0)[-2:], axis=0)[0] > 2e-3
            pid = f[: -len("_softmax.npz")]
            np.testing.assert_array_equal(
                read_nifti(os.path.join(tmp_path / "two", f"{pid}_pred.nii.gz"))[sure],
                read_nifti(os.path.join(single, f"{pid}_pred.nii.gz"))[sure])
