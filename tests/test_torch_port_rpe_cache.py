"""The inference rel-pos cache of the port (`models/layers.materialize_rpe_cache`,
`rel_pos_bias_cached`) against the JAX package's (`rpe_cache` collection).

At module level the cached [h, T, T] bias equals the one JAX's
`materialize_rpe_cache` stores, exactly: WindowAttention3D's, and VT-UNet's
`index[:T, :T]` quirk at a window clamped from 7³. At model level the port's
cached forward is held against its own uncached forward (JAX's cached model
forwards compile for minutes on the CPU): SwinUNETR, VT-UNet and nnFormer at
`tests/test_rpe_cache.py`'s widths and 32³, within 1e-6, with no table
gather. The cache is a no-op for `unet_conv`; a forward with grad enabled
gathers and trains the tables; loading weights (or writing a table in place)
leaves no stale bias; cli/predict's label maps (3d engine, --sharded-tiles at
one process) are the same with and without it.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu.models import layers as jl  # noqa: E402
from micformer_tpu.models import vtunet as jvt  # noqa: E402
from micformer_tpu_torch import config as tcfg  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.cli import predict as tpredict  # noqa: E402
from micformer_tpu_torch.data.nifti import read_nifti  # noqa: E402
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from micformer_tpu_torch.models import layers as tl  # noqa: E402
from micformer_tpu_torch.models.vtunet import VTWindowAttention  # noqa: E402
from micformer_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _counts():
    return dict(tl.RPE_COUNTS)


def _since(before):
    return {k: tl.RPE_COUNTS[k] - before[k] for k in before}


def _biased(model):
    return [m for m in model.modules() if getattr(m, "rel_pos_bias_table", None) is not None]


# (JAX module, its call's keyword arguments, the port's module, its call's
# keyword arguments, input [N, T, C]): WindowAttention3D over 2³ windows, and
# VT-UNet's attention built for 7³ called on windows of 8 tokens (the quirk)
MODULES = {
    "window_attention": (lambda: jl.WindowAttention3D(dim=4, window_size=(2, 2, 2), num_heads=2,
                                                      rel_pos_bias=True), {},
                         lambda: tl.WindowAttention3D(4, 2, window_size=(2, 2, 2),
                                                      rel_pos_bias=True),
                         {"window": (2, 2, 2)}, (3, 8, 4)),
    "vtunet_quirk": (lambda: jvt.VTWindowAttention(dim=12, window_size=(2, 2, 2), num_heads=3,
                                                   table_window=(7, 7, 7)), {},
                     lambda: VTWindowAttention(12, 3, (7, 7, 7)), {}, (2, 8, 12)),
}


@pytest.mark.parametrize("case", sorted(MODULES))
def test_cached_bias_equals_jax_module_level(case):
    """The bias the port's cache holds is JAX's `rpe_cache` bias on the same
    table, exactly, and the cached forward equals the uncached one."""
    jmake, jkw, tmake, tkw, shape = MODULES[case]
    x = _arr(0, shape)
    jm = jmake()
    variables = jm.init(jax.random.key(0), jnp.asarray(x), **jkw)
    table = _arr(1, variables["params"]["rel_pos_bias_table"].shape)
    variables = {"params": dict(variables["params"], rel_pos_bias_table=jnp.asarray(table))}
    cached = jl.materialize_rpe_cache(jm, variables, jnp.asarray(x), **jkw)
    (want,) = jax.tree.leaves(cached["rpe_cache"])

    tm = tmake().eval()
    tm.rel_pos_bias_table.data = torch.from_numpy(table)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ref = tm(xt, **tkw)
    assert tl.materialize_rpe_cache(tm, xt, **tkw) is tm
    assert tm.rpe_cache.shape == want.shape
    np.testing.assert_array_equal(tm.rpe_cache.numpy(), np.asarray(want))
    before = _counts()
    with torch.no_grad():
        got = tm(xt, **tkw)
    assert _since(before) == {"gathered": 0, "cached": 1}
    got, ref = (g[0] if isinstance(g, tuple) else g for g in (got, ref))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


# (registry name, build kwargs, input shape): tests/test_rpe_cache.py's
BIASED = {
    "swinunetr": (dict(feature_size=4, num_heads=(1, 2, 4, 8), window_size=(2, 2, 2)),
                  (1, 2, 32, 32, 32)),
    "vtunet": (dict(embed_dim=12, num_heads=(1, 2, 3, 4), window_size=(2, 2, 2)),
               (1, 2, 32, 32, 32)),
    "nnformer": (dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), in_channels=1,
                      input_size=32), (1, 1, 32, 32, 32)),
}


def _model(name, seed=0):
    kw, _ = BIASED[name]
    return treg.build(name, device="cpu", num_classes=3,
                      generator=torch.Generator().manual_seed(seed), **kw)


@pytest.mark.parametrize("name", sorted(BIASED))
def test_cached_forward_equals_uncached(name):
    """Every biased block reads its cache: the forward gathers no table and
    equals the uncached forward within 1e-6; the state_dict holds no cache."""
    model = _model(name)
    x = torch.from_numpy(_arr(2, BIASED[name][1]))
    n = len(_biased(model))
    keys = set(model.state_dict())
    before = _counts()
    with torch.no_grad():
        want = model(x)
    assert _since(before) == {"gathered": n, "cached": 0}
    tl.materialize_rpe_cache(model, x)
    assert all(m.rpe_cache is not None for m in _biased(model))
    assert set(model.state_dict()) == keys
    before = _counts()
    with torch.inference_mode():
        got = model(x)
    assert _since(before) == {"gathered": 0, "cached": n}
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_noop_for_unbiased_model():
    model = treg.build("unet_conv", device="cpu", num_classes=3,
                       generator=torch.Generator().manual_seed(0))
    keys = set(model.state_dict())
    before = _counts()
    assert tl.materialize_rpe_cache(model, torch.zeros(1, 2, 16, 16, 16)) is model
    assert _since(before) == {"gathered": 0, "cached": 0}
    assert not any(getattr(m, "rpe_cache", None) is not None for m in model.modules())
    assert set(model.state_dict()) == keys


def test_grad_enabled_forward_never_reads_the_cache():
    """After materializing, a forward with grad enabled gathers every table
    and gives each a nonzero gradient; the cache stays for no_grad.
    (SwinUNETR: every window of it holds 8 tokens at 32³; a table whose
    window clamps to one token gets no gradient, cache or no cache.)"""
    model = _model("swinunetr")
    x = torch.from_numpy(_arr(3, BIASED["swinunetr"][1]))
    tl.materialize_rpe_cache(model, x)
    n = len(_biased(model))
    before = _counts()
    model(x).square().mean().backward()
    assert _since(before) == {"gathered": n, "cached": 0}
    for m in _biased(model):
        assert m.rel_pos_bias_table.grad is not None
        assert m.rel_pos_bias_table.grad.abs().sum() > 0
        assert m.rpe_cache is not None


@pytest.mark.parametrize("change", ["load_state_dict", "in_place"])
def test_cache_never_serves_stale_weights(change):
    """load_state_dict of other weights empties every cache; weights written
    in place (an optimizer's step) leave the cache, which is then not read
    (its key holds the table's version): the forward is the new weights'."""
    model, other = _model("nnformer"), _model("nnformer", seed=1)
    x = torch.from_numpy(_arr(4, BIASED["nnformer"][1]))
    tl.materialize_rpe_cache(model, x)
    if change == "load_state_dict":
        model.load_state_dict(other.state_dict())
        assert all(m.rpe_cache is None for m in _biased(model))
    else:
        with torch.no_grad():
            for mine, theirs in zip(model.parameters(), other.parameters()):
                mine.copy_(theirs)
        assert all(m.rpe_cache is not None for m in _biased(model))
    before = _counts()
    with torch.no_grad():
        got = model(x)
    assert _since(before) == {"gathered": len(_biased(model)), "cached": 0}
    with torch.no_grad():
        want = other(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---- cli/predict ----------------------------------------------------------------

NNFORMER = dict(embed_dim=8, depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8], input_size=32)


@pytest.fixture(scope="module")
def nnformer_run(tmp_path_factory):
    """A synthetic MM-WHS root (its test split: one case) and a port run dir
    of a tiny nnFormer built for 32³."""
    root = tmp_path_factory.mktemp("rpe")
    data = str(root / "mmwhs")
    write_synthetic_dataset(data, n_cases=6, shape=(20, 20, 20), seed=3)
    run = str(root / "run")
    cfg = tcfg.Config()
    cfg.model.name = "nnformer"
    cfg.model.extra = dict(NNFORMER)
    tcfg.save_config(cfg, os.path.join(run, "config.json"))
    model = treg.build("nnformer", device="cpu", num_classes=8,
                       generator=torch.Generator().manual_seed(6),
                       **{k: tuple(v) if isinstance(v, list) else v for k, v in NNFORMER.items()})
    CheckpointManager(run).save("best_dice", {"params": model.state_dict(), "step": 1})
    return data, run


@pytest.mark.parametrize("engine", [[], ["--sharded-tiles"]], ids=["3d", "sharded-tiles"])
def test_cli_predict_label_maps_unchanged_by_the_cache(nnformer_run, tmp_path, monkeypatch,
                                                       engine):
    """cli/predict with the cache (each fold's 7 biases gathered once, then
    read by every forward) and with materialize_rpe_cache made a no-op (the
    7 gathered by every forward): the same label maps and softmax files."""
    data, run = nnformer_run
    args = ["--data", data, "--cache", os.path.join(data, "cache"), "--run-dirs", run,
            "--device", "cpu", "--target-shape", "32", "--roi", "32", "--save-softmax",
            *engine]
    before = _counts()
    tpredict.main(args + ["--out", str(tmp_path / "cached")])
    cached = _since(before)
    monkeypatch.setattr(tl, "materialize_rpe_cache", lambda model, *a, **k: model)
    before = _counts()
    tpredict.main(args + ["--out", str(tmp_path / "gathered")])
    gathered = _since(before)
    # one case, one tile: the materializing forward, then the case's forward
    assert cached == {"gathered": 7, "cached": 7}
    assert gathered == {"gathered": 7, "cached": 0}
    pids = [f[: -len("_pred.nii.gz")] for f in os.listdir(tmp_path / "cached")
            if f.endswith("_pred.nii.gz")]
    assert len(pids) == 1
    for pid in pids:
        np.testing.assert_array_equal(
            read_nifti(str(tmp_path / "cached" / f"{pid}_pred.nii.gz")),
            read_nifti(str(tmp_path / "gathered" / f"{pid}_pred.nii.gz")))
        np.testing.assert_array_equal(
            np.load(tmp_path / "cached" / f"{pid}_softmax.npz")["softmax"],
            np.load(tmp_path / "gathered" / f"{pid}_softmax.npz")["softmax"])
