"""Predict's 2D and pseudo-3D engines on the CPU against the JAX package's.

The oracles of `tests/test_generic_unet_2d_engines.py` (a shift-equivariant
2D predictor tiled against its dense per-slice forward; mirror TTA over the
in-plane axes only; channel-major slice neighbourhoods; zero-padded volume
ends) held for the port's engines and against JAX's engines on the same
inputs, then `cli/predict --engine 2d` and `--engine p3d` end to end
against JAX's `cli/predict` from runs of one 2D GenericUNet's weights on a
synthetic root (kept under directories free of "ct" and "image", which the
JAX package's case paths rewrite).

Tolerances: engines 1e-5 (f32 blends in another order; 1e-4 under mirror
TTA, as the JAX test has it); the CLIs' softmax files 1e-3 (f16 storage),
label maps equal wherever JAX's top-2 margin exceeds 2e-3.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import itertools  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu import config as jcfg  # noqa: E402
from micformer_tpu.cli import predict as jpredict  # noqa: E402
from micformer_tpu.infer import sliding_window_2d as jsw2  # noqa: E402
from micformer_tpu.models import generic_unet as jg  # noqa: E402
from micformer_tpu.train.checkpoint import CheckpointManager as JCheckpoints  # noqa: E402
from micformer_tpu_torch import config as tcfg  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.cli import predict as tpredict  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.data.nifti import read_nifti  # noqa: E402
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from micformer_tpu_torch.infer import (  # noqa: E402
    sliding_window_inference_2d, sliding_window_inference_pseudo3d,
)
from micformer_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

from torch_port_oracle import flax_params  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vol(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _linear(xp, num_classes=4):
    """A shift-equivariant 2D 'network': each class a multiple of the
    channel mean ([b, C, H, W] -> [b, K, H, W]), in numpy's or torch's ops."""
    scales = np.arange(1.0, num_classes + 1.0, dtype=np.float32).reshape(1, -1, 1, 1)
    if xp is torch:
        return lambda x: x.mean(1, keepdim=True) * torch.from_numpy(scales)
    return lambda x: jnp.mean(x, axis=1, keepdims=True) * scales


def test_2d_engine_matches_dense_forward_and_jax():
    vol = _vol(0, (1, 2, 5, 24, 24))
    got = sliding_window_inference_2d(torch.from_numpy(vol), (16, 16), _linear(torch),
                                      num_classes=4, overlap=0.5, sw_batch_size=3)
    dense = np.stack([_linear(torch)(torch.from_numpy(vol[:, :, z])).numpy()
                      for z in range(5)], axis=2)
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=1e-5)
    want = jsw2.sliding_window_inference_2d(jnp.asarray(vol), (16, 16), _linear(jnp),
                                            num_classes=4, overlap=0.5, sw_batch_size=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_2d_engine_mirror_tta_flips_in_plane_only():
    def asym(xp):    # not flip-equivariant: depends on the raw W coordinate
        if xp is torch:
            return lambda x: torch.cumsum(x.mean(1, keepdim=True), dim=-1)
        return lambda x: jnp.cumsum(jnp.mean(x, 1, keepdims=True), axis=-1)

    vol = _vol(1, (1, 1, 3, 16, 16))
    got = sliding_window_inference_2d(torch.from_numpy(vol), (16, 16), asym(torch),
                                      num_classes=1, mirror_tta=True)
    t = torch.from_numpy(vol)
    acc = 0
    for sub in itertools.chain.from_iterable(itertools.combinations((3, 4), r)
                                             for r in range(3)):
        flipped = t.flip(sub) if sub else t
        y = torch.stack([asym(torch)(flipped[:, :, z]) for z in range(3)], dim=2)
        acc = acc + (y.flip(sub) if sub else y)
    np.testing.assert_allclose(got.numpy(), (acc / 4).numpy(), rtol=0, atol=1e-4)
    want = jsw2.sliding_window_inference_2d(jnp.asarray(vol), (16, 16), asym(jnp),
                                            num_classes=1, mirror_tta=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_pseudo3d_neighbourhoods_are_channel_major():
    """pseudo3d_slices 3 on two channels: six input channels, channel 0's
    three slices first, so channel 1 of the stack is channel 0's centre."""
    C = 2
    vol = _vol(2, (1, C, 6, 16, 16))

    def centre(x):
        assert x.shape[1] == C * 3
        return x[:, 1:2]

    got = sliding_window_inference_pseudo3d(torch.from_numpy(vol), (16, 16), centre,
                                            pseudo3d_slices=3, num_classes=1)
    np.testing.assert_allclose(got[:, 0].numpy(), vol[:, 0], rtol=0, atol=1e-5)
    want = jsw2.sliding_window_inference_pseudo3d(jnp.asarray(vol), (16, 16), centre,
                                                  pseudo3d_slices=3, num_classes=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_pseudo3d_zero_pads_the_volume_ends():
    vol = (np.arange(1, 5, dtype=np.float32).reshape(1, 1, 4, 1, 1)
           * np.ones((1, 1, 4, 8, 8), np.float32))
    got = sliding_window_inference_pseudo3d(torch.from_numpy(vol), (8, 8),
                                            lambda x: x[:, 0:1], pseudo3d_slices=3,
                                            num_classes=1)
    np.testing.assert_allclose(got[0, 0, :, 0, 0].numpy(), [0.0, 1.0, 2.0, 3.0], atol=1e-5)
    with pytest.raises(ValueError, match="odd"):
        sliding_window_inference_pseudo3d(torch.from_numpy(vol), (8, 8), lambda x: x,
                                          pseudo3d_slices=4)


# ---- cli/predict ---------------------------------------------------------------

UNET2D = dict(base_num_features=4, pool_kernels=[[2, 2], [2, 2]], conv_kernels=[[3, 3]] * 3)
GRID = ["--target-shape", "16", "--roi", "12", "--sw-batch-size", "4", "--save-softmax"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """15 synthetic cases, so the 5-fold split's test fold holds two."""
    root = str(tmp_path_factory.mktemp("engines2d_root"))
    write_synthetic_dataset(root, n_cases=15, shape=(14, 18, 16), seed=6)
    return root


def _runs(base, in_channels):
    """A JAX run dir and a port run dir of one 2D GenericUNet's weights."""
    jm = jg.GenericUNet(num_classes=8, **{k: tuple(map(tuple, v)) for k, v in UNET2D.items()
                                          if k != "base_num_features"},
                        base_num_features=4, max_features=512)
    params = flax_params(jm, np.zeros((1, in_channels, 12, 12), np.float32), seed=in_channels)
    jdir, tdir = str(base / "jax"), str(base / "port")
    JCheckpoints(jdir).save("best_dice", {"params": params})
    cfg = jcfg.Config()
    cfg.model.name = "generic_unet"
    cfg.model.extra = dict(UNET2D, max_features=512)
    jcfg.save_config(cfg, os.path.join(jdir, "config.yaml"))
    cfg = tcfg.Config()
    cfg.model.name = "generic_unet"
    cfg.model.extra = dict(UNET2D, max_features=512, in_channels=in_channels)
    tcfg.save_config(cfg, os.path.join(tdir, "config.json"))
    model = treg.build("generic_unet", device="cpu", num_classes=8, max_features=512,
                       in_channels=in_channels, **UNET2D)
    CheckpointManager(tdir).save("best_dice", {"params": state_dict_from_flax(params, model),
                                               "step": 1})
    return jdir, tdir


@pytest.mark.parametrize("engine", [["--engine", "2d", "--mirror-tta"],
                                    ["--engine", "p3d", "--pseudo3d-slices", "3"]],
                         ids=["2d", "p3d"])
def test_cli_engines_match_jax(root, tmp_path_factory, engine):
    base = tmp_path_factory.mktemp("engines2d_runs")
    jdir, tdir = _runs(base, 2 * 3 if "p3d" in engine else 2)
    outs = {}
    for side, main, run in (("jax", jpredict.main, jdir), ("port", tpredict.main, tdir)):
        out = str(base / f"out_{side}")
        main(["--data", root, "--cache", os.path.join(root, f"cache_{side}"), "--run-dirs",
              run, "--out", out, *GRID, *engine] + (["--device", "cpu"] if side == "port"
                                                   else []))
        outs[side] = out
    pids = sorted(f[: -len("_pred.nii.gz")] for f in os.listdir(outs["jax"])
                  if f.endswith("_pred.nii.gz"))
    assert len(pids) == 2 and sorted(os.listdir(outs["port"])) == sorted(os.listdir(outs["jax"]))
    for pid in pids:
        jsm, tsm = (np.load(os.path.join(outs[s], f"{pid}_softmax.npz"))["softmax"]
                    .astype(np.float32) for s in ("jax", "port"))
        assert tsm.shape == jsm.shape == (8, 16, 16, 16)
        np.testing.assert_allclose(tsm, jsm, rtol=0, atol=1e-3)
        top2 = np.sort(jsm, axis=0)[-2:]
        sure = top2[1] - top2[0] > 2e-3
        assert sure.mean() > 0.25
        np.testing.assert_array_equal(
            read_nifti(os.path.join(outs["port"], f"{pid}_pred.nii.gz"))[sure],
            read_nifti(os.path.join(outs["jax"], f"{pid}_pred.nii.gz"))[sure])
