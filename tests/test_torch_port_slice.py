"""The port's serving slice against the JAX package on the CPU: MicFormer on
converted weights, alone and under sliding-window inference, plus the
sliding-window machinery with a cheap predictor.

The JAX package's MICFORMER_* flags are cleared before it is imported, so it
runs its default forms (fused head, lane-major attention and offset tail).
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu.infer import sliding_window as jsw  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.infer import sliding_window as tsw  # noqa: E402

TINY = dict(num_classes=8, embed_dim=12, depths=(1, 1), num_heads=(3, 6))


def _arr(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(kw, init_shape):
    """JAX MicFormer (apply fn, jitted) and the port's model on its weights."""
    jmodel = jreg.build("micformer", **kw)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros(init_shape))
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel = treg.build("micformer", device="cpu", **kw)
    tmodel.load_state_dict(state_dict_from_flax(params, tmodel))
    apply = jax.jit(lambda v: jmodel.apply(variables, v))
    return apply, tmodel


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair(TINY, (1, 2, 32, 32, 32))


def test_micformer_matches_jax(tiny_pair):
    apply, tmodel = tiny_pair
    x = _arr(0, (1, 2, 32, 32, 32))
    ref = np.asarray(apply(jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, 8, 32, 32, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("step_mode", ["monai", "nnunet"])
def test_micformer_sliding_window_matches_jax(tiny_pair, step_mode):
    apply, tmodel = tiny_pair
    vol = _arr(1, (1, 2, 40, 40, 40))
    kw = dict(num_classes=8, sw_batch_size=2, blend="gaussian", step_mode=step_mode)
    ref = np.asarray(jax.jit(lambda v: jsw.sliding_window_inference(
        v, (32,) * 3, apply, **kw))(jnp.asarray(vol)))
    got = tsw.sliding_window_inference(torch.from_numpy(vol), (32,) * 3, tmodel, **kw)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def _ramp_predictors(C, K, roi):
    """A cheap predictor that is not flip-symmetric: a channel mix scaled by a
    ramp along each spatial axis. Returns (jax fn, torch fn)."""
    m = _arr(2, (K, C))
    ramp = (1.0 + np.arange(roi[0])[:, None, None] / roi[0]
            + 2.0 * np.arange(roi[1])[None, :, None] / roi[1]
            + 3.0 * np.arange(roi[2])[None, None, :] / roi[2]).astype(np.float32)

    def jfn(x):
        return jnp.einsum("bcdhw,kc->bkdhw", x, jnp.asarray(m)) * jnp.asarray(ramp)

    def tfn(x):
        return torch.einsum("bcdhw,kc->bkdhw", x, torch.from_numpy(m)) * torch.from_numpy(ramp)

    return jfn, tfn


@pytest.mark.parametrize("case", [
    dict(shape=(2, 2, 20, 17, 23), roi=(8, 8, 8), step_mode="monai", blend="gaussian",
         sw_batch_size=3, mirror_tta=False),
    dict(shape=(1, 2, 12, 20, 9), roi=(8, 8, 8), step_mode="nnunet", blend="constant",
         sw_batch_size=2, mirror_tta=True),
    # smaller than the roi on two axes: zero padding, then cropped back
    dict(shape=(1, 2, 5, 12, 6), roi=(8, 8, 8), step_mode="monai", blend="gaussian",
         sw_batch_size=4, mirror_tta=True),
])
def test_sliding_window_machinery_matches_jax(case):
    case = dict(case)
    shape, roi = case.pop("shape"), case.pop("roi")
    jfn, tfn = _ramp_predictors(shape[1], 3, roi)
    vol = _arr(3, shape)
    kw = dict(num_classes=3, overlap=0.5, **case)
    ref = np.asarray(jsw.sliding_window_inference(jnp.asarray(vol), roi, jfn,
                                                  tta_batched=False, **kw))
    got = tsw.sliding_window_inference(torch.from_numpy(vol), roi, tfn, **kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_tile_placement_and_gaussian_match_jax():
    for img, roi in [((160, 160, 160), (128, 128, 128)), ((40, 57, 33), (32, 16, 33)),
                     ((9, 100, 17), (8, 32, 5))]:
        for ov in (0.25, 0.5, 0.75):
            assert tsw.compute_steps_monai(img, roi, ov) == jsw.compute_steps_monai(img, roi, ov)
            assert (tsw.compute_steps_nnunet(img, roi, ov)
                    == jsw.compute_steps_nnunet(img, roi, ov))
    for roi in [(32, 32, 32), (8, 16, 5)]:
        np.testing.assert_array_equal(tsw.gaussian_importance_map(roi),
                                      jsw.gaussian_importance_map(roi))


@pytest.mark.slow
def test_micformer_full_depth_matches_jax():
    """embed 24, depths 2-2-6-2, 1×2×64³ (the transplant level of
    docs/PARITY.md); minutes of JAX on the CPU."""
    kw = dict(num_classes=8, embed_dim=24)
    apply, tmodel = _pair(kw, (1, 2, 64, 64, 64))
    x = _arr(4, (1, 2, 64, 64, 64))
    ref = np.asarray(apply(jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)
