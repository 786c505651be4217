"""The port's ops (attention, warp, windows) against the JAX package on the CPU.

Inputs come from numpy with a seed; both sides get the same arrays, in f32.
The JAX package reads its MICFORMER_* flags at import; they are cleared
here first, so it runs its default forms.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from micformer_tpu.ops import attention as jattn  # noqa: E402
from micformer_tpu.ops import warp as jwarp  # noqa: E402
from micformer_tpu.ops import windows as jwin  # noqa: E402
from micformer_tpu_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from micformer_tpu_torch.kernels.window_attention import (  # noqa: E402
    window_attention, window_attention_reference,
)
from micformer_tpu_torch.ops import attention as tattn  # noqa: E402
from micformer_tpu_torch.ops import warp as twarp  # noqa: E402
from micformer_tpu_torch.ops import windows as twin  # noqa: E402


def _qkv(seed, N, Tq, Tk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, Tq, h, d)).astype(np.float32)
    k = rng.normal(size=(N, Tk, h, d)).astype(np.float32)
    v = rng.normal(size=(N, Tk, h, d)).astype(np.float32)
    return q, k, v


# (1030, 8, 3, 16) has N >= 1024 and reaches the JAX lane-major path
@pytest.mark.parametrize("N,T,h,d", [(20, 8, 3, 16), (300, 8, 2, 8),
                                     (7, 4, 1, 16), (1030, 8, 3, 16)])
def test_attention_matches_jax(N, T, h, d):
    q, k, v = _qkv(N, N, T, T, h, d)
    ref = np.asarray(jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v)))
    reset_launches()
    got = tattn.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    assert LAUNCHES["window_attention"] == 0  # CPU tensors never launch


def test_attention_cross_lengths_and_scale_match_jax():
    q, k, v = _qkv(1, 50, 4, 8, 2, 16)
    ref = np.asarray(jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v), scale=0.3))
    got = tattn.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), scale=0.3)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_attention_matches_pallas_v2_interpret():
    from micformer_tpu.ops.pallas.window_attention_v2 import window_attention_v2

    q, k, v = _qkv(2, 6, 8, 8, 2, 16)
    ref = np.asarray(window_attention_v2(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), None, True))
    got = window_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_attention_rejects_bias_mask_and_bad_shapes():
    q, k, v = (torch.zeros(2, 8, 3, 16) for _ in range(3))
    with pytest.raises(NotImplementedError):
        tattn.multi_head_attention(q, k, v, bias=torch.zeros(3, 8, 8))
    with pytest.raises(NotImplementedError):
        tattn.multi_head_attention(q, k, v, mask=torch.zeros(1, 8, 8))
    with pytest.raises(ValueError):
        window_attention(q, k[:, :, :2], v)
    with pytest.raises(ValueError):
        window_attention(q, k.double(), v)


def test_reference_keeps_bf16_and_computes_in_f32():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 5, 8, 8, 2, 16))
    out = window_attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    f32 = window_attention_reference(q.bfloat16().float(), k.bfloat16().float(),
                                     v.bfloat16().float())
    assert torch.equal(out, f32.bfloat16())


def test_split_merge_heads_are_reshapes():
    x = np.random.default_rng(4).normal(size=(5, 8, 12)).astype(np.float32)
    js = np.asarray(jattn.split_heads(jnp.asarray(x), 3))
    ts = tattn.split_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tattn.merge_heads(ts).numpy(), x)


def test_window_partition_reverse_match_jax():
    x = np.random.default_rng(5).normal(size=(2, 4, 6, 2, 3)).astype(np.float32)
    ws = (2, 2, 2)
    jw = np.asarray(jwin.window_partition(jnp.asarray(x), ws))
    tw = twin.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(
        twin.window_reverse(tw, ws, 2, 4, 6, 2).numpy(), x)
    for size, win, shift in [((1, 4, 8), (2, 2, 2), (1, 1, 1)),
                             ((8, 8, 8), (4, 4, 4), None)]:
        assert (twin.adjust_window_shift(size, win, shift)
                == jwin.adjust_window_shift(size, win, shift))


# coords reach below 0 and past the far edge, and one case has a size-1 axis
@pytest.mark.parametrize("shape", [(2, 6, 5, 7, 3), (1, 1, 6, 5, 4)])
def test_trilinear_sample_matches_jax(shape):
    rng = np.random.default_rng(6)
    B, D, H, W, C = shape
    src = rng.normal(size=shape).astype(np.float32)
    lim = np.array([D, H, W], np.float32).reshape(1, 3, 1, 1, 1)
    coords = (rng.uniform(-1.5, 1.2, size=(B, 3, 4, 3, 5)) * lim).astype(np.float32)
    ref = np.asarray(jwarp.trilinear_sample(jnp.asarray(src), jnp.asarray(coords)))
    got = twarp.trilinear_sample(torch.from_numpy(src), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 6, 8, 4, 5), (1, 8, 1, 6, 3)])
def test_stn_warp_matches_jax(shape):
    rng = np.random.default_rng(7)
    B, D, H, W, C = shape
    src = rng.normal(size=shape).astype(np.float32)
    flow = rng.normal(scale=2.5, size=(B, 3, D, H, W)).astype(np.float32)
    ref = np.asarray(jwarp.stn_warp(jnp.asarray(src), jnp.asarray(flow)))
    got = twarp.stn_warp(torch.from_numpy(src), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("faithful", [True, False])
def test_reference_points_match_jax(faithful):
    ref = np.asarray(jwarp.reference_points(4, 6, 8, faithful=faithful))
    got = twarp.reference_points(4, 6, 8, faithful=faithful)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
