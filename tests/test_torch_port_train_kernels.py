"""The training slice's kernels and gradients against the JAX package on the
CPU: K1's backward, K2 forward and backward, the fused-attention dispatch,
the STN warp's gradients, and the model's train-mode options.

Inputs come from numpy with a seed; both sides get the same arrays in f32.
The Pallas functions run in interpret mode, as the JAX package's own tests
run them. The JAX package reads its MICFORMER_* flags at import; they are
cleared here first, so it runs its default forms.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu.ops import warp as jwarp  # noqa: E402
from micformer_tpu.ops.pallas import window_attention as jfused  # noqa: E402
from micformer_tpu.ops.pallas.window_attention_v2 import window_attention_v2  # noqa: E402
from micformer_tpu_torch import registry  # noqa: E402
from micformer_tpu_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from micformer_tpu_torch.kernels.dw_conv3 import dw_conv3  # noqa: E402
from micformer_tpu_torch.kernels.fused_window_attention import (  # noqa: E402
    fused_window_attention, fused_window_attention_backward,
    fused_window_attention_backward_reference, fused_window_attention_reference,
    should_use_fused,
)
from micformer_tpu_torch.kernels.window_attention import (  # noqa: E402
    window_attention, window_attention_backward, window_attention_backward_reference,
)
from micformer_tpu_torch.ops import attention as tattn  # noqa: E402
from micformer_tpu_torch.ops import warp as twarp  # noqa: E402

# f32 on both sides; the gradients are sums of at most 32·128 products of
# unit-scale terms in another order than JAX's einsums
FWD_ATOL = 2e-5
GRAD_TOL = dict(rtol=1e-5, atol=5e-5)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _jax_grads(fn, q, k, v, g):
    """jax.grad of <fn(q, k, v), g> with respect to q, k, v, as numpy."""
    grads = jax.grad(lambda a, b, c: jnp.vdot(fn(a, b, c), jnp.asarray(g)),
                     argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in grads]


def _views(q, k, v, layout):
    """The port's q, k, v [N, T, h, d]: dense, or sliced as the model slices
    them (self: thirds of one fused qkv row; cross: q dense, k and v halves
    of one fused kv row)."""
    N, T, h, d = q.shape
    q, k, v = (torch.from_numpy(a).reshape(N, T, h * d) for a in (q, k, v))
    if layout == "self":
        parts = torch.cat([q, k, v], dim=-1).chunk(3, dim=-1)
    else:
        parts = (q,) + torch.cat([k, v], dim=-1).chunk(2, dim=-1)
    return tuple(t.view(N, T, h, d) for t in parts)


# the shapes of tests/test_pallas_attention.py's K1 tests, plus a window
# count that is not a multiple of the TPU kernel's 512-window block
@pytest.mark.parametrize("N,T,h,d", [(20, 8, 3, 16), (300, 8, 2, 8), (7, 4, 1, 16),
                                     (515, 8, 3, 16)])
@pytest.mark.parametrize("layout", ["self", "cross"])
def test_window_attention_backward_matches_jax(N, T, h, d, layout):
    q, k, v, g = _arrays(N + d, *[(N, T, h, d)] * 4)
    ref = _jax_grads(lambda a, b, c: window_attention_v2(a, b, c, None, True), q, k, v, g)
    tq, tk, tv = _views(q, k, v, layout)
    gt = torch.from_numpy(g)
    plain = window_attention_backward(tq, tk, tv, gt)
    for got, want in zip(plain, ref):
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = window_attention(*leaves)
    out.backward(gt)
    for leaf, want in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), want, **GRAD_TOL)


def test_window_attention_backward_reference_keeps_dtype_and_scale():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(1, *[(6, 8, 2, 16)] * 4))
    ref = _jax_grads(lambda a, b, c: window_attention_v2(a, b, c, 0.3, True),
                     q.numpy(), k.numpy(), v.numpy(), g.numpy())
    for got, want in zip(window_attention_backward_reference(q, k, v, g, 0.3), ref):
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
    out = window_attention_backward_reference(*(t.bfloat16() for t in (q, k, v, g)))
    assert all(t.dtype == torch.bfloat16 for t in out)


# tests/test_pallas_attention.py's K2 shapes, then T 16 and 32, d 128, and
# pair counts N·h that are not multiples of the TPU tile's G = 128 / T
@pytest.mark.parametrize("N,h,T,d", [(20, 3, 8, 16), (7, 2, 8, 16), (5, 1, 4, 8),
                                     (9, 3, 16, 16), (5, 2, 32, 128), (3, 1, 32, 24)])
def test_fused_window_attention_matches_jax(N, h, T, d):
    q, k, v, g = _arrays(N * T + d, *[(N, h, T, d)] * 4)
    want = np.asarray(jfused.fused_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, True))
    ref = _jax_grads(lambda a, b, c: jfused.fused_window_attention(a, b, c, None, True),
                     q, k, v, g)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    np.testing.assert_allclose(fused_window_attention_reference(tq, tk, tv).numpy(), want,
                               atol=FWD_ATOL)
    for got, r in zip(fused_window_attention_backward_reference(tq, tk, tv, tg), ref):
        np.testing.assert_allclose(got.numpy(), r, **GRAD_TOL)
    for got, r in zip(fused_window_attention_backward(tq, tk, tv, tg), ref):
        np.testing.assert_allclose(got.numpy(), r, **GRAD_TOL)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fused_window_attention(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=FWD_ATOL)
    out.backward(tg)
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r, **GRAD_TOL)


def test_should_use_fused_matches_jax_predicate(monkeypatch):
    """The port's predicate is the JAX one with 'on a CUDA tensor' for 'on a
    TPU backend': equal on every (T, d, bias, mask) once JAX is told it is on
    a TPU, and false for CPU tensors."""
    monkeypatch.setattr(jfused.jax, "default_backend", lambda: "tpu")
    bias = np.zeros((1, 8, 8))
    for T in range(1, 50):
        for d in (8, 16, 64, 128, 129, 256):
            for b, m in ((None, None), (bias, None), (None, bias)):
                want = jfused.should_use_fused(T, d, b, m)
                assert should_use_fused(T, d, b, m, "cuda") is want, (T, d)
                assert should_use_fused(T, d, b, m, torch.device("cpu")) is False


@pytest.mark.parametrize("fused", [False, True])
def test_multi_head_attention_fused_option_on_cpu(fused):
    """On the CPU the fused option takes the plain version too: the same
    values and gradients as JAX's attention, and no kernel launch."""
    from micformer_tpu.ops import attention as jattn

    q, k, v, g = _arrays(7, *[(40, 8, 3, 16)] * 4)
    want = np.asarray(jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v)))
    ref = _jax_grads(jattn.multi_head_attention, q, k, v, g)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    reset_launches()
    out = tattn.multi_head_attention(*leaves, fused=fused)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=FWD_ATOL)
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r, **GRAD_TOL)
    assert all(n == 0 for n in LAUNCHES.values())


# tests/test_ops.py's STN case (flow scaled 1.5 about a 6x5x7 grid) and a
# trilinear case whose coordinates leave the volume on every side
def test_stn_warp_gradients_match_jax():
    B, C, D, H, W = 2, 3, 6, 5, 7
    src, flow, g = _arrays(11, (B, D, H, W, C), (B, 3, D, H, W), (B, D, H, W, C))
    flow *= 1.5
    _, vjp = jax.vjp(jwarp.stn_warp, jnp.asarray(src), jnp.asarray(flow))
    want_src, want_flow = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    ts, tf = (torch.from_numpy(a).requires_grad_() for a in (src, flow))
    twarp.stn_warp(ts, tf).backward(torch.from_numpy(g))
    np.testing.assert_allclose(ts.grad.numpy(), want_src, atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), want_flow, atol=1e-4)


def test_trilinear_sample_gradients_match_jax():
    rng = np.random.default_rng(6)
    B, D, H, W, C = 2, 6, 5, 7, 3
    src = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    lim = np.array([D, H, W], np.float32).reshape(1, 3, 1, 1, 1)
    coords = (rng.uniform(-1.5, 1.2, size=(B, 3, 4, 3, 5)) * lim).astype(np.float32)
    g = rng.normal(size=(B, 4, 3, 5, C)).astype(np.float32)
    _, vjp = jax.vjp(jwarp.trilinear_sample, jnp.asarray(src), jnp.asarray(coords))
    want_src, want_coords = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    ts, tc = (torch.from_numpy(a).requires_grad_() for a in (src, coords))
    twarp.trilinear_sample(ts, tc).backward(torch.from_numpy(g))
    np.testing.assert_allclose(ts.grad.numpy(), want_src, atol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), want_coords, atol=1e-4)


def test_dw_conv3_keeps_autograd_on_cpu():
    """The CPU path is plain torch, so MedNeXt's CPU tests can differentiate
    it; only the CUDA kernel refuses (tests/test_torch_port_kernels.py)."""
    x = torch.randn(1, 3, 5, 6, 4, requires_grad=True)
    w = torch.randn(3, 1, 3, 3, 3, requires_grad=True)
    dw_conv3(x, w).square().sum().backward()
    assert x.grad is not None and w.grad is not None


TINY = dict(num_classes=8, embed_dim=12, depths=(1, 1), num_heads=(3, 6))


def test_use_remat_and_fused_option_keep_values_and_gradients():
    """use_remat (non-reentrant checkpointing, drop-path draws replayed) and
    fused_attention change neither the loss nor any gradient in train mode
    with drop path on; the generator ends in the same state."""
    x = torch.from_numpy(_arrays(3, (1, 2, 32, 32, 32))[0])
    results = []
    for kw in ({}, {"use_remat": True}, {"fused_attention": True}):
        model = registry.build("micformer", device="cpu", drop_path_rate=0.5,
                               generator=torch.Generator().manual_seed(0), **TINY, **kw)
        model.train()
        gen = torch.Generator().manual_seed(5)
        loss = model(x, generator=gen).square().mean()
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()},
                        gen.get_state()))
    base_loss, base_grads, base_state = results[0]
    assert 0.0 < base_loss
    for loss, grads, state in results[1:]:
        assert loss == pytest.approx(base_loss, rel=1e-6)
        assert torch.equal(state, base_state)
        for n, g in grads.items():
            torch.testing.assert_close(g, base_grads[n], rtol=1e-5, atol=1e-7, msg=n)
