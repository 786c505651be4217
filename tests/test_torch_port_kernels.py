"""The port's CUDA kernels against their plain versions, on the card:
window attention (K1) and its backward, the fused window attention (K2) and
its backward, and the depthwise k³ conv (K3) and its backward (dx through
K3, dw and db through the weight-gradient kernel).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py

Without a card its tests skip.
"""

import warnings

import numpy as np
import pytest
import torch

from micformer_tpu_torch.kernels import LAUNCHES
from micformer_tpu_torch.kernels.dw_conv3 import (
    dw_conv3, dw_conv3_backward, dw_conv3_backward_reference, dw_conv3_reference,
)
from micformer_tpu_torch.kernels.fused_window_attention import (
    fused_window_attention, fused_window_attention_backward,
    fused_window_attention_backward_reference, fused_window_attention_reference,
)
from micformer_tpu_torch.kernels.window_attention import (
    window_attention, window_attention_backward, window_attention_backward_reference,
    window_attention_reference,
)

# f32: sums of at most 32 f32 terms in another order; bf16: one rounding of
# values up to about 10 (the kernel and the plain version both compute in f32)
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.device("cuda")


def _qkv(seed, N, Tq, Tk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, Tq, h, d)).astype(np.float32)
    k = rng.normal(size=(N, Tk, h, d)).astype(np.float32)
    v = rng.normal(size=(N, Tk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.cuda
def test_window_attention_kernel_matches_reference_on_card(cuda_device):
    """The CUDA kernel against its plain version, f32 and bf16, contiguous
    and fused-projection (strided) inputs."""
    for N, Tq, Tk, h, d in [(1000, 8, 8, 3, 16), (37, 4, 4, 2, 8),
                            (64, 16, 8, 5, 32), (9, 8, 16, 1, 64)]:
        q, k, v = (torch.from_numpy(a).to(cuda_device)
                   for a in _qkv(N + d, N, Tq, Tk, h, d))
        for dt, atol in [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]:
            a, b, c = q.to(dt), k.to(dt), v.to(dt)
            got = window_attention(a, b, c)
            torch.cuda.synchronize()
            ref = window_attention_reference(a, b, c)
            assert (got.float() - ref.float()).abs().max().item() <= atol
    # q/k/v as slices of the fused projections: self attention splits qkv in
    # thirds (row stride 3*h*d), cross attention kv in halves (2*h*d)
    for dt, atol in [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]:
        qkv = torch.randn(300, 8, 3 * 48, device=cuda_device).to(dt)
        kv = torch.randn(300, 8, 2 * 48, device=cuda_device).to(dt)
        self_qkv = tuple(t.view(300, 8, 3, 16) for t in qkv.chunk(3, dim=-1))
        cross_qkv = (self_qkv[0],) + tuple(t.view(300, 8, 3, 16)
                                           for t in kv.chunk(2, dim=-1))
        for q, k, v in (self_qkv, cross_qkv):
            assert not k.is_contiguous()
            ref = window_attention_reference(q, k, v)
            got = window_attention(q, k, v)
            assert (got.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_window_attention_kernel_raises_on_unsupported_card_inputs(cuda_device):
    q = torch.zeros(4, 8, 2, 24, device=cuda_device)          # d = 24
    with pytest.raises(ValueError):
        window_attention(q, q, q)
    q = torch.zeros(4, 17, 2, 16, device=cuda_device)         # T = 17
    with pytest.raises(ValueError):
        window_attention(q, q, q)
    q = torch.zeros(4, 8, 2, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError):
        window_attention(q, q, q)
    q = torch.zeros(4, 2, 8, 16, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError):
        window_attention(q, q, q)


@pytest.mark.cuda
def test_window_attention_counts_each_launch_on_card(cuda_device):
    q = torch.randn(64, 8, 3, 16, device=cuda_device)
    before = LAUNCHES["window_attention"]
    window_attention(q, q, q)
    window_attention(q, q, q, scale=0.5)
    window_attention(q[:0], q[:0], q[:0])                     # N = 0: no launch
    window_attention_reference(q, q, q)
    assert LAUNCHES["window_attention"] == before + 2


# f32: 27-125 f32 terms summed in another order; bf16: one rounding of
# outputs up to about 10
DW_TOL = {torch.float32: dict(rtol=0.0, atol=1e-4),
          torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,offset", [
    ((4, 256, 16, 16, 16), 3, 0),       # MedNeXt-S stage 3 at sw_batch 4
    ((4, 256, 16, 16, 16), 5, 0),
    ((2, 7, 19, 37, 45), 3, 0),         # ragged: no axis a multiple of the tile
    ((1, 5, 13, 9, 70), 5, 0),
    ((2, 3, 6, 5, 7), 5, 0),            # fewer W columns than halo threads
    ((1, 6, 5, 7, 12), 3, 1),           # x one element off 16-byte alignment
])
def test_dw_conv3_kernel_matches_reference_on_card(cuda_device, shape, k, offset):
    rng = np.random.default_rng(sum(shape) + k)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(shape[1], 1, k, k, k)).astype(np.float32)
                         / k ** 1.5).to(cuda_device)
    b = torch.from_numpy(rng.normal(size=shape[1]).astype(np.float32)).to(cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        # contiguous, but starting `offset` elements into its storage
        xd = torch.empty(x.numel() + offset, dtype=dt, device=cuda_device)[offset:]
        xd = xd.view(shape).copy_(x)
        for bias in (None, b.to(dt)):
            got = dw_conv3(xd, w.to(dt), bias)
            torch.cuda.synchronize()
            ref = dw_conv3_reference(xd, w.to(dt), bias)
            assert got.dtype == dt and got.shape == x.shape
            torch.testing.assert_close(got.float(), ref.float(), **DW_TOL[dt])


@pytest.mark.cuda
def test_dw_conv3_kernel_raises_and_counts_on_card(cuda_device):
    x = torch.randn(2, 4, 6, 6, 6, device=cuda_device)
    w = torch.randn(4, 1, 3, 3, 3, device=cuda_device)
    with pytest.raises(ValueError):
        dw_conv3(x.half(), w.half())
    with pytest.raises(ValueError):
        dw_conv3(x.transpose(3, 4), w)
    with pytest.raises(ValueError):
        dw_conv3(x, w.cpu())
    before = LAUNCHES["dw_conv3"]
    dw_conv3(x, w)
    dw_conv3(x[:0], w)                                        # empty: no launch
    dw_conv3_reference(x, w)
    assert LAUNCHES["dw_conv3"] == before + 1


def _layouts(dev, dt, N, T, h, d, seed):
    """q, k, v [N, T, h, d] three ways: dense; sliced from one fused qkv
    projection (self attention, row stride 3·h·d); q dense with k, v sliced
    from a fused kv projection (cross attention, row stride 2·h·d)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    C = h * d
    dense = tuple(rand(N, T, h, d) for _ in range(3))
    self_ = tuple(t.view(N, T, h, d) for t in rand(N, T, 3 * C).chunk(3, dim=-1))
    cross = (rand(N, T, h, d),) + tuple(t.view(N, T, h, d)
                                        for t in rand(N, T, 2 * C).chunk(2, dim=-1))
    return {"dense": dense, "self": self_, "cross": cross}


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,h,d", [(4096, 8, 3, 16), (37, 8, 24, 16), (300, 4, 2, 8),
                                     (64, 16, 5, 32), (9, 16, 1, 64)])
def test_window_attention_backward_kernel_matches_reference_on_card(cuda_device, N, T, h, d):
    """K1's backward against its plain version: f32 and bf16, dense and
    fused-projection layouts, a ragged window count."""
    for dt in (torch.float32, torch.bfloat16):
        for name, (q, k, v) in _layouts(cuda_device, dt, N, T, h, d, N + d).items():
            g = torch.randn(q.shape, device=cuda_device).to(dt)
            got = window_attention_backward(q, k, v, g)
            torch.cuda.synchronize()
            ref = window_attention_backward_reference(q, k, v, g)
            for a, b in zip(got, ref):
                assert a.dtype == dt and a.is_contiguous() and a.shape == b.shape
                torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dt],
                                           msg=f"{name} {dt}")


@pytest.mark.cuda
def test_window_attention_autograd_on_card(cuda_device):
    """window_attention under autograd: the backward kernel runs, once per
    call, and gives the plain version's gradients; cross lengths Tq != Tk."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a).to(cuda_device).requires_grad_()
               for a in _qkv(3, 50, 4, 12, 3, 16))
    g = torch.from_numpy(rng.normal(size=(50, 4, 3, 16)).astype(np.float32)).to(cuda_device)
    before = dict(LAUNCHES)
    window_attention(q, k, v).backward(g)
    assert LAUNCHES["window_attention"] == before["window_attention"] + 1
    assert LAUNCHES["window_attention_backward"] == before["window_attention_backward"] + 1
    ref = window_attention_backward_reference(q.detach(), k.detach(), v.detach(), g)
    for t, r in zip((q, k, v), ref):
        torch.testing.assert_close(t.grad, r, **BWD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("N,h,T,d", [(4096, 3, 8, 16), (20, 3, 8, 16), (7, 2, 8, 16),
                                     (5, 1, 4, 8), (33, 2, 16, 24), (11, 3, 32, 128),
                                     (9, 5, 2, 64), (3, 2, 8, 6)])
def test_fused_window_attention_kernels_match_reference_on_card(cuda_device, N, h, T, d):
    """K2's forward and backward against their plain versions: f32 and bf16,
    on [N, h, T, d] transposed views of the path's layouts (and dense ones),
    pair counts that are not multiples of 128 / T, and feature widths that
    rule out 16-byte loads (d = 6)."""
    for dt in (torch.float32, torch.bfloat16):
        for name, qkv in _layouts(cuda_device, dt, N, T, h, d, N + T).items():
            q, k, v = (t.transpose(1, 2) for t in qkv)
            got = fused_window_attention(q, k, v)
            torch.cuda.synchronize()
            ref = fused_window_attention_reference(q, k, v)
            assert got.shape == (N, h, T, d) and got.dtype == dt
            assert got.transpose(1, 2).is_contiguous()
            assert (got.float() - ref.float()).abs().max().item() <= ATOL[dt], name
            g = torch.randn(q.shape, device=cuda_device).to(dt)
            grads = fused_window_attention_backward(q, k, v, g)
            torch.cuda.synchronize()
            for a, b in zip(grads, fused_window_attention_backward_reference(q, k, v, g)):
                torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dt],
                                           msg=f"{name} {dt}")


@pytest.mark.cuda
def test_fused_window_attention_autograd_raises_and_counts_on_card(cuda_device):
    q = torch.randn(40, 3, 8, 16, device=cuda_device, requires_grad=True)
    before = dict(LAUNCHES)
    out = fused_window_attention(q, q * 0.5, q * 2.0)
    out.sum().backward()
    fused_window_attention_reference(q, q, q)
    assert LAUNCHES["fused_window_attention"] == before["fused_window_attention"] + 1
    assert (LAUNCHES["fused_window_attention_backward"]
            == before["fused_window_attention_backward"] + 1)
    assert LAUNCHES["window_attention"] == before["window_attention"]
    for T, d in [(12, 16), (64, 16), (8, 160)]:                # 128 % T, T, d
        x = torch.zeros(4, 2, T, d, device=cuda_device)
        with pytest.raises(ValueError):
            fused_window_attention(x, x, x)
    x = torch.zeros(4, 2, 8, 16, device=cuda_device)
    with pytest.raises(ValueError):
        fused_window_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError):
        fused_window_attention(x.transpose(2, 3), x.transpose(2, 3), x.transpose(2, 3))


# dx as DW_TOL (K3 itself); dw and db: sums of up to 10^5 exact f32 products
# in another order (f32), rounded once to bf16 (bf16)
DW_BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-3),
              torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,offset", [
    ((2, 32, 32, 32, 32), 3, 0),        # MedNeXt-S's stage-0 channels at 32³
    ((2, 512, 8, 8, 8), 3, 0),          # the bottleneck's shape
    ((2, 7, 19, 37, 45), 3, 0),         # ragged: no axis a multiple of the tile
    ((1, 5, 13, 9, 70), 5, 0),
    ((2, 3, 6, 5, 7), 5, 0),            # fewer W columns than halo threads
    ((1, 6, 5, 7, 12), 3, 1),           # x and g one element off 16-byte alignment
])
def test_dw_conv3_backward_kernels_match_reference_on_card(cuda_device, shape, k, offset):
    """dx (K3 on the flipped weight), dw and db (the weight-gradient kernel)
    against the plain version, f32 and bf16, each one K3 and one wgrad launch."""
    rng = np.random.default_rng(sum(shape) + k)
    arrays = [rng.normal(size=shape), rng.normal(size=(shape[1], 1, k, k, k)) / k ** 1.5,
              rng.normal(size=shape)]
    for dt in (torch.float32, torch.bfloat16):
        x, w, g = (torch.from_numpy(a.astype(np.float32)).to(cuda_device, dt) for a in arrays)
        if offset:
            x, g = (torch.empty(t.numel() + offset, dtype=dt, device=cuda_device)[offset:]
                    .view(shape).copy_(t) for t in (x, g))
        before = dict(LAUNCHES)
        got = dw_conv3_backward(x, w, g)
        torch.cuda.synchronize()
        assert LAUNCHES["dw_conv3"] == before["dw_conv3"] + 1
        assert LAUNCHES["dw_conv3_wgrad"] == before["dw_conv3_wgrad"] + 1
        for name, a, b in zip(("dx", "dw", "db"), got, dw_conv3_backward_reference(x, w, g)):
            assert a.dtype == dt and a.shape == b.shape, name
            tol = DW_TOL[dt] if name == "dx" else DW_BWD_TOL[dt]
            torch.testing.assert_close(a.float(), b.float(), **tol, msg=f"{name} {dt}")


@pytest.mark.cuda
def test_dw_conv3_autograd_raises_and_counts_on_card(cuda_device):
    """dw_conv3 under autograd: K3 forward, then K3 for dx and one wgrad
    launch for dw and db; strided layouts are refused; no launch for the
    plain versions or for what autograd does not ask for."""
    rng = np.random.default_rng(4)
    x, g = (torch.from_numpy(rng.normal(size=(2, 4, 6, 7, 9)).astype(np.float32))
            .to(cuda_device) for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(4, 1, 3, 3, 3)).astype(np.float32) / 5).to(cuda_device)
    b = torch.from_numpy(rng.normal(size=4).astype(np.float32)).to(cuda_device)
    xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))
    before = dict(LAUNCHES)
    dw_conv3(xl, wl, bl).backward(g)
    assert LAUNCHES["dw_conv3"] == before["dw_conv3"] + 2
    assert LAUNCHES["dw_conv3_wgrad"] == before["dw_conv3_wgrad"] + 1
    dx, dw, db = dw_conv3_backward_reference(x, w, g)
    for t, r in ((xl, dx), (wl, dw), (bl, db)):
        torch.testing.assert_close(t.grad, r, **DW_BWD_TOL[torch.float32])
    # only the weight asks for a gradient: no dx launch
    before = dict(LAUNCHES)
    dw_conv3(x, wl).backward(g)
    assert LAUNCHES["dw_conv3"] == before["dw_conv3"] + 1
    assert LAUNCHES["dw_conv3_wgrad"] == before["dw_conv3_wgrad"] + 1
    with pytest.raises(ValueError):
        dw_conv3_backward(x.transpose(3, 4), w, g.transpose(3, 4))
    with pytest.raises(ValueError):
        dw_conv3_backward(x, w, g.transpose(3, 4).contiguous().transpose(3, 4))
    with pytest.raises(ValueError):
        dw_conv3_backward(x, w, g.bfloat16())
    with pytest.raises(ValueError):
        dw_conv3(xl.transpose(3, 4), wl)
    before = dict(LAUNCHES)
    dw_conv3_backward_reference(x, w, g)
    with torch.no_grad():
        dw_conv3(x, wl)                                       # serving: forward only
    assert LAUNCHES["dw_conv3"] == before["dw_conv3"] + 1
    assert LAUNCHES["dw_conv3_wgrad"] == before["dw_conv3_wgrad"]


@pytest.mark.cuda
def test_dw_conv3_gradcheck_on_card(cuda_device):
    """Finite differences of the Function at a tiny f32 shape: the conv is
    linear in each argument, so central differences at eps 1e-2 are exact
    up to f32 rounding of outputs near 1."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(1, 2, 4, 5, 6, generator=gen, device=cuda_device).requires_grad_()
    w = (torch.randn(2, 1, 3, 3, 3, generator=gen, device=cuda_device) / 5).requires_grad_()
    b = torch.randn(2, generator=gen, device=cuda_device).requires_grad_()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")             # gradcheck prefers f64; K3 takes f32
        assert torch.autograd.gradcheck(dw_conv3, (x, w, b), eps=1e-2, atol=5e-3, rtol=1e-2)
