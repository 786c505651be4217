"""The port's CUDA kernels against their plain versions, on the card:
window attention (K1) and its backward on each of their two routes (mma,
ffma), the fused window attention (K2) and its backward on the same two
routes, and the depthwise k³ conv (K3) and its backward (dx through
K3, dw and db through the weight-gradient kernel), on each of their three
staging routes (tma, volume, cp_async).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py

Without a card its tests skip.
"""

import itertools
import warnings

import numpy as np
import pytest
import torch

from micformer_tpu_torch.kernels import LAUNCHES, _build
from micformer_tpu_torch.kernels.dw_conv3 import (
    _DTYPE_CODES, ROUTE_NAMES, ROUTES, _dw_route, _forward, _wgrad, _wgrad_fns,
    _wgrad_plan, _wgrad_scratch_size, dw_conv3, dw_conv3_backward,
    dw_conv3_backward_reference, dw_conv3_reference, dw_conv3_wgrad_reference,
)
from micformer_tpu_torch.kernels.fused_window_attention import (
    _backward as _fused_backward, _forward as _fused_forward, _fused_aligned, _fused_plan,
    _fused_route, _fused_smem, fused_window_attention, fused_window_attention_backward,
    fused_window_attention_backward_reference, fused_window_attention_reference,
)
from micformer_tpu_torch.kernels.window_attention import (
    DTYPE_CODES as ATTN_DTYPE_CODES, ROUTE_NAMES as ATTN_ROUTE_NAMES, ROUTES as ATTN_ROUTES,
    _aligned, _attn_plan, _attn_route, _attn_smem, _backward as _attn_backward,
    _forward as _attn_forward, _sms, window_attention,
    window_attention_backward, window_attention_backward_reference, window_attention_reference,
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


# (N, T, h, d): the four stages of a b4 serving forward and of a b1 training
# step at 128³, and a ragged window count
ATTN_PATH = [(16384, 8, 3, 16), (2048, 8, 6, 16), (256, 8, 12, 16), (32, 8, 24, 16),
             (4096, 8, 3, 16), (512, 8, 6, 16), (64, 8, 12, 16), (8, 8, 24, 16),
             (1000, 8, 3, 16)]


def _attn_routes_counted(kernel, route, before, n=1):
    return ATTN_ROUTES[kernel][route] == before[kernel][route] + n


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,h,d", ATTN_PATH)
def test_window_attention_routes_match_reference_on_card(cuda_device, N, T, h, d):
    """K1 and its backward on every route that takes the inputs (bf16: mma
    and ffma; f32: ffma), in the dense, self and cross layouts, against the
    plain versions; where both routes apply they agree; each launch is
    counted on its route."""
    for dt in (torch.float32, torch.bfloat16):
        routes = ("mma", "ffma") if dt == torch.bfloat16 else ("ffma",)
        gen = torch.Generator(device=cuda_device).manual_seed(N + h)
        for name, (q, k, v) in _layouts(cuda_device, dt, N, T, h, d, N + h).items():
            g = torch.randn(q.shape, generator=gen, device=cuda_device).to(dt)
            ref = window_attention_reference(q, k, v).float()
            ref_grads = window_attention_backward_reference(q, k, v, g)
            got = {}
            for route in routes:
                before = {kern: dict(c) for kern, c in ATTN_ROUTES.items()}
                out = _attn_forward(q, k, v, None, route=route)
                grads = _attn_backward(q, k, v, g, None, route=route)
                torch.cuda.synchronize()
                assert _attn_routes_counted("window_attention", route, before)
                assert _attn_routes_counted("window_attention_backward", route, before)
                assert (out.float() - ref).abs().max().item() <= ATOL[dt], (name, dt, route)
                for a, b in zip(grads, ref_grads):
                    torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dt],
                                               msg=f"{name} {dt} {route}")
                got[route] = (out, *grads)
            if len(got) == 2:
                for a, b in zip(got["mma"], got["ffma"]):
                    torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dt],
                                               msg=f"{name}: mma against ffma")


def _offset(t, offset):
    """t's values in a fresh tensor `offset` elements into its storage."""
    out = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)[offset:]
    return out.view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("N,Tq,Tk,h,d", [(300, 8, 16, 2, 16), (77, 16, 4, 3, 32),
                                         (1000, 4, 8, 4, 8), (13, 8, 8, 24, 64)])
def test_window_attention_uneven_lengths_and_misaligned_rows_on_card(cuda_device, N, Tq, Tk,
                                                                     h, d):
    """Tq != Tk and ragged N on the ffma route (and on mma where Tq = Tk =
    8), forward and backward; the backward also with every operand one
    element off 16-byte alignment (ffma with element staging)."""
    rng = np.random.default_rng(N)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(a).to(cuda_device, dt) for a in _qkv(N, N, Tq, Tk, h, d))
        g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(cuda_device, dt)
        out = window_attention(q, k, v)
        torch.cuda.synchronize()
        ref = window_attention_reference(q, k, v)
        assert (out.float() - ref.float()).abs().max().item() <= ATOL[dt]
        ref_grads = window_attention_backward_reference(q, k, v, g)
        shifted = [_offset(t, 1) for t in (q, k, v, g)]
        assert not _aligned(*shifted)
        for args in ((q, k, v, g), shifted):
            before = {kern: dict(c) for kern, c in ATTN_ROUTES.items()}
            grads = window_attention_backward(*args)
            torch.cuda.synchronize()
            if args is shifted:
                assert _attn_routes_counted("window_attention_backward", "ffma", before)
            for a, b in zip(grads, ref_grads):
                torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dt], msg=f"{dt}")


@pytest.mark.cuda
def test_window_attention_refuses_routes_the_inputs_cannot_take_on_card(cuda_device):
    """The mma route for f32, T != 8, Tq != Tk, d = 8 or misaligned operands
    fails in the C entry and raises; nothing is counted and nothing falls
    back. An unknown route raises before any launch."""
    def rand(N, T, h, d, dt):
        return torch.randn(N, T, h, d, device=cuda_device).to(dt)

    bf16 = torch.bfloat16
    cases = [(rand(64, 8, 3, 16, torch.float32),) * 3, (rand(64, 4, 3, 16, bf16),) * 3,
             (rand(64, 8, 3, 8, bf16),) * 3,
             (rand(64, 8, 3, 16, bf16), rand(64, 16, 3, 16, bf16), rand(64, 16, 3, 16, bf16))]
    before = dict(LAUNCHES), {kern: dict(c) for kern, c in ATTN_ROUTES.items()}
    for q, k, v in cases:
        with pytest.raises(RuntimeError):
            _attn_forward(q, k, v, None, route="mma")
        with pytest.raises(RuntimeError):
            _attn_backward(q, k, v, torch.ones_like(q), None, route="mma")
    q = _offset(rand(64, 8, 3, 16, bf16), 1)
    with pytest.raises(RuntimeError):
        _attn_backward(q, q, q, q, None, route="mma")
    with pytest.raises(ValueError):
        _attn_forward(*cases[1], None, route="wgmma")
    assert dict(LAUNCHES) == before[0]
    assert {kern: dict(c) for kern, c in ATTN_ROUTES.items()} == before[1]


@pytest.mark.cuda
def test_window_attention_plans_take_the_shared_memory_the_kernels_count_on_card(cuda_device):
    """`_attn_smem`, by which `_attn_plan` sizes a tile, equals what the C
    entries launch with (their smem queries), for the plans of every path
    stage and contract corner on both routes."""
    fwd = _build.load("window_attention").window_attention_forward_smem
    bwd = _build.load("window_attention_backward").window_attention_backward_smem
    shapes = [(N, T, T, h, d) for N, T, h, d in ATTN_PATH] + [
        (300, 8, 16, 2, 16), (77, 16, 4, 3, 32), (1000, 4, 8, 4, 8), (13, 8, 8, 24, 64),
        (300, 16, 16, 24, 64)]
    for (N, Tq, Tk, h, d), dt, backward, aligned in itertools.product(
            shapes, (torch.float32, torch.bfloat16), (False, True), (False, True)):
        route = _attn_route(Tq, Tk, d, dt, aligned)
        W, Hg, warps = _attn_plan(N, Tq, Tk, h, d, dt, route, backward, _sms(cuda_device))
        want = _attn_smem(W, Hg, Tq, Tk, d, dt, route, backward, warps)
        code = ATTN_DTYPE_CODES[dt]
        got = (bwd(W, Hg, warps, Tq, Tk, d, code, ATTN_ROUTE_NAMES.index(route))
               if backward else fwd(W, Hg, Tq, Tk, d, code))
        assert got == want, (N, Tq, Tk, h, d, dt, route, backward)


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,h,d", [(4096, 8, 3, 16), (8, 8, 24, 16), (300, 4, 2, 8),
                                     (64, 16, 5, 32)])
def test_window_attention_backward_is_bitwise_reproducible_on_card(cuda_device, N, T, h, d):
    """dq, dk and dv have no atomics and a fixed summation order: two calls
    on the same inputs agree bit for bit, on both routes."""
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = _layouts(cuda_device, dt, N, T, h, d, N)["self"]
        g = torch.randn(q.shape, device=cuda_device).to(dt)
        first = window_attention_backward(q, k, v, g)
        second = window_attention_backward(q, k, v, g)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


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


# (N, h, T, d): K2 at the four stages of a b1 training step and of a b4
# serving forward, then its contract's corners (T 1-32, d 6-128, ragged N)
FUSED_PATH = [(4096, 3, 8, 16), (512, 6, 8, 16), (64, 12, 8, 16), (8, 24, 8, 16),
              (16384, 3, 8, 16), (2048, 6, 8, 16), (256, 12, 8, 16), (32, 24, 8, 16)]
FUSED_CORNERS = [(1000, 4, 4, 8), (300, 3, 16, 64), (77, 2, 32, 128), (13, 5, 32, 16),
                 (33, 2, 16, 24), (3, 2, 8, 6), (9, 5, 2, 64), (40, 7, 1, 100),
                 (20, 3, 8, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,h,T,d", FUSED_PATH + FUSED_CORNERS)
def test_fused_window_attention_routes_match_reference_on_card(cuda_device, N, h, T, d):
    """K2 and its backward on every route that takes the inputs (mma and
    ffma where bf16, T = 8 and d % 16 == 0; else ffma), on [N, h, T, d] views
    of the dense, self and cross layouts and with every operand one element
    off 16-byte alignment (ffma, element staging), against the plain
    versions; where both routes apply they agree; each launch is counted on
    its route."""
    for dt in (torch.float32, torch.bfloat16):
        routes = ("mma", "ffma") if _fused_route(T, d, dt, True) == "mma" else ("ffma",)
        gen = torch.Generator(device=cuda_device).manual_seed(N + T + d)
        cases = {name: tuple(t.transpose(1, 2) for t in qkv)
                 for name, qkv in _layouts(cuda_device, dt, N, T, h, d, N + d).items()}
        cases["misaligned"] = tuple(_offset(t, 1) for t in cases["dense"])
        for name, (q, k, v) in cases.items():
            g = torch.randn(q.shape, generator=gen, device=cuda_device).to(dt)
            if name == "misaligned":
                g = _offset(g, 1)
                assert not _fused_aligned(d, q, k, v, g)
            ref = fused_window_attention_reference(q, k, v).float()
            ref_grads = fused_window_attention_backward_reference(q, k, v, g)
            got = {}
            for route in routes if name != "misaligned" else ("ffma",):
                before = {kern: dict(c) for kern, c in ATTN_ROUTES.items()}
                out = _fused_forward(q, k, v, None, route=route)
                grads = _fused_backward(q, k, v, g, None, route=route)
                torch.cuda.synchronize()
                assert _attn_routes_counted("fused_window_attention", route, before)
                assert _attn_routes_counted("fused_window_attention_backward", route, before)
                assert (out.float() - ref).abs().max().item() <= ATOL[dt], (name, dt, route)
                for a, b in zip(grads, ref_grads):
                    assert a.shape == b.shape and a.dtype == dt
                    torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dt],
                                               msg=f"{name} {dt} {route}")
                got[route] = (out, *grads)
            if len(got) == 2:
                for a, b in zip(got["mma"], got["ffma"]):
                    torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dt],
                                               msg=f"{name}: mma against ffma")


@pytest.mark.cuda
def test_fused_window_attention_refuses_routes_the_inputs_cannot_take_on_card(cuda_device):
    """The mma route for f32, T != 8, d not a multiple of 16 or misaligned
    operands fails in the C entry and raises; nothing is counted and nothing
    falls back. An unknown route raises before any launch."""
    def rand(N, h, T, d, dt):
        return torch.randn(N, h, T, d, device=cuda_device).to(dt)

    bf16 = torch.bfloat16
    cases = [rand(64, 3, 8, 16, torch.float32), rand(64, 3, 4, 16, bf16),
             rand(64, 3, 16, 16, bf16), rand(64, 3, 8, 24, bf16),
             _offset(rand(64, 3, 8, 16, bf16), 1)]
    before = dict(LAUNCHES), {kern: dict(c) for kern, c in ATTN_ROUTES.items()}
    for q in cases:
        with pytest.raises(RuntimeError):
            _fused_forward(q, q, q, None, route="mma")
        with pytest.raises(RuntimeError):
            _fused_backward(q, q, q, torch.ones_like(q), None, route="mma")
    with pytest.raises(ValueError):
        _fused_forward(cases[1], cases[1], cases[1], None, route="wgmma")
    assert dict(LAUNCHES) == before[0]
    assert {kern: dict(c) for kern, c in ATTN_ROUTES.items()} == before[1]


@pytest.mark.cuda
def test_fused_window_attention_plans_take_the_shared_memory_the_kernels_count_on_card(
        cuda_device):
    """`_fused_smem`, by which `_fused_plan` sizes a tile, equals what the C
    entries launch with (their smem queries), for the plans of every path
    stage and contract corner on both routes and both directions, the
    opted-in one-pair plans of T = 32, d = 128 in f32 among them."""
    lib = _build.load("window_attention")
    fwd = lib.fused_window_attention_forward_smem
    bwd = _build.load("window_attention_backward").fused_window_attention_backward_smem
    for (N, h, T, d), dt, backward, aligned in itertools.product(
            FUSED_PATH + FUSED_CORNERS, (torch.float32, torch.bfloat16), (False, True),
            (False, True)):
        route = _fused_route(T, d, dt, aligned)
        W, Hg, warps = _fused_plan(N, T, h, d, dt, route, backward, _sms(cuda_device))
        want = _fused_smem(W, Hg, T, d, dt, route, backward, warps)
        code = ATTN_DTYPE_CODES[dt]
        got = (bwd(W, Hg, warps, T, d, code, ATTN_ROUTE_NAMES.index(route)) if backward
               else fwd(W, Hg, T, d, code))
        assert got == want, (N, h, T, d, dt, route, backward)


@pytest.mark.cuda
@pytest.mark.parametrize("N,h,T,d", [(4096, 3, 8, 16), (8, 24, 8, 16), (300, 3, 16, 64),
                                     (77, 2, 32, 128), (33, 2, 16, 24)])
def test_fused_window_attention_backward_is_bitwise_reproducible_on_card(cuda_device, N, h, T,
                                                                        d):
    """dq, dk and dv have no atomics and a fixed summation order: two calls
    on the same inputs agree bit for bit, on both routes."""
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (t.transpose(1, 2) for t in _layouts(cuda_device, dt, N, T, h, d, N)["self"])
        g = torch.randn(q.shape, device=cuda_device).to(dt)
        first = fused_window_attention_backward(q, k, v, g)
        second = fused_window_attention_backward(q, k, v, g)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,h,d", [(4096, 8, 3, 16), (8, 8, 24, 16), (1000, 8, 3, 16),
                                     (37, 8, 2, 64)])
def test_fused_and_window_attention_agree_bitwise_at_t8_on_card(cuda_device, N, T, h, d):
    """K2 on the [N, h, T, d] transposed views of K1's inputs runs K1's device
    code on both routes: the same output and gradients, bit for bit."""
    for dt in (torch.float32, torch.bfloat16):
        for name, (q, k, v) in _layouts(cuda_device, dt, N, T, h, d, N + h).items():
            g = torch.randn(q.shape, device=cuda_device).to(dt)
            k1 = (window_attention(q, k, v), *window_attention_backward(q, k, v, g))
            qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, g))
            k2 = (fused_window_attention(qt, kt, vt),
                  *fused_window_attention_backward(qt, kt, vt, gt))
            for a, b in zip(k1, k2):
                assert torch.equal(a, b.transpose(1, 2)), (name, dt)


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


def _on_card(shape, dt, dev, offset=0, seed=0):
    """A seeded normal tensor of `shape` on the card, `offset` elements into
    its storage."""
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    t = torch.empty(int(np.prod(shape)) + offset, dtype=dt, device=dev)[offset:]
    return t.view(shape).copy_(torch.from_numpy(a))


@pytest.mark.cuda
@pytest.mark.parametrize("route,shape,k,offset", [
    ("tma", (1, 4, 37, 40, 128), 3, 0),         # 128 wide, D not a multiple of the chunk
    ("tma", (1, 3, 21, 19, 136), 5, 0),
    ("volume", (4, 512, 8, 8, 8), 3, 0),        # the bottleneck at sw_batch 4
    ("volume", (2, 256, 16, 16, 16), 3, 0),     # stage 3 in a b2 training step
    ("volume", (3, 5, 11, 16, 8), 5, 0),
    ("cp_async", (2, 3, 9, 10, 13), 3, 0),      # W % 8 != 0
    ("cp_async", (1, 6, 5, 7, 12), 3, 1),       # one element off 16-byte alignment
    ("cp_async", (1, 4, 7, 9, 21), 5, 1),
])
def test_dw_conv3_routes_match_reference_on_card(cuda_device, route, shape, k, offset):
    """Each staging route, as `_dw_route` picks it, against the plain
    versions in f32 and bf16: K3 with a bias, dx (K3 on the flipped weight),
    dw and db; each launch counted on its route."""
    C = shape[1]
    for dt in (torch.float32, torch.bfloat16):
        x = _on_card(shape, dt, cuda_device, offset, seed=1)
        g = _on_card(shape, dt, cuda_device, offset, seed=2)
        w = (_on_card((C, 1, k, k, k), dt, cuda_device, seed=3).float() / k ** 1.5).to(dt)
        b = _on_card((C,), dt, cuda_device, seed=4)
        assert _dw_route(shape, dt, k, x.data_ptr(), g.data_ptr()) == route
        before = {name: dict(c) for name, c in ROUTES.items()}
        got = dw_conv3(x, w, b)
        dx, dw, db = dw_conv3_backward(x, w, g)
        torch.cuda.synchronize()
        assert ROUTES["dw_conv3"][route] == before["dw_conv3"][route] + 2
        assert ROUTES["dw_conv3_wgrad"][route] == before["dw_conv3_wgrad"][route] + 1
        torch.testing.assert_close(got.float(), dw_conv3_reference(x, w, b).float(),
                                   **DW_TOL[dt], msg=f"forward {dt}")
        for name, a, r in zip(("dx", "dw", "db"), (dx, dw, db),
                              dw_conv3_backward_reference(x, w, g)):
            tol = DW_TOL[dt] if name == "dx" else DW_BWD_TOL[dt]
            torch.testing.assert_close(a.float(), r.float(), **tol, msg=f"{name} {dt}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 40, 48, 64), (4, 512, 8, 8, 8),
                                   (2, 24, 13, 15, 17)])
def test_dw_conv3_wgrad_is_bitwise_reproducible_on_card(cuda_device, shape):
    """dw and db have no atomics and a fixed summation order: two calls on
    the same inputs agree bit for bit (tma, volume and cp_async shapes)."""
    for dt in (torch.float32, torch.bfloat16):
        x = _on_card(shape, dt, cuda_device, seed=5)
        g = _on_card(shape, dt, cuda_device, seed=6)
        first = _wgrad(x, g, 3)
        second = _wgrad(x, g, 3)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_dw_conv3_refuses_routes_the_inputs_cannot_take_on_card(cuda_device):
    """A route the inputs cannot take fails in the C entry and raises: TMA
    for rows that are not 16-byte multiples or a misaligned tensor, the
    volume route above 16³; nothing is counted and nothing falls back."""
    w = torch.randn(3, 1, 3, 3, 3, device=cuda_device)
    ragged = torch.randn(1, 3, 6, 6, 13, device=cuda_device)           # W * 4 % 16 != 0
    shifted = _on_card((1, 3, 6, 6, 16), torch.float32, cuda_device, offset=1)
    big = torch.randn(1, 3, 17, 16, 16, device=cuda_device)
    before = dict(LAUNCHES), {name: dict(c) for name, c in ROUTES.items()}
    for x, route in ((ragged, "tma"), (ragged, "volume"), (shifted, "tma"), (big, "volume")):
        with pytest.raises(RuntimeError):
            _forward(x, w, None, route=route)
        with pytest.raises(RuntimeError):
            _wgrad(x, x, 3, route=route)
    with pytest.raises(ValueError):
        _forward(big, w, None, route="cuda")
    assert dict(LAUNCHES) == before[0]
    assert {name: dict(c) for name, c in ROUTES.items()} == before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((2, 32, 128, 128, 128), 3), ((2, 512, 8, 8, 8), 3),
                                     ((2, 24, 37, 45, 51), 3), ((1, 16, 19, 23, 70), 5),
                                     ((2, 3, 6, 5, 7), 5)])
def test_dw_conv3_wgrad_scratch_follows_the_plan_on_card(cuda_device, shape, k):
    """The C scratch query agrees with the plan's count of partials on
    every route the shape can take."""
    size, _ = _wgrad_fns()
    B, C, D, H, W = shape
    for dt in (torch.float32, torch.bfloat16):
        for route in ROUTE_NAMES:
            plan = _wgrad_plan(shape, dt, k, route)
            n = size(B * C, C, D, H, W, k, _DTYPE_CODES[dt], ROUTE_NAMES.index(route), *plan)
            if route == "volume" and max(D, H, W) > 16:
                assert n == -1
            else:
                assert n == _wgrad_scratch_size(shape, k, route, plan), (route, dt)


@pytest.mark.cuda
def test_dw_conv3_forced_routes_agree_on_card(cuda_device):
    """One 16³ input forced through all three routes: the same f32 sums in
    the same (dz, dy, dx) order, so K3's outputs agree bit for bit and dw
    within f32 reordering."""
    x = _on_card((2, 8, 16, 16, 16), torch.float32, cuda_device, seed=7)
    g = _on_card((2, 8, 16, 16, 16), torch.float32, cuda_device, seed=8)
    w = _on_card((8, 1, 3, 3, 3), torch.float32, cuda_device, seed=9)
    outs = [_forward(x, w, None, route=r) for r in ROUTE_NAMES]
    grads = [_wgrad(x, g, 3, route=r) for r in ROUTE_NAMES]
    ref = dw_conv3_wgrad_reference(x, g, 3)
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    for dw, db in grads:
        torch.testing.assert_close(dw, ref[0], **DW_BWD_TOL[torch.float32])
        torch.testing.assert_close(db, ref[1], **DW_BWD_TOL[torch.float32])


# ---- the zoo on the card: SwinUnet3D's gated convs and the attention paths ----

# SwinUnet3D's gated depthwise convs (groups = channels, k3, bias): its four
# stage shapes serving at sw_batch 4, roi 128 ([4, C, n³]) and their
# training b2 counterparts
SWIN_DW = [(4, 96, 32, 32, 32), (4, 192, 16, 16, 16), (4, 384, 8, 8, 8), (4, 768, 4, 4, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWIN_DW + [(2,) + s[1:] for s in SWIN_DW])
def test_dw_conv3_swinunet3d_shapes_match_reference_on_card(cuda_device, shape):
    """K3 forward with bias and its backward (dx through K3, dw and db
    through the wgrad kernel) at 96-768 channels, f32 and bf16, each launch
    on the route `_dw_route` picks (bf16 at 4³: cp_async, 8-byte rows)."""
    rng = np.random.default_rng(sum(shape))
    arrays = [rng.normal(size=shape), rng.normal(size=(shape[1], 1, 3, 3, 3)) / 3 ** 1.5,
              rng.normal(size=shape), rng.normal(size=shape[1])]
    for dt in (torch.float32, torch.bfloat16):
        x, w, g, b = (torch.from_numpy(a.astype(np.float32)).to(cuda_device, dt)
                      for a in arrays)
        route = _dw_route(x.shape, dt, 3, x.data_ptr())
        before = ROUTES["dw_conv3"][route]
        got = dw_conv3(x, w, b)
        torch.cuda.synchronize()
        assert ROUTES["dw_conv3"][route] == before + 1
        torch.testing.assert_close(got.float(), dw_conv3_reference(x, w, b).float(),
                                   **DW_TOL[dt])
        grads = dw_conv3_backward(x, w, g)
        torch.cuda.synchronize()
        for name, a, r in zip(("dx", "dw", "db"), grads, dw_conv3_backward_reference(x, w, g)):
            tol = DW_TOL[dt] if name == "dx" else DW_BWD_TOL[dt]
            torch.testing.assert_close(a.float(), r.float(), **tol, msg=f"{name} {dt}")
    assert _dw_route(SWIN_DW[3], torch.bfloat16, 3, 0) == "cp_async"


@pytest.mark.cuda
def test_attention_paths_on_card(cuda_device):
    """Unbiased, unmasked T <= 16: K1 (or K2 under fused=True); a bias, a
    mask or T > 16: the plain chain, no kernel launch. The card's chain and
    its CPU run each lie within the f32 rounding bound of an f64 run
    (`torch_port_attn_ref.f32_bound`), and within 1e-5 of each other; a
    failure names the side and the matmul precision settings."""
    from micformer_tpu_torch.kernels import ATTENTION_PATHS, reset_launches
    from micformer_tpu_torch.ops.attention import multi_head_attention
    from torch_port_attn_ref import chain_f64, f32_bound

    rng = np.random.default_rng(3)

    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    reset_launches()
    q, k, v = arr(64, 8, 4, 32), arr(64, 8, 4, 32), arr(64, 8, 4, 32)
    multi_head_attention(*(t.to(cuda_device) for t in (q, k, v)))
    multi_head_attention(*(t.to(cuda_device) for t in (q, k, v)), fused=True)
    assert ATTENTION_PATHS == {"k1": 1, "k2": 1, "matmul": 0}
    assert LAUNCHES["window_attention"] == 1 and LAUNCHES["fused_window_attention"] == 1
    q, k, v, bias = arr(16, 64, 3, 32), arr(16, 64, 3, 32), arr(16, 64, 3, 32), arr(3, 64, 64)
    ids = torch.from_numpy(rng.integers(0, 4, (4, 64)).astype(np.int32))
    want = multi_head_attention(q, k, v, bias=bias, mask=ids)
    got = multi_head_attention(*(t.to(cuda_device) for t in (q, k, v)),
                               bias=bias.to(cuda_device), mask=ids.to(cuda_device))
    multi_head_attention(*(t.to(cuda_device) for t in (q, k, v)))
    assert ATTENTION_PATHS == {"k1": 1, "k2": 1, "matmul": 3}
    assert LAUNCHES["window_attention"] == 1 and LAUNCHES["fused_window_attention"] == 1
    settings = (f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, float32 matmul "
                f"precision {torch.get_float32_matmul_precision()}, blas "
                f"{torch.backends.cuda.preferred_blas_library()}")
    ref, bound = chain_f64(q, k, v, bias, ids)[0], f32_bound(q, k, v, bias, ids)
    for side, out in (("card", got.cpu()), ("cpu", want)):
        ratio = ((out.double() - ref).abs() / bound).max().item()
        assert ratio <= 1, f"{side}: {ratio:.3g} of the f32 bound from f64 ({settings})"
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5, msg=lambda m: f"{m} "
                               f"({settings})")


@pytest.mark.cuda
def test_swinunet3d_forward_launches_k3_on_card(cuda_device):
    """A narrow SwinUnet3D forward at 32³ launches 14 K3 (seven stages, two
    convs each; the pure sibling none) and matches its CPU run. Its window 4
    clamps at the 2³ and 1³ stages (down4, features, up4: 10 blocks of 8 and
    1 tokens, unbiased, which is K1's regime); the 8³ and 4³ stages' 8
    blocks take the plain chain."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.kernels import ATTENTION_PATHS, reset_launches

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 2, 32, 32, 32))
                         .astype(np.float32))
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, n in (("swinunet3d", 14), ("swinunet3d_pure", 0)):
            cpu = registry.build(name, device="cpu", hidden_dim=24, head_dim=8)
            card = registry.build(name, device=cuda_device, hidden_dim=24, head_dim=8)
            card.load_state_dict(cpu.state_dict())
            reset_launches()
            with torch.no_grad():
                got = card(x.to(cuda_device)).cpu()
                launches, paths = dict(LAUNCHES), dict(ATTENTION_PATHS)
                want = cpu(x)
            assert launches["dw_conv3"] == n and launches["window_attention"] == 10
            assert paths == {"k1": 10, "k2": 0, "matmul": 8}
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())
    finally:
        torch.backends.cudnn.allow_tf32 = True
