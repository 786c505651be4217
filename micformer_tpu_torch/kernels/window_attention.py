"""Tiny-window attention: softmax(q·kᵀ·scale)·v per window and head.

Counterpart of `micformer_tpu/ops/pallas/window_attention_v2.py` (K1). The
forward kernel is `csrc/window_attention.cu`, the backward kernel
`csrc/window_attention_backward.cu` (their headers give the bounds and the
designs). The forward is the PyTorch custom op
`micformer_tpu_torch::window_attention`, so `torch.export` captures it as one
node of the graph; its real implementation is `_forward`. `window_attention`
is differentiable through a `torch.autograd.Function` whose forward is the
op and whose backward is the backward kernel; when no gradient is asked for
it calls the op directly.

`window_attention` and `window_attention_backward` launch their kernels for
CUDA tensors and raise on what a kernel does not take; for CPU tensors they
compute `window_attention_reference` and `window_attention_backward_reference`,
the plain PyTorch versions the kernels are held against.

Both kernels stage tiles of W windows x Hg heads in shared memory and compute
on one of two routes, which `_attn_route` picks from the shapes, dtype and
alignment alone: "mma" (tensor-core mma.sync products; bf16, Tq = Tk = 8,
d a multiple of 16, every row 16-byte aligned: the MicFormer paths) or
"ffma" (f32 products on the CUDA cores: everything else). `_attn_plan` gives
the tile plan, which the C entry points check and launch one block a tile;
each launch adds one to `ROUTES[kernel][route]` beside `LAUNCHES[kernel]`,
inside the span `k1.forward.<route>` or `k1.backward.<route>` of a profiler's
trace (`SPANS`). A route the inputs cannot take makes the launch fail and
the wrapper raise; nothing falls back to the plain versions. The fused window attention K2
(`kernels/fused_window_attention.py`) runs the same tile kernels through
entries of its own, planned by `_attn_plan(..., fused=True)` and counted in
`ROUTES` too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from micformer_tpu_torch.kernels import CALLS, LAUNCHES, _build
from micformer_tpu_torch.tracing import span

MAX_T = 16
HEAD_DIMS = (8, 16, 32, 64)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
ROUTE_NAMES = ("mma", "ffma")                    # C route codes 0, 1
# launches of each kernel of the window-tile family (K1, K2 and their
# backwards) by route, beside LAUNCHES
ROUTES: dict[str, dict[str, int]] = {name: dict.fromkeys(ROUTE_NAMES, 0)
                                     for name in ("window_attention",
                                                  "window_attention_backward",
                                                  "fused_window_attention",
                                                  "fused_window_attention_backward")}

# a block has at most 4 warps and 48 KB of shared memory (csrc/attn_tile.cuh)
# and takes one tile of about _PAIRS[backward] (window, head) pairs: on the
# H100 the fastest tiles at the paths' stage shapes
_SMEM_BLOCK = 48 * 1024
_MAX_WARPS = 4
_WARP_TILE_BYTES = 1024     # backward mma route: a warp's P and dS matrices
_PAIRS = {False: 12, True: 6}   # forward, backward


# the kernels' spans by route (`tracing.span`): from the route's choice to
# the launch (an unknown route's span is the bare kernel's, and the plan
# raises)
SPANS: dict[str, dict[str, str]] = {kind: {r: f"k1.{kind}.{r}" for r in ROUTE_NAMES}
                                    for kind in ("forward", "backward")}


def reset_routes() -> None:
    for counts in ROUTES.values():
        for route in counts:
            counts[route] = 0


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _attn_route(Tq: int, Tk: int, d: int, dtype, aligned: bool) -> str:
    """The route of both K1 kernels: "mma" for bf16 with Tq = Tk = 8, d a
    multiple of 16 and every address and stride 16-byte aligned, else
    "ffma"."""
    if dtype not in _ELEMENT_BYTES or d not in HEAD_DIMS or not (
            1 <= Tq <= MAX_T and 1 <= Tk <= MAX_T):
        raise ValueError(f"window_attention: no route for Tq={Tq} Tk={Tk} d={d} {dtype}")
    if dtype == torch.bfloat16 and Tq == Tk == 8 and d % 16 == 0 and aligned:
        return "mma"
    return "ffma"


def _pitch_bytes(Hg: int, d: int, es: int) -> int:
    """Bytes between staged rows of Hg * d elements: their 16-byte chunks,
    made odd (csrc/attn_tile.cuh `pitch_bytes`)."""
    return ((Hg * d * es // 16) | 1) * 16


def _attn_smem(W: int, Hg: int, Tq: int, Tk: int, d: int, dtype, route: str,
               backward: bool, warps: int, fused: bool = False) -> int:
    """Shared memory of a block, as the C entries count it (their
    `window_attention_forward_smem` and `window_attention_backward_smem`
    queries, and K2's; a card test holds them equal): the staged operands'
    rows of d features (q, k, v; the backward adds g), then the backward's
    per-warp tiles (mma) or f32 P and dS rows (ffma; K2's `fused` rows Tk
    made odd floats apart)."""
    pitch = _pitch_bytes(Hg, d, _ELEMENT_BYTES[dtype])
    rows = W * (2 * Tq + 2 * Tk) if backward else W * (Tq + 2 * Tk)
    extra = 0
    if backward:
        p_pitch = Tk | 1 if fused else Tk
        extra = warps * _WARP_TILE_BYTES if route == "mma" else W * Hg * Tq * p_pitch * 8
    return rows * pitch + extra


def _attn_warps(W: int, Hg: int, Tq: int, Tk: int, route: str) -> int:
    """Warps a block: one per two (window, head) pairs (mma) or per 32 rows
    (ffma), at most 4."""
    work = _ceil_div(W * Hg, 2) if route == "mma" else _ceil_div(W * Hg * max(Tq, Tk), 32)
    return max(1, min(_MAX_WARPS, work))


def _attn_tiles(N: int, h: int, W: int, Hg: int) -> int:
    """Tiles of W windows x Hg heads over N windows of h heads: the grid,
    one block a tile."""
    return _ceil_div(N, W) * (h // Hg)


@functools.cache
def _attn_plan(N: int, Tq: int, Tk: int, h: int, d: int, dtype, route: str,
               backward: bool, sms: int, fused: bool = False) -> tuple[int, int, int]:
    """The tile plan of a kernel of the window-tile family, as the C entries
    take it: (W, Hg, warps). A tile is W windows x Hg heads (Hg divides h).

    Hg starts at h (or the largest divisor whose one-window tile fits 48 KB
    of shared memory) and W at the windows that give about _PAIRS[backward]
    pairs a tile, within 48 KB; where that gives fewer tiles than the card's
    `sms` SMs, W falls to 1 and then Hg through the divisors of h until the
    tiles cover the SMs (or Hg is 1). `fused` (K2, T = Tq = Tk up to 32; d
    the staged width): about _PAIRS[backward] * 8 / T pairs a tile, the
    shared memory of `_attn_smem(..., fused=True)`; a single pair that needs
    more than 48 KB is a tile of its own (its entry opts in)."""
    if route not in ROUTE_NAMES:
        raise ValueError(f"window_attention: unknown route {route!r}")

    def smem(W, Hg):
        return _attn_smem(W, Hg, Tq, Tk, d, dtype, route, backward,
                          _attn_warps(W, Hg, Tq, Tk, route), fused)

    pairs = max(1, _PAIRS[backward] * 8 // Tq) if fused else _PAIRS[backward]
    divisors = [g for g in range(h, 0, -1) if h % g == 0]
    Hg = next((g for g in divisors if smem(1, g) <= _SMEM_BLOCK), 1)
    W = max(1, min(N, pairs // Hg))
    while W > 1 and (smem(W, Hg) > _SMEM_BLOCK or _attn_tiles(N, h, W, Hg) < sms):
        W -= 1
    Hg = next(g for g in divisors if g <= Hg and (_attn_tiles(N, h, W, g) >= sms or g == 1))
    return W, Hg, _attn_warps(W, Hg, Tq, Tk, route)


@functools.cache
def _sms(device: torch.device) -> int:
    """The streaming multiprocessors of a card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def window_attention_reference(q, k, v, scale=None):
    """Plain PyTorch version: f32 logits, softmax and PV, cast back to q.dtype.

    q: [N, Tq, h, d]; k, v: [N, Tk, h, d]. Returns [N, Tq, h, d]."""
    d = q.shape[-1]
    s = d ** -0.5 if scale is None else scale
    qf, kf, vf = q.float() * s, k.float(), v.float()
    logits = torch.einsum("nqhd,nkhd->nhqk", qf, kf)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", p, vf).to(q.dtype)


def window_attention_backward_reference(q, k, v, g, scale=None):
    """Plain PyTorch version of the gradient (the `_v2_bwd` math): f32
    throughout, each gradient cast back to its input's dtype.

    q, g: [N, Tq, h, d]; k, v: [N, Tk, h, d]. Returns (dq, dk, dv)."""
    d = q.shape[-1]
    s = d ** -0.5 if scale is None else scale
    qf, kf, vf, gf = q.float() * s, k.float(), v.float(), g.float()
    p = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", qf, kf), dim=-1)
    dv = torch.einsum("nhqk,nqhd->nkhd", p, gf)
    dp = torch.einsum("nqhd,nkhd->nhqk", gf, vf)
    dlogits = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("nhqk,nkhd->nqhd", dlogits, kf) * s
    dk = torch.einsum("nhqk,nqhd->nkhd", dlogits, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _forward_fn():
    """The forward kernel's C entry point, with its signature set once."""
    fn = _build.load("window_attention").window_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 3 + [ctypes.c_float] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_fn(entry: str):
    """A C entry point of the backward library: `window_attention_backward`
    (K1) or `fused_window_attention_backward` (K2); each takes a route and a
    tile plan after the dtype."""
    fn = getattr(_build.load("window_attention_backward"), entry)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_attention_backward(entry: str, q, k, v, g, dq, dk, dv, scale: float,
                              plan: tuple):
    """Launch a backward kernel on seven [N, T, h, d] views (q, g, dq with
    Tq tokens; k, v, dk, dv with Tk), each with a dense feature axis; the
    window, token and head strides are free. `plan`: the route code and the
    tile plan (W, Hg, warps). Raises if the launch fails."""
    N, Tq, h, d = q.shape
    strides = [s for t in (q, k, v, g, dq, dk, dv) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _backward_fn(entry)(
            *(t.data_ptr() for t in (q, k, v, g, dq, dk, dv)), N, Tq, k.shape[1], h, d,
            (ctypes.c_longlong * 21)(*strides), scale, DTYPE_CODES[q.dtype], *plan, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed (cudaError {err})")


def _aligned(*ts) -> bool:
    """Every address and every window, token and head stride of these
    tensors a multiple of 16 bytes."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3])
               for t in ts)


def _row_stride(x: torch.Tensor, name: str) -> int:
    """Elements between token rows; the window and token axes must collapse
    to that one stride and the head and feature axes must be dense."""
    N, T, h, d = x.shape
    sn, st, sh, sd = x.stride()
    if sd != 1 or sh != d or (N > 1 and sn != T * st) or st < h * d:
        raise ValueError(f"window_attention: {name} layout {tuple(x.stride())} "
                         f"for shape {tuple(x.shape)} is not supported (needs "
                         "dense [h, d] rows at one token row stride)")
    if x.data_ptr() % 16 or (st * x.element_size()) % 16:
        raise ValueError(f"window_attention: {name} rows are not 16-byte aligned")
    return st


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("window_attention: q, k, v must be [N, T, h, d]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"window_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("window_attention: q, k, v dtypes differ")
    if not (q.device == k.device == v.device):
        raise ValueError("window_attention: q, k, v devices differ")


def _check_card(q, k):
    """What both K1 kernels take on the card; raises otherwise."""
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    Tq, d, Tk = q.shape[1], q.shape[3], k.shape[1]
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"window_attention: dtype {q.dtype} not supported")
    if d not in HEAD_DIMS or not (1 <= Tq <= MAX_T and 1 <= Tk <= MAX_T):
        raise ValueError(f"window_attention: T <= {MAX_T} and d in {HEAD_DIMS} "
                         f"required, got Tq={Tq} Tk={Tk} d={d}")


def _forward(q, k, v, scale, route=None):
    """The forward: the plain version for CPU tensors, else the kernel on
    `route` (default `_attn_route`'s)."""
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, scale)
    _check_card(q, k)
    N, Tq, h, d = q.shape
    Tk = k.shape[1]
    route = route or _attn_route(Tq, Tk, d, q.dtype, True)   # _row_stride checks alignment
    with span(SPANS["forward"].get(route, "k1.forward")):
        rows = [_row_stride(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"))]
        out = torch.empty((N, Tq, h, d), dtype=q.dtype, device=q.device)
        if N == 0:
            return out
        plan = _attn_plan(N, Tq, Tk, h, d, q.dtype, route, False, _sms(q.device))
        s = d ** -0.5 if scale is None else float(scale)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = _forward_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                N, Tq, Tk, h, d, *rows, s, DTYPE_CODES[q.dtype],
                                ROUTE_NAMES.index(route), *plan, stream)
        if err != 0:
            raise RuntimeError(f"window_attention: kernel launch failed on route {route} "
                               f"(cudaError {err})")
        LAUNCHES["window_attention"] += 1
        ROUTES["window_attention"][route] += 1
        return out


def window_attention_backward(q, k, v, g, scale=None):
    """(dq, dk, dv) of window_attention(q, k, v, scale) for the output
    gradient g [N, Tq, h, d]; contiguous, in the inputs' dtype.

    CUDA tensors: the regime of the forward kernel, any strides with a dense
    feature axis; anything else raises."""
    return _backward(q, k, v, g, scale)


def _backward(q, k, v, g, scale, route=None):
    """The backward: the plain version for CPU tensors, else the kernel on
    `route` (default `_attn_route`'s)."""
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"window_attention_backward: g {tuple(g.shape)} {g.dtype} "
                         f"does not match q {tuple(q.shape)} {q.dtype}")
    if q.device.type == "cpu":
        return window_attention_backward_reference(q, k, v, g, scale)
    _check_card(q, k)
    q, k, v, g = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, g))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if q.shape[0] == 0:
        return dq, dk, dv
    N, Tq, h, d = q.shape
    Tk = k.shape[1]
    route = route or _attn_route(Tq, Tk, d, q.dtype, _aligned(q, k, v, g, dq, dk, dv))
    with span(SPANS["backward"].get(route, "k1.backward")):
        plan = _attn_plan(N, Tq, Tk, h, d, q.dtype, route, True, _sms(q.device))
        s = d ** -0.5 if scale is None else float(scale)
        launch_attention_backward("window_attention_backward", q, k, v, g, dq, dk, dv, s,
                                  (ROUTE_NAMES.index(route), *plan))
        LAUNCHES["window_attention_backward"] += 1
        ROUTES["window_attention_backward"][route] += 1
        return dq, dk, dv


@torch.library.custom_op("micformer_tpu_torch::window_attention", mutates_args=())
def window_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None) -> torch.Tensor:
    """The forward as a custom op: `_forward`, its result contiguous as the
    kernel writes it."""
    return _forward(q, k, v, scale).contiguous()


@window_attention_op.register_fake
def _(q, k, v, scale):
    return q.new_empty(q.shape)


class _WindowAttention(torch.autograd.Function):
    """K1 forward, K1 backward; the plain versions for CPU tensors."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return window_attention_op(q, k, v, scale)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*window_attention_backward(q, k, v, g.to(q.dtype), ctx.scale), None)


def window_attention(q, k, v, scale=None):
    """softmax(q·kᵀ·scale)·v over [N, T, h, d] windows; scale defaults to d^-0.5.
    Differentiable in q, k and v.

    CUDA tensors: Tq, Tk <= 16, d in {8, 16, 32, 64}, float32 or bfloat16;
    anything else raises."""
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention: unsupported device {q.device}")
    CALLS["window_attention"] += 1
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _WindowAttention.apply(q, k, v, scale)
    return window_attention_op(q, k, v, scale)   # no gradient asked for, as in serving
