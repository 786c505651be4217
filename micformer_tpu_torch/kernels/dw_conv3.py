"""Depthwise k³ convolution, stride 1, SAME zero padding k//2.

Counterpart of `micformer_tpu/ops/pallas/dw_stencil.py` (`dw_conv3_pallas`
and its custom VJP), on the port's channels-first layout: x [B, C, D, H, W]
contiguous and w the Conv3d depthwise weight [C, 1, k, k, k]. An optional
per-channel bias is added before the one rounding of the output, so the
caller makes no second pass.

The forward kernel `csrc/dw_conv3.cu` runs through the PyTorch custom op
`micformer_tpu_torch::dw_conv3`, so `torch.export` captures it as one node of
the graph; its real implementation is `_forward`. `dw_conv3` is
differentiable through a `torch.autograd.Function`: the forward is the op;
the backward takes dx from the same
kernel on the spatially flipped weight (as `_bwd` does) and dw and db from
the kernel `csrc/dw_conv3_wgrad.cu` (their headers give the bounds and the
designs). When no gradient is asked for, as in serving, it calls the forward
directly.

`dw_conv3`, `dw_conv3_backward` and `dw_conv3_wgrad` launch their kernels
for CUDA tensors and raise on what a kernel does not take; for CPU tensors
they compute `dw_conv3_reference`, `dw_conv3_backward_reference` and
`dw_conv3_wgrad_reference`, the plain PyTorch versions the kernels are held
against.

Both kernels stage x in one of three routes, which `_dw_route` picks from
the shape, dtype and alignment alone: "tma" (TMA boxes of halo'd planes),
"volume" (one TMA box of whole volumes when D, H, W <= 16) and "cp_async"
(cp.async copies where TMA cannot describe x). `_dw_plan` gives the route's
launch geometry, which the C entry points check; each launch adds one to
`ROUTES[kernel][route]` beside `LAUNCHES[kernel]`. A route the inputs cannot
take makes the launch fail and the wrapper raise; nothing falls back to the
plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from micformer_tpu_torch.kernels import CALLS, LAUNCHES, _build

KERNEL_SIZES = (3, 5)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
ROUTE_NAMES = ("tma", "volume", "cp_async")      # C route codes 0, 1, 2
# launches of each kernel by route, beside LAUNCHES
ROUTES: dict[str, dict[str, int]] = {name: dict.fromkeys(ROUTE_NAMES, 0)
                                     for name in ("dw_conv3", "dw_conv3_wgrad")}

# the plans are sized for an H100: 132 SMs; a block has at most 256 threads;
# at k = 3 a thread keeps under 128 registers, so an SM holds 512 of them,
# at k = 5 (125 weights in registers) 256
_SMS = 132
_THREADS = 256
_VW = 8                     # W-adjacent outputs per thread (csrc/dw_stage.cuh kVW)
_VOLUME_MAX = 16            # the volume route takes D, H, W up to this
_VOLUME_SMEM = 96 * 1024    # volumes per block are cut to fit this


def reset_routes() -> None:
    for counts in ROUTES.values():
        for route in counts:
            counts[route] = 0


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_ceil(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def _rows_per_thread(k: int) -> int:
    return 2 if k == 3 else 1


def _dw_route(shape, dtype, k: int, *data_ptrs: int) -> str:
    """The staging route of both kernels for x (and g) of this shape and
    dtype at these addresses: "cp_async" unless TMA can describe every
    tensor (each address 16-byte aligned, W * element size a multiple of 16
    bytes), else "volume" when D, H and W are all at most 16, else "tma"."""
    if dtype not in _ELEMENT_BYTES or k not in KERNEL_SIZES or len(shape) != 5:
        raise ValueError(f"dw_conv3: no route for shape {tuple(shape)}, {dtype}, k {k}")
    D, H, W = shape[2:]
    if any(p % 16 for p in data_ptrs) or (W * _ELEMENT_BYTES[dtype]) % 16:
        return "cp_async"
    return "volume" if max(D, H, W) <= _VOLUME_MAX else "tma"


def _dw_plan(shape, dtype, k: int, route: str) -> tuple[int, int, int]:
    """The launch geometry of `route` for x of this shape, as the C entry
    points take it.

    "tma" and "cp_async": (bx, by, D chunk). A block of bx x by threads
    (a multiple of 32) owns a tile of by * VH rows and bx * 8 columns of one
    volume (VH 2 at k = 3, 1 at k = 5) and walks a chunk of D; the chunk,
    of 32, 16 or 8 planes, is the one whose waves of blocks times planes
    staged per block (chunk + k - 1) is least.
    "volume": (threads per volume, volumes per block, 0): a power of two of
    threads for each volume's cells, and as many volumes a block as fit in
    256 threads and 96 KB, cut until the grid has 2 blocks per SM."""
    B, C, D, H, W = shape
    n_vol, es, p, vh = B * C, _ELEMENT_BYTES[dtype], k // 2, _rows_per_thread(k)
    if route == "volume":
        nwc, nhc = _ceil_div(W, _VW), _ceil_div(H, vh)
        tpv = min(_pow2_ceil(nwc * nhc * D), _THREADS)
        a = 16 // es                    # staged columns left of the volume
        box = _ceil_div(a + nwc * _VW + p, a) * a * (nhc * vh + 2 * p) * (D + 2 * p) * es
        g = max(1, _THREADS // tpv)
        while g > 1 and (_ceil_div(n_vol, g) < 2 * _SMS or g * box > _VOLUME_SMEM):
            g -= 1
        return tpv, g, 0
    if route not in ROUTE_NAMES:
        raise ValueError(f"dw_conv3: unknown route {route!r}")
    bx = min(_pow2_ceil(_ceil_div(W, _VW)), 16)
    by = min(_THREADS // bx, _ceil_div(H, vh), 64)
    by = _ceil_div(by, max(1, 32 // bx)) * max(1, 32 // bx)
    tiles = n_vol * _ceil_div(H, by * vh) * _ceil_div(W, bx * _VW)
    slots = _SMS * max(1, (512 if k == 3 else 256) // (bx * by))
    best = None
    for chunk in sorted({min(c, D) for c in (32, 16, 8)}, reverse=True):
        cost = _ceil_div(tiles * _ceil_div(D, chunk), slots) * (chunk + 2 * p)
        if best is None or cost < best[0]:
            best = (cost, chunk)
    return bx, by, best[1]


# f32 weight gradients sum in D chunks of at most this many planes, so each
# thread's chain of f32 adds stays short (csrc/dw_conv3_wgrad.cu, accuracy)
_F32_WGRAD_CHUNK = 8


def _wgrad_plan(shape, dtype, k: int, route: str) -> tuple[int, int, int]:
    """The weight-gradient kernel's plan: `_dw_plan`'s, with f32's D chunk
    cut to _F32_WGRAD_CHUNK planes."""
    plan = _dw_plan(shape, dtype, k, route)
    if route == "volume" or dtype != torch.float32:
        return plan
    return plan[0], plan[1], min(plan[2], _F32_WGRAD_CHUNK)


def _wgrad_scratch_size(shape, k: int, route: str, plan) -> int:
    """f64 scratch of the weight-gradient kernel for `plan`: k³ + 1 sums
    per (volume, tile, D chunk), or per volume on the volume route."""
    B, C, D, H, W = shape
    if route == "volume":
        parts = 1
    else:
        bx, by, chunk = plan
        parts = (_ceil_div(H, by * _rows_per_thread(k)) * _ceil_div(W, bx * _VW)
                 * _ceil_div(D, min(chunk, D)))
    return B * C * parts * (k ** 3 + 1)


def dw_conv3_reference(x, w, bias=None):
    """Plain PyTorch version: shift-and-add over the k³ taps of the
    zero-padded input, accumulated in f32 in (dz, dy, dx) order, bias added,
    rounded once to x.dtype.

    x: [B, C, D, H, W]; w: [C, 1, k, k, k]; bias: [C] or None."""
    B, C, D, H, W = x.shape
    k = w.shape[-1]
    p = k // 2
    xp = F.pad(x, (p,) * 6).float()
    wf = w.float().reshape(C, k, k, k)
    acc = torch.zeros((B, C, D, H, W), dtype=torch.float32, device=x.device)
    for dz in range(k):
        for dy in range(k):
            for dx in range(k):
                acc += (xp[:, :, dz:dz + D, dy:dy + H, dx:dx + W]
                        * wf[:, dz, dy, dx].view(1, C, 1, 1, 1))
    if bias is not None:
        acc += bias.float().view(1, C, 1, 1, 1)
    return acc.to(x.dtype)


def dw_conv3_wgrad_reference(x, g, k: int):
    """Plain PyTorch version of the weight and bias gradient, in the order
    of `_bwd`: dw[c, tap] is the f32 sum over (B, D, H, W) of g times x
    shifted by the tap (zero padded), taps in (dz, dy, dx) order; db[c] the
    f32 sum of g.

    x, g: [B, C, D, H, W]. Returns f32 (dw [C, 1, k, k, k], db [C])."""
    B, C, D, H, W = x.shape
    p = k // 2
    xp = F.pad(x, (p,) * 6).float()
    gf = g.float()
    axes = (0, 2, 3, 4)
    taps = [(xp[:, :, dz:dz + D, dy:dy + H, dx:dx + W] * gf).sum(axes)
            for dz in range(k) for dy in range(k) for dx in range(k)]
    return torch.stack(taps, dim=1).view(C, 1, k, k, k), gf.sum(axes)


def dw_conv3_backward_reference(x, w, g):
    """Plain PyTorch version of the gradient: dx is the plain forward on g
    with the spatially flipped weight, in x's dtype; dw and db are
    `dw_conv3_wgrad_reference` in w's dtype.

    x, g: [B, C, D, H, W]; w: [C, 1, k, k, k]. Returns (dx, dw, db)."""
    dx = dw_conv3_reference(g, w.flip((2, 3, 4)))
    dw, db = dw_conv3_wgrad_reference(x, g, w.shape[-1])
    return dx, dw.to(w.dtype), db.to(w.dtype)


@functools.cache
def _forward_fn():
    """The kernel's C entry point, with its signature set once."""
    fn = _build.load("dw_conv3").dw_conv3_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w, bias):
    if x.dim() != 5:
        raise ValueError(f"dw_conv3: x must be [B, C, D, H, W], got {tuple(x.shape)}")
    C = x.shape[1]
    k = w.shape[-1] if w.dim() == 5 else None
    if k not in KERNEL_SIZES or tuple(w.shape) != (C, 1, k, k, k):
        raise ValueError(f"dw_conv3: w must be [C, 1, k, k, k] with C = {C} and "
                         f"k in {KERNEL_SIZES}, got {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (C,):
        raise ValueError(f"dw_conv3: bias must be [{C}], got {tuple(bias.shape)}")
    tensors = (x, w) if bias is None else (x, w, bias)
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"dw_conv3: x, w and bias must share one dtype of "
                         f"{tuple(_DTYPE_CODES)}, got {[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("dw_conv3: x, w and bias devices differ")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dw_conv3: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dw_conv3: x, w and bias must be contiguous "
                         "(x in [B, C, D, H, W] order)")


@functools.cache
def _wgrad_fns():
    """The weight-gradient library's C entry points (scratch size, launch),
    with their signatures set once."""
    lib = _build.load("dw_conv3_wgrad")
    size = lib.dw_conv3_wgrad_scratch
    size.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 10
    size.restype = ctypes.c_longlong
    fn = lib.dw_conv3_wgrad
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return size, fn


def _forward(x, w, bias, route: str | None = None):
    """The K3 launch for checked CUDA tensors, on `_dw_route`'s route
    unless `route` names one; the plain version for CPU ones."""
    if x.device.type == "cpu":
        return dw_conv3_reference(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"dw_conv3: unsupported device {x.device}")
    B, C, D, H, W = x.shape
    k = w.shape[-1]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    route = route or _dw_route(x.shape, x.dtype, k, x.data_ptr())
    plan = _dw_plan(x.shape, x.dtype, k, route)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _forward_fn()(x.data_ptr(), w.data_ptr(),
                            0 if bias is None else bias.data_ptr(), out.data_ptr(),
                            B * C, C, D, H, W, k, _DTYPE_CODES[x.dtype],
                            ROUTE_NAMES.index(route), *plan, stream)
    if err != 0:
        raise RuntimeError(f"dw_conv3: kernel launch failed on route {route} "
                           f"(cudaError {err})")
    LAUNCHES["dw_conv3"] += 1
    ROUTES["dw_conv3"][route] += 1
    return out


def _check_grad(x, g):
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"dw_conv3 backward: g {tuple(g.shape)} {g.dtype} {g.device} "
                         f"does not match x {tuple(x.shape)} {x.dtype} {x.device}")
    if not g.is_contiguous():
        raise ValueError("dw_conv3 backward: g must be contiguous")


def dw_conv3_wgrad(x, g, k: int):
    """f32 (dw [C, 1, k, k, k], db [C]) of a depthwise k³ conv of x for the
    output gradient g, summed in f32.

    x [B, C, D, H, W] contiguous, float32 or bfloat16, g contiguous in x's
    shape, dtype and device, k in {3, 5}; anything else raises. CUDA
    tensors: one launch of the weight-gradient kernel (and its fixed-order
    reduce); CPU tensors: `dw_conv3_wgrad_reference`."""
    if (x.dim() != 5 or k not in KERNEL_SIZES or x.dtype not in _DTYPE_CODES
            or not x.is_contiguous()):
        raise ValueError(f"dw_conv3_wgrad: x must be a contiguous [B, C, D, H, W] tensor of "
                         f"{tuple(_DTYPE_CODES)} and k in {KERNEL_SIZES}, got "
                         f"{tuple(x.shape)} {x.dtype}, k {k}")
    _check_grad(x, g)
    return _wgrad(x, g, k)


def _wgrad(x, g, k: int, route: str | None = None):
    """The weight-gradient launch for checked CUDA tensors, on
    `_dw_route`'s route for x and g unless `route` names one; the plain
    version for CPU ones."""
    if x.device.type == "cpu":
        return dw_conv3_wgrad_reference(x, g, k)
    if x.device.type != "cuda":
        raise ValueError(f"dw_conv3_wgrad: unsupported device {x.device}")
    B, C, D, H, W = x.shape
    dw = torch.zeros((C, 1, k, k, k), dtype=torch.float32, device=x.device)
    db = torch.zeros((C,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dw, db
    route = route or _dw_route(x.shape, x.dtype, k, x.data_ptr(), g.data_ptr())
    args = (B * C, C, D, H, W, k, _DTYPE_CODES[x.dtype], ROUTE_NAMES.index(route),
            *_wgrad_plan(x.shape, x.dtype, k, route))
    size, fn = _wgrad_fns()
    n = size(*args)
    if n < 0:
        raise RuntimeError(f"dw_conv3_wgrad: shape {tuple(x.shape)}, k {k} not taken "
                           f"on route {route}")
    scratch = torch.empty((n,), dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(),
                 scratch.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"dw_conv3_wgrad: kernel launch failed on route {route} "
                           f"(cudaError {err})")
    LAUNCHES["dw_conv3_wgrad"] += 1
    ROUTES["dw_conv3_wgrad"][route] += 1
    return dw, db


def dw_conv3_backward(x, w, g, need_dx: bool = True, need_dwb: bool = True):
    """(dx, dw, db) of dw_conv3(x, w, bias) for the output gradient g
    [B, C, D, H, W]: dx in x's dtype, dw [C, 1, k, k, k] and db [C] in w's
    (summed in f32); dx is None unless need_dx, dw and db None unless
    need_dwb. The autograd Function's backward is this function.

    Takes what dw_conv3 takes, with g contiguous in x's shape and dtype;
    anything else raises. CUDA tensors: dx is a K3 launch on the flipped
    weight, dw and db `dw_conv3_wgrad`; CPU tensors: the plain versions."""
    _check(x, w, None)
    _check_grad(x, g)
    dx = _forward(g, w.flip((2, 3, 4)).contiguous(), None) if need_dx else None
    dw = db = None
    if need_dwb:
        dw, db = dw_conv3_wgrad(x, g, w.shape[-1])
        dw, db = dw.to(w.dtype), db.to(w.dtype)
    return dx, dw, db


@torch.library.custom_op("micformer_tpu_torch::dw_conv3", mutates_args=())
def dw_conv3_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The forward as a custom op: `_forward` on checked tensors."""
    return _forward(x, w, bias)


@dw_conv3_op.register_fake
def _(x, w, bias):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


class _DwConv3(torch.autograd.Function):
    """K3 forward; `dw_conv3_backward` for what autograd needs."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return dw_conv3_op(x, w, bias)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        need_b = need_b and ctx.has_bias
        dx, dw, db = dw_conv3_backward(x, w, g.to(x.dtype).contiguous(), need_x,
                                       need_w or need_b)
        return dx, dw if need_w else None, db if need_b else None


def dw_conv3(x, w, bias=None):
    """Depthwise k³ conv, stride 1, zero padding k//2, plus bias if given;
    differentiable in x, w and bias.

    x [B, C, D, H, W] contiguous, w [C, 1, k, k, k] with k in {3, 5}, bias
    [C] or None, all float32 or all bfloat16; anything else raises. Returns
    [B, C, D, H, W] in x's dtype."""
    _check(x, w, bias)
    CALLS["dw_conv3"] += 1
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return _DwConv3.apply(x, w, bias)
    return dw_conv3_op(x, w, bias)        # no gradient asked for, as in serving
