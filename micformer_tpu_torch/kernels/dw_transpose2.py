"""Stride-2 transposed depthwise k³ conv of MedNeXt's default up block,
[B, C, L...] -> [B, C, 2L...], and its gradient.

`DepthwiseConv3D(transpose2=True)` computes the conv with `transpose2_conv`:
`F.conv_transpose3d` on the spatially flipped weight at padding k//2 - 1,
cut to exactly 2L per axis (cuDNN's grouped dgrad kernel). When a gradient
is asked for it runs through `dw_transpose2`, a `torch.autograd.Function`
whose forward is that same call and whose backward takes dx from cuDNN
(`aten.convolution_backward` with only the input's mask set, on the
zero-padded gradient that the cut's backward builds) and dw and db from
the kernel `csrc/dw_transpose2_wgrad.cu` (its header gives the bound and
the design). Serving, predict and export run the plain call and never
enter the Function.

`dw_transpose2_wgrad` launches the kernel for CUDA tensors and raises on
what it does not take; for CPU tensors it computes
`dw_transpose2_wgrad_reference`, the plain version the kernel is held
against. A launch reads g on one of two routes, which `_dwt2_route` picks
from the shape and alignment alone: "vector" (16-byte loads; L_W a
multiple of 4, x and g 16-byte aligned) or "scalar" (element loads). Each
launch adds one to `LAUNCHES["dw_transpose2_wgrad"]` and to
`ROUTES[route]`, inside the span `dwt2.wgrad.<route>` of a profiler's
trace. A route the inputs cannot take makes the launch fail and the
wrapper raise; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from micformer_tpu_torch.kernels import LAUNCHES, _build
from micformer_tpu_torch.tracing import span

KERNEL_SIZES = (3, 5)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTE_NAMES = ("vector", "scalar")              # C route codes 0, 1
ROUTES: dict[str, int] = dict.fromkeys(ROUTE_NAMES, 0)
SPANS: dict[str, str] = {r: f"dwt2.wgrad.{r}" for r in ROUTE_NAMES}


def reset_routes() -> None:
    for route in ROUTES:
        ROUTES[route] = 0


def _dwt2_route(x_shape, *data_ptrs: int) -> str:
    """"vector" when L_W is a multiple of 4 and every address 16-byte
    aligned, else "scalar"."""
    if x_shape[-1] % 4 or any(p % 16 for p in data_ptrs):
        return "scalar"
    return "vector"


def transpose2_conv(x, w, bias=None):
    """The stride-2 transposed depthwise conv, exactly 2L per axis, as plain
    cuDNN calls: `F.conv_transpose3d` on the flipped weight at padding
    k//2 - 1 yields dilate-and-pad (k//2 + 1, k//2) plus one extra plane per
    axis (2L + 1 for odd k), and the cut keeps 2L. Returns a view of the
    conv's output."""
    D, H, W = x.shape[2:]
    y = F.conv_transpose3d(x, w.flip((2, 3, 4)), bias, stride=2,
                           padding=w.shape[-1] // 2 - 1, groups=x.shape[1])
    return y[:, :, :2 * D, :2 * H, :2 * W]


def dw_transpose2_wgrad_reference(x, g, k: int):
    """Plain PyTorch version of the weight and bias gradient: for each tap
    t = (tz, ty, tx), dw[c, t] is the sum over (b, q) of x[b, c, q] times
    g[b, c, 2q - t + k//2 + 1] per axis (zero outside g), taps in
    (tz, ty, tx) order; db[c] the sum of g. Summed in f32 (f64 for f64
    inputs).

    x [B, C, L_D, L_H, L_W], g [B, C, 2L_D, 2L_H, 2L_W]. Returns
    (dw [C, 1, k, k, k], db [C])."""
    B, C, D, H, W = x.shape
    p = k // 2
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, gf = x.to(acc), g.to(acc)
    # g padded by p + 1 on each side: tap t of x[q] reads padded 2q + 2p + 2 - t
    gp = F.pad(gf, (p + 1,) * 6)
    axes = (0, 2, 3, 4)
    taps = []
    for tz in range(k):
        for ty in range(k):
            for tx in range(k):
                z, y, w = (2 * p + 2 - t for t in (tz, ty, tx))
                gs = gp[:, :, z:z + 2 * D:2, y:y + 2 * H:2, w:w + 2 * W:2]
                taps.append((xf * gs).sum(axes))
    return torch.stack(taps, dim=1).view(C, 1, k, k, k), gf.sum(axes)


@functools.cache
def _wgrad_fns():
    """The library's C entry points (scratch size, launch), with their
    signatures set once."""
    lib = _build.load("dw_transpose2_wgrad")
    size = lib.dw_transpose2_wgrad_scratch
    size.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    fn = lib.dw_transpose2_wgrad
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return size, fn


def dw_transpose2_wgrad(x, g, k: int):
    """f32 (dw [C, 1, k, k, k], db [C]) of the stride-2 transposed
    depthwise conv of x (module weight, exactly 2L per axis) for the output
    gradient g, summed in f32.

    x [B, C, L_D, L_H, L_W] contiguous, float32 or bfloat16 (on the CPU
    float64 too); g contiguous [B, C, 2L_D, 2L_H, 2L_W] in x's dtype and
    device; k in {3, 5}; anything else raises. CUDA tensors: one launch of
    the kernel (and its fixed-order reduce); CPU tensors:
    `dw_transpose2_wgrad_reference`."""
    dtypes = tuple(_DTYPE_CODES) + ((torch.float64,) if x.device.type == "cpu" else ())
    if x.dim() != 5 or k not in KERNEL_SIZES or x.dtype not in dtypes or not x.is_contiguous():
        raise ValueError(f"dw_transpose2_wgrad: x must be a contiguous [B, C, D, H, W] tensor "
                         f"of {dtypes} and k in {KERNEL_SIZES}, got {tuple(x.shape)} "
                         f"{x.dtype}, k {k}")
    want = tuple(x.shape[:2]) + tuple(2 * s for s in x.shape[2:])
    if (tuple(g.shape) != want or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous()):
        raise ValueError(f"dw_transpose2_wgrad: g must be contiguous {want} {x.dtype} on "
                         f"{x.device}, got {tuple(g.shape)} {g.dtype} on {g.device}")
    if x.device.type == "cpu":
        return dw_transpose2_wgrad_reference(x, g, k)
    if x.device.type != "cuda":
        raise ValueError(f"dw_transpose2_wgrad: unsupported device {x.device}")
    return _wgrad(x, g, k)


def _wgrad(x, g, k: int, route: str | None = None):
    """The launch for checked CUDA tensors, on `_dwt2_route`'s route unless
    `route` names one."""
    B, C, D, H, W = x.shape
    if x.numel() == 0:
        return (torch.zeros((C, 1, k, k, k), dtype=torch.float32, device=x.device),
                torch.zeros((C,), dtype=torch.float32, device=x.device))
    route = route or _dwt2_route(x.shape, x.data_ptr(), g.data_ptr())
    if route not in ROUTE_NAMES:
        raise ValueError(f"dw_transpose2_wgrad: unknown route {route!r}")
    with span(SPANS[route]):
        size, fn = _wgrad_fns()
        n = size(B * C, C, D, H, W, k)
        if n < 0:
            raise RuntimeError(f"dw_transpose2_wgrad: shape {tuple(x.shape)}, k {k} not taken")
        # the kernel writes every element of dw, db and the scratch
        dw = torch.empty((C, 1, k, k, k), dtype=torch.float32, device=x.device)
        db = torch.empty((C,), dtype=torch.float32, device=x.device)
        scratch = torch.empty((n,), dtype=torch.float64, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(),
                     scratch.data_ptr(), B * C, C, D, H, W, k, _DTYPE_CODES[x.dtype],
                     ROUTE_NAMES.index(route), stream)
        if err != 0:
            raise RuntimeError(f"dw_transpose2_wgrad: kernel launch failed on route {route} "
                               f"(cudaError {err})")
        LAUNCHES["dw_transpose2_wgrad"] += 1
        ROUTES[route] += 1
        return dw, db


class _DwTranspose2(torch.autograd.Function):
    """The forward's cuDNN call; dx from cuDNN, dw and db from
    `dw_transpose2_wgrad`, each only where autograd asks for it."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w, bias):
        y = transpose2_conv(x, w, bias)
        # what the conv ran on: under autocast its cast of x and w, as
        # autograd saves them for the plain call
        ctx.save_for_backward(x.to(y.dtype), w.to(y.dtype))
        ctx.y_shape = y.shape[:2] + tuple(2 * s + 1 for s in x.shape[2:])   # before the cut
        ctx.dtypes = (x.dtype, w.dtype, None if bias is None else bias.dtype)
        return y

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        x_dt, w_dt, b_dt = ctx.dtypes
        g = g.contiguous()
        dx = dw = db = None
        if need_x:
            gp = g.new_zeros(ctx.y_shape)
            gp[:, :, :g.shape[2], :g.shape[3], :g.shape[4]] = g
            # the forward's conv: stride 2, padding k//2 - 1, dilation 1,
            # transposed, output padding 0
            dx = torch.ops.aten.convolution_backward(
                gp, x, w.flip((2, 3, 4)), None, [2] * 3, [w.shape[-1] // 2 - 1] * 3, [1] * 3,
                True, [0] * 3, x.shape[1], [True, False, False])[0].to(x_dt)
        if need_w or need_b:
            dw, db = dw_transpose2_wgrad(x.contiguous(), g, w.shape[-1])
            dw = dw.to(w_dt) if need_w else None
            db = db.to(b_dt) if need_b else None
        return dx, dw, db


def dw_transpose2(x, w, bias=None):
    """The stride-2 transposed depthwise conv of `DepthwiseConv3D`, exactly
    2L per axis, through the Function: differentiable in x, w and bias, with
    dw and db from `dw_transpose2_wgrad`.

    x [B, C, L_D, L_H, L_W]; w the module's weight [C, 1, k, k, k] with k in
    {3, 5}; bias [C] or None; one dtype, as `F.conv_transpose3d` takes them
    (under autocast, its casts). Returns [B, C, 2L_D, 2L_H, 2L_W], a view of
    the conv's output."""
    k = w.shape[-1]
    if k not in KERNEL_SIZES or tuple(w.shape) != (x.shape[1], 1, k, k, k):
        raise ValueError(f"dw_transpose2: w must be [C, 1, k, k, k] with C = {x.shape[1]} "
                         f"and k in {KERNEL_SIZES}, got {tuple(w.shape)}")
    return _DwTranspose2.apply(x, w, bias)
