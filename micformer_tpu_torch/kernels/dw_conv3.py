"""Depthwise k³ convolution, stride 1, SAME zero padding k//2.

Counterpart of `micformer_tpu/ops/pallas/dw_stencil.py` (`dw_conv3_pallas`
and its custom VJP), on the port's channels-first layout: x [B, C, D, H, W]
contiguous and w the Conv3d depthwise weight [C, 1, k, k, k]. An optional
per-channel bias is added before the one rounding of the output, so the
caller makes no second pass.

`dw_conv3` is differentiable through a `torch.autograd.Function`: the
forward is the kernel `csrc/dw_conv3.cu`; the backward takes dx from the same
kernel on the spatially flipped weight (as `_bwd` does) and dw and db from
the kernel `csrc/dw_conv3_wgrad.cu` (their headers give the bounds and the
designs). When no gradient is asked for, as in serving, it calls the forward
directly.

`dw_conv3`, `dw_conv3_backward` and `dw_conv3_wgrad` launch their kernels
for CUDA tensors and raise on what a kernel does not take; for CPU tensors
they compute `dw_conv3_reference`, `dw_conv3_backward_reference` and
`dw_conv3_wgrad_reference`, the plain PyTorch versions the kernels are held
against.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from micformer_tpu_torch.kernels import LAUNCHES, _build

KERNEL_SIZES = (3, 5)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6 \
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
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dw_conv3: x, w and bias must be contiguous "
                         "(x in [B, C, D, H, W] order)")


@functools.cache
def _wgrad_fns():
    """The weight-gradient library's C entry points (scratch size, launch),
    with their signatures set once."""
    lib = _build.load("dw_conv3_wgrad")
    size = lib.dw_conv3_wgrad_scratch
    size.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    fn = lib.dw_conv3_wgrad
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return size, fn


def _forward(x, w, bias):
    """The K3 launch for checked CUDA tensors, the plain version for CPU
    ones."""
    if x.device.type == "cpu":
        return dw_conv3_reference(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"dw_conv3: unsupported device {x.device}")
    B, C, D, H, W = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _forward_fn()(x.data_ptr(), w.data_ptr(),
                            0 if bias is None else bias.data_ptr(), out.data_ptr(),
                            B * C, C, D, H, W, w.shape[-1], _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dw_conv3: kernel launch failed (cudaError {err})")
    LAUNCHES["dw_conv3"] += 1
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
    if x.device.type == "cpu":
        return dw_conv3_wgrad_reference(x, g, k)
    if x.device.type != "cuda":
        raise ValueError(f"dw_conv3_wgrad: unsupported device {x.device}")
    B, C, D, H, W = x.shape
    dw = torch.zeros((C, 1, k, k, k), dtype=torch.float32, device=x.device)
    db = torch.zeros((C,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dw, db
    size, fn = _wgrad_fns()
    n = size(B * C, C, D, H, W, k)
    if n < 0:
        raise ValueError(f"dw_conv3_wgrad: shape {tuple(x.shape)}, k {k} not supported")
    scratch = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(),
                 scratch.data_ptr(), B * C, C, D, H, W, k, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dw_conv3_wgrad: kernel launch failed (cudaError {err})")
    LAUNCHES["dw_conv3_wgrad"] += 1
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


class _DwConv3(torch.autograd.Function):
    """K3 forward; `dw_conv3_backward` for what autograd needs."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return _forward(x, w, bias)

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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return _DwConv3.apply(x, w, bias)
    return _forward(x, w, bias)           # no gradient asked for, as in serving
