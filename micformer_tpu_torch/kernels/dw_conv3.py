"""Depthwise k³ convolution, stride 1, SAME zero padding k//2.

Counterpart of `micformer_tpu/ops/pallas/dw_stencil.py` (`dw_conv3_pallas`),
on the port's channels-first layout: x [B, C, D, H, W] contiguous and w the
Conv3d depthwise weight [C, 1, k, k, k]. The CUDA kernel is
`csrc/dw_conv3.cu` (its header gives the bound and the design). Forward
only: its backward comes with the MedNeXt training slice, and until then a
CUDA call that autograd would need to differentiate raises. An optional
per-channel bias is added before the one rounding of the output, so the
caller makes no second pass.

`dw_conv3` launches the kernel for CUDA tensors and raises on what the kernel
does not take; for CPU tensors it computes `dw_conv3_reference`, the plain
PyTorch version the kernel is held against.
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


def dw_conv3(x, w, bias=None):
    """Depthwise k³ conv, stride 1, zero padding k//2, plus bias if given.

    x [B, C, D, H, W] contiguous, w [C, 1, k, k, k] with k in {3, 5}, bias
    [C] or None, all float32 or all bfloat16; anything else raises. Returns
    [B, C, D, H, W] in x's dtype."""
    _check(x, w, bias)
    if x.device.type == "cpu":
        return dw_conv3_reference(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"dw_conv3: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        raise NotImplementedError(
            "dw_conv3: the CUDA kernel has no backward yet (it comes with the "
            "MedNeXt training slice); call it under torch.no_grad()")
    B, C, D, H, W = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _forward_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(),
                 out.data_ptr(), B * C, C, D, H, W, w.shape[-1],
                 _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dw_conv3: kernel launch failed (cudaError {err})")
    LAUNCHES["dw_conv3"] += 1
    return out
