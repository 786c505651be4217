"""Fused window attention on [N, h, T, d]: softmax(q·kᵀ·scale)·v per window
and head.

Counterpart of `micformer_tpu/ops/pallas/window_attention.py` (K2,
`fused_window_attention` and its dispatch predicate `should_use_fused`). The
forward kernel is `csrc/fused_window_attention.cu`; the backward is the
entry `fused_window_attention_backward` of `csrc/window_attention_backward.cu`,
the kernel of K1's gradient instantiated for T <= 32 and K2's strides. Their
headers give the bounds and the designs. `fused_window_attention` is
differentiable through a `torch.autograd.Function` whose forward and backward
are the two kernels; when no gradient is asked for it calls the forward
directly.

For CUDA tensors the wrappers launch their kernels and raise on what a kernel
does not take; for CPU tensors they compute `fused_window_attention_reference`
and `fused_window_attention_backward_reference`, the plain PyTorch versions
the kernels are held against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from micformer_tpu_torch.kernels import LAUNCHES, _build
from micformer_tpu_torch.kernels.window_attention import (
    DTYPE_CODES, launch_attention_backward,
)

BLOCK_ROWS = 128
MAX_T = 32
MAX_D = 128


def should_use_fused(T: int, d: int, bias, mask, device) -> bool:
    """Dispatch predicate: unbiased, unmasked windows of T <= 32 tokens with
    128 % T == 0 and d <= 128, on a CUDA tensor (the JAX predicate asks for a
    TPU backend instead)."""
    if bias is not None or mask is not None:
        return False
    if T > MAX_T or d > MAX_D or BLOCK_ROWS % T != 0:
        return False
    return torch.device(device).type == "cuda"


def fused_window_attention_reference(q, k, v, scale=None):
    """Plain PyTorch version: f32 logits and softmax, normalised before the
    PV product as the TPU kernel does, cast back to q.dtype.

    q, k, v: [N, h, T, d]. Returns [N, h, T, d]."""
    d = q.shape[-1]
    s = d ** -0.5 if scale is None else scale
    p = torch.softmax(torch.einsum("nhqd,nhkd->nhqk", q.float() * s, k.float()), dim=-1)
    return torch.einsum("nhqk,nhkd->nhqd", p, v.float()).to(q.dtype)


def fused_window_attention_backward_reference(q, k, v, g, scale=None):
    """Plain PyTorch version of the gradient (the `_bwd` math): f32
    throughout, each gradient cast back to its input's dtype.

    q, k, v, g: [N, h, T, d]. Returns (dq, dk, dv)."""
    d = q.shape[-1]
    s = d ** -0.5 if scale is None else scale
    qf, kf, vf, gf = q.float() * s, k.float(), v.float(), g.float()
    p = torch.softmax(torch.einsum("nhqd,nhkd->nhqk", qf, kf), dim=-1)
    dv = torch.einsum("nhqk,nhqd->nhkd", p, gf)
    dp = torch.einsum("nhqd,nhkd->nhqk", gf, vf)
    dlogits = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("nhqk,nhkd->nhqd", dlogits, kf) * s
    dk = torch.einsum("nhqk,nhqd->nhkd", dlogits, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _forward_fn():
    """The forward kernel's C entry point, with its signature set once."""
    fn = _build.load("fused_window_attention").fused_window_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"fused_window_attention: q, k, v must be one [N, h, T, d] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("fused_window_attention: q, k, v dtypes differ")
    if not (q.device == k.device == v.device):
        raise ValueError("fused_window_attention: q, k, v devices differ")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_window_attention: unsupported device {q.device}")


def _check_card(*ts):
    """What both K2 kernels take on the card; raises otherwise."""
    q = ts[0]
    T, d = q.shape[2], q.shape[3]
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"fused_window_attention: dtype {q.dtype} not supported")
    if not (1 <= T <= MAX_T and BLOCK_ROWS % T == 0 and 1 <= d <= MAX_D):
        raise ValueError(f"fused_window_attention: T <= {MAX_T} dividing {BLOCK_ROWS} "
                         f"and d <= {MAX_D} required, got T={T} d={d}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("fused_window_attention: the feature axis must be dense, got "
                         f"strides {[tuple(t.stride()) for t in ts]}")


def _empty_like_layout(x):
    """An empty [N, h, T, d] tensor whose storage order follows x: token-major
    ([N, T, h, d] underneath) when x is a head-inside-token view, so the
    caller's transpose back to [N, T, h, d] is contiguous."""
    N, h, T, d = x.shape
    if x.stride(1) < x.stride(2):
        return torch.empty((N, T, h, d), dtype=x.dtype, device=x.device).transpose(1, 2)
    return torch.empty((N, h, T, d), dtype=x.dtype, device=x.device)


def _forward(q, k, v, scale):
    if q.device.type == "cpu":
        return fused_window_attention_reference(q, k, v, scale)
    _check_card(q, k, v)
    N, h, T, d = q.shape
    out = _empty_like_layout(q)
    if N * h == 0:
        return out
    s = d ** -0.5 if scale is None else float(scale)
    # each as (window, token, head) strides
    strides = [x.stride()[i] for x in (q, k, v, out) for i in (0, 2, 1)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _forward_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            N, h, T, d, (ctypes.c_longlong * 12)(*strides), s,
                            DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_window_attention: kernel launch failed (cudaError {err})")
    LAUNCHES["fused_window_attention"] += 1
    return out


def fused_window_attention_backward(q, k, v, g, scale=None):
    """(dq, dk, dv) of fused_window_attention(q, k, v, scale) for the output
    gradient g [N, h, T, d], in the inputs' dtype; each gradient is laid out
    as `_empty_like_layout` of its input.

    CUDA tensors: the forward kernel's contract; anything else raises."""
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"fused_window_attention_backward: g {tuple(g.shape)} "
                         f"{g.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    if q.device.type == "cpu":
        return fused_window_attention_backward_reference(q, k, v, g, scale)
    if g.stride(-1) != 1:
        g = g.contiguous()
    _check_card(q, k, v, g)
    dq, dk, dv = (_empty_like_layout(x) for x in (q, k, v))
    if q.shape[0] * q.shape[1] == 0:
        return dq, dk, dv
    s = q.shape[-1] ** -0.5 if scale is None else float(scale)
    # the kernel reads [N, T, h, d] views: the transposes are free
    launch_attention_backward("fused_window_attention_backward",
                              *(x.transpose(1, 2) for x in (q, k, v, g, dq, dk, dv)), s)
    LAUNCHES["fused_window_attention_backward"] += 1
    return dq, dk, dv


class _FusedWindowAttention(torch.autograd.Function):
    """K2 forward, K2 backward; the plain versions for CPU tensors."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*fused_window_attention_backward(q, k, v, g.to(q.dtype), ctx.scale), None)


def fused_window_attention(q, k, v, scale=None):
    """softmax(q·kᵀ·scale)·v per window and head on [N, h, T, d]; scale
    defaults to d^-0.5. Differentiable in q, k and v.

    CUDA tensors: T <= 32 with 128 % T == 0, d <= 128, a dense feature axis
    (any other strides), float32 or bfloat16; anything else raises. The
    result is laid out as `_empty_like_layout(q)`."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedWindowAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)       # no gradient asked for, as in serving
