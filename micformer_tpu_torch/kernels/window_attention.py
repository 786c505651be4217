"""Tiny-window attention: softmax(q·kᵀ·scale)·v per window and head.

Counterpart of `micformer_tpu/ops/pallas/window_attention_v2.py` (K1). The
forward kernel is `csrc/window_attention.cu`, the backward kernel
`csrc/window_attention_backward.cu` (their headers give the bounds and the
designs). `window_attention` is differentiable through a
`torch.autograd.Function` whose forward and backward are the two kernels;
when no gradient is asked for it calls the forward directly.

`window_attention` and `window_attention_backward` launch their kernels for
CUDA tensors and raise on what a kernel does not take; for CPU tensors they
compute `window_attention_reference` and `window_attention_backward_reference`,
the plain PyTorch versions the kernels are held against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from micformer_tpu_torch.kernels import LAUNCHES, _build

MAX_T = 16
HEAD_DIMS = (8, 16, 32, 64)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
        + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_fn(entry: str):
    """A C entry point of the backward library (`window_attention_backward`
    for K1, `fused_window_attention_backward` for K2)."""
    fn = getattr(_build.load("window_attention_backward"), entry)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_attention_backward(entry: str, q, k, v, g, dq, dk, dv, scale: float):
    """Launch the backward kernel on seven [N, T, h, d] views (q, g, dq with
    Tq tokens; k, v, dk, dv with Tk), each with a dense feature axis; the
    window, token and head strides are free. Raises if the launch fails."""
    N, Tq, h, d = q.shape
    strides = [s for t in (q, k, v, g, dq, dk, dv) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _backward_fn(entry)(
            *(t.data_ptr() for t in (q, k, v, g, dq, dk, dv)), N, Tq, k.shape[1], h, d,
            (ctypes.c_longlong * 21)(*strides), scale, DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed (cudaError {err})")


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


def _forward(q, k, v, scale):
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, scale)
    _check_card(q, k)
    N, Tq, h, d = q.shape
    rows = [_row_stride(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    out = torch.empty((N, Tq, h, d), dtype=q.dtype, device=q.device)
    if N == 0:
        return out
    s = d ** -0.5 if scale is None else float(scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _forward_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            N, Tq, k.shape[1], h, d, *rows, s, DTYPE_CODES[q.dtype],
                            stream)
    if err != 0:
        raise RuntimeError(f"window_attention: kernel launch failed (cudaError {err})")
    LAUNCHES["window_attention"] += 1
    return out


def window_attention_backward(q, k, v, g, scale=None):
    """(dq, dk, dv) of window_attention(q, k, v, scale) for the output
    gradient g [N, Tq, h, d]; contiguous, in the inputs' dtype.

    CUDA tensors: the regime of the forward kernel, any strides with a dense
    feature axis; anything else raises."""
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
    d = q.shape[-1]
    s = d ** -0.5 if scale is None else float(scale)
    launch_attention_backward("window_attention_backward", q, k, v, g, dq, dk, dv, s)
    LAUNCHES["window_attention_backward"] += 1
    return dq, dk, dv


class _WindowAttention(torch.autograd.Function):
    """K1 forward, K1 backward; the plain versions for CPU tensors."""

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
        return (*window_attention_backward(q, k, v, g.to(q.dtype), ctx.scale), None)


def window_attention(q, k, v, scale=None):
    """softmax(q·kᵀ·scale)·v over [N, T, h, d] windows; scale defaults to d^-0.5.
    Differentiable in q, k and v.

    CUDA tensors: Tq, Tk <= 16, d in {8, 16, 32, 64}, float32 or bfloat16;
    anything else raises."""
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _WindowAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)       # no gradient asked for, as in serving
