"""Tiny-window attention: softmax(q·kᵀ·scale)·v per window and head.

Counterpart of `micformer_tpu/ops/pallas/window_attention_v2.py`. The CUDA
kernel is `csrc/window_attention.cu` (its header gives the bound and the
design). Forward only: serving needs no gradient.

`window_attention` launches the kernel for CUDA tensors and raises on what the
kernel does not take; for CPU tensors it computes `window_attention_reference`,
the plain PyTorch version the kernel is held against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from micformer_tpu_torch.kernels import LAUNCHES, _build

MAX_T = 16
HEAD_DIMS = (8, 16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def window_attention_reference(q, k, v, scale=None):
    """Plain PyTorch version: f32 logits, softmax and PV, cast back to q.dtype.

    q: [N, Tq, h, d]; k, v: [N, Tk, h, d]. Returns [N, Tq, h, d]."""
    d = q.shape[-1]
    s = d ** -0.5 if scale is None else scale
    qf, kf, vf = q.float() * s, k.float(), v.float()
    logits = torch.einsum("nqhd,nkhd->nhqk", qf, kf)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", p, vf).to(q.dtype)


@functools.cache
def _forward_fn():
    """The kernel's C entry point, with its signature set once."""
    fn = _build.load("window_attention").window_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def window_attention(q, k, v, scale=None):
    """softmax(q·kᵀ·scale)·v over [N, T, h, d] windows; scale defaults to d^-0.5.

    CUDA tensors: Tq, Tk <= 16, d in {8, 16, 32, 64}, float32 or bfloat16;
    anything else raises."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    N, Tq, h, d = q.shape
    Tk = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"window_attention: dtype {q.dtype} not supported")
    if d not in HEAD_DIMS or not (1 <= Tq <= MAX_T and 1 <= Tk <= MAX_T):
        raise ValueError(f"window_attention: T <= {MAX_T} and d in {HEAD_DIMS} "
                         f"required, got Tq={Tq} Tk={Tk} d={d}")
    rows = [_row_stride(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    out = torch.empty((N, Tq, h, d), dtype=q.dtype, device=q.device)
    if N == 0:
        return out
    s = d ** -0.5 if scale is None else float(scale)
    fn = _forward_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), N,
                 Tq, Tk, h, d, *rows, s, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"window_attention: kernel launch failed "
                           f"(cudaError {err})")
    LAUNCHES["window_attention"] += 1
    return out
