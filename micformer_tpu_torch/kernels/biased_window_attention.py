"""Biased window attention: softmax(q·kᵀ·scale + bias + mask)·v per window
and head, for windows of up to 512 tokens.

It replaces no TPU kernel: the JAX package computes biased and masked window
attention with XLA (`micformer_tpu/ops/attention.py`), and the port's mirror
of that chain, `ops.attention.attention_chain`, passes the [N, h, T, T]
scores through device memory about ten times. The kernel,
`csrc/biased_window_attention.cu`, keeps them in registers; it is bound by
its exponentials, one a score, and its header gives the design: a block
stages one head's bias rows of a query tile in shared memory once and walks
its windows, each window's K and V staged whole, with an online softmax in
f32 on the fragments of `mma.sync` products.

The forward is the PyTorch custom op
`micformer_tpu_torch::biased_window_attention`, so `torch.export` captures it
as one node of the graph; its real implementation is `_forward`. There is no
backward: `ops.attention.multi_head_attention` routes here only calls that
need no gradient (`should_use_bwa`), and the wrapper refuses the others.
For CUDA tensors the wrapper launches the kernel and raises on what it does
not take; for CPU tensors it computes `biased_window_attention_reference`,
the plain PyTorch version the kernel is held against. Each launch adds one to
`LAUNCHES["biased_window_attention"]` and to `ROUTES[route]`, the mask's kind
("ids", "additive" or "none"), inside the span `bwa.forward.<route>` of a
profiler's trace (`SPANS`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from micformer_tpu_torch.kernels import CALLS, LAUNCHES, _build
from micformer_tpu_torch.kernels.window_attention import _sms
from micformer_tpu_torch.tracing import span

MAX_T = 512
HEAD_DIMS = (16, 32)
DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
MASK_VALUE = -100.0     # the Swin convention for token pairs of two regions
ROUTE_NAMES = ("none", "ids", "additive")      # C mask kinds 0, 1, 2
ROUTES: dict[str, int] = dict.fromkeys(ROUTE_NAMES, 0)
# the kernel's spans by route (`tracing.span`): from the route's choice to the launch
SPANS: dict[str, str] = {r: f"bwa.forward.{r}" for r in ROUTE_NAMES}

_CHUNK = 32                 # keys a step of the kernel's online softmax
_MAX_WARPS = 16
_SMEM_OPT_IN = 232448       # the most a block may opt in to (227 KB)
_SMEM_SM = 233472           # an SM's shared memory (228 KB), 1 KB of it reserved a block
_SMEM_RESERVED = 1024


def reset_routes() -> None:
    for route in ROUTES:
        ROUTES[route] = 0


def should_use_bwa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias=None,
                   mask=None) -> bool:
    """Dispatch predicate of `multi_head_attention`: a CUDA tensor in bf16 or
    f16, no gradient asked for, Tq == Tk <= MAX_T and d in HEAD_DIMS."""
    if q.device.type != "cuda" or q.dtype not in DTYPE_CODES:
        return False
    if q.shape[1] != k.shape[1] or q.shape[1] > MAX_T or q.shape[3] not in HEAD_DIMS:
        return False
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in (q, k, v, bias, mask)))


def biased_window_attention_reference(q, k, v, bias=None, mask=None, scale=None):
    """Plain PyTorch version, with the kernel's arithmetic: logits and softmax
    in f32 (f64 for f64 inputs) from the bias and an additive mask in q's
    dtype, P rounded to q's dtype for the P·v product, the row sums of the
    unrounded P; the result in q's dtype.

    q, k, v: [N, T, h, d]; bias: [h, T, T]; mask: [nW, T] region ids or
    [nW, T, T] additive, window n taking mask[n % nW]. Returns [N, T, h, d]."""
    N, T, h, d = q.shape
    s = d ** -0.5 if scale is None else scale
    f = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("nqhd,nkhd->nhqk", q.to(f), k.to(f)) * s
    if bias is not None:
        logits = logits + bias.to(q.dtype).to(f)[None]
    if mask is not None:
        nW = mask.shape[0]
        if mask.dim() == 2:
            add = torch.where(mask[:, :, None] == mask[:, None, :],
                              torch.zeros((), dtype=f, device=mask.device),
                              torch.full((), MASK_VALUE, dtype=f, device=mask.device))
        else:
            add = mask.to(q.dtype).to(f)
        logits = (logits.reshape(N // nW, nW, h, T, T) + add[None, :, None]).reshape(N, h, T, T)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = torch.einsum("nhqk,nkhd->nqhd", p.to(q.dtype).to(f), v.to(f))
    return (out / p.sum(-1).transpose(1, 2)[..., None]).to(q.dtype).contiguous()


def _tokens_padded(T: int) -> int:
    """Keys staged a window: T up to whole chunks."""
    return -(-T // _CHUNK) * _CHUNK


def _bwa_smem(T: int, d: int, warps: int, bufs: int) -> int:
    """Shared memory of a block, as the C entry counts it (its
    `biased_window_attention_smem` query; a card test holds them equal): the
    tile's bias rows (16 warps rows of T padded + 8 elements), then `bufs`
    window buffers of the K and V rows (T padded), the tile's Q rows (rows of
    d elements at a pitch of an odd count of 16-byte chunks) and the ids."""
    tc, rows = _tokens_padded(T), 16 * warps
    pitch = ((d * 2 // 16) | 1) * 16
    return rows * (tc + 8) * 2 + bufs * ((2 * tc + rows) * pitch + tc * 4)


@functools.cache
def _bwa_plan(T: int, d: int) -> tuple[int, int, int]:
    """(warps, query tiles, window buffers) of a block at T tokens and d
    features: the fewest query tiles of 16 rows a warp (so the fewest padded
    rows), then two buffers before one, within the shared memory a block can
    opt in to."""
    rows = -(-T // 16)
    for tiles in range(-(-rows // _MAX_WARPS), rows + 1):
        warps = -(-rows // tiles)
        for bufs in (2, 1):
            if _bwa_smem(T, d, warps, bufs) <= _SMEM_OPT_IN:
                return warps, -(-rows // warps), bufs
    raise ValueError(f"biased_window_attention: no plan for T={T} d={d}")


@functools.cache
def _bwa_groups(N: int, h: int, T: int, d: int, sms: int) -> int:
    """Window groups G of the grid (h x query tiles x G blocks, block g
    walking windows g, g + G, ...): the G whose waves over the card's block
    slots take the fewest window steps, a step more a block for staging its
    bias rows; the fewer blocks on a tie."""
    warps, tiles, bufs = _bwa_plan(T, d)
    per_sm = min(_SMEM_SM // (_bwa_smem(T, d, warps, bufs) + _SMEM_RESERVED),
                 2048 // (32 * warps), 32)
    slots, pairs = sms * per_sm, h * tiles

    def steps(G):
        return math.ceil(pairs * G / slots) * (math.ceil(N / G) + 1)

    return min(range(1, min(N, 8 * slots) + 1), key=lambda G: (steps(G), G))


@functools.cache
def _forward_fn():
    """The kernel's C entry point, with its signature set once."""
    fn = _build.load("biased_window_attention").biased_window_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong, ctypes.c_int, ctypes.c_float] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _route(mask) -> str:
    return "none" if mask is None else "ids" if mask.dim() == 2 else "additive"


def _check(q, k, v, bias, mask):
    """What the wrapper takes on any device; raises otherwise."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"biased_window_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be one [N, T, h, d] shape (Tq == Tk)")
    N, T, h, d = q.shape
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("biased_window_attention: q, k, v dtypes or devices differ")
    if T > MAX_T or d not in HEAD_DIMS:
        raise ValueError(f"biased_window_attention: T <= {MAX_T} and d in {HEAD_DIMS} "
                         f"required, got T={T} d={d}")
    if bias is not None and tuple(bias.shape) != (h, T, T):
        raise ValueError(f"biased_window_attention: bias {tuple(bias.shape)}, want {(h, T, T)}")
    if mask is not None:
        if tuple(mask.shape[1:]) not in ((T,), (T, T)) or mask.shape[0] < 1:
            raise ValueError(f"biased_window_attention: mask {tuple(mask.shape)}, want "
                             f"[nW, {T}] region ids or [nW, {T}, {T}]")
        if N % mask.shape[0]:
            raise ValueError(f"biased_window_attention: {N} windows do not divide into "
                             f"the mask's {mask.shape[0]}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, bias, mask)):
        raise ValueError("biased_window_attention: no backward; a gradient was asked for")


def _forward(q, k, v, bias, mask, scale):
    """The forward: the plain version for CPU tensors, else the kernel."""
    if q.device.type == "cpu":
        return biased_window_attention_reference(q, k, v, bias, mask, scale)
    if q.device.type != "cuda" or q.dtype not in DTYPE_CODES:
        raise ValueError(f"biased_window_attention: {q.dtype} on {q.device} is not supported "
                         "(CUDA bf16 or f16)")
    route = _route(mask)
    with span(SPANS[route]):
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError("biased_window_attention: q, k, v need a dense feature axis")
        N, T, h, d = q.shape
        out = torch.empty((N, T, h, d), dtype=q.dtype, device=q.device)
        if N == 0:
            return out
        if bias is not None:
            bias = bias.to(q.dtype).contiguous()
        if mask is not None:
            mask = (mask.to(torch.int32) if mask.dim() == 2 else mask.to(q.dtype)).contiguous()
        warps, tiles, bufs = _bwa_plan(T, d)
        groups = _bwa_groups(N, h, T, d, _sms(q.device))
        strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in t.stride()[:3]))
        s = d ** -0.5 if scale is None else float(scale)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = _forward_fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(), N, T, h, d,
                strides, 1 if mask is None else mask.shape[0], ROUTE_NAMES.index(route), s,
                DTYPE_CODES[q.dtype], warps, tiles, groups, bufs, stream)
        if err != 0:
            raise RuntimeError(f"biased_window_attention: kernel launch failed (cudaError {err})")
        LAUNCHES["biased_window_attention"] += 1
        ROUTES[route] += 1
        return out


@torch.library.custom_op("micformer_tpu_torch::biased_window_attention", mutates_args=())
def biased_window_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor | None, mask: torch.Tensor | None,
                               scale: float | None) -> torch.Tensor:
    """The forward as a custom op: `_forward`, contiguous [N, T, h, d]."""
    return _forward(q, k, v, bias, mask, scale)


@biased_window_attention_op.register_fake
def _(q, k, v, bias, mask, scale):
    return q.new_empty(q.shape)


def biased_window_attention(q, k, v, bias=None, mask=None, scale=None):
    """softmax(q·kᵀ·scale + bias + mask)·v over [N, T, h, d] windows; scale
    defaults to d^-0.5. bias: [h, T, T]; mask: [nW, T] region ids (pairs of
    unequal ids get MASK_VALUE) or [nW, T, T] additive, window n taking
    mask[n % nW]. No gradient.

    Any device: T <= 512, d in {16, 32}, equal q, k, v shapes, nW dividing
    N, and no gradient asked for; CUDA tensors: bf16 or f16 with a dense
    feature axis. Anything else raises."""
    _check(q, k, v, bias, mask)
    CALLS["biased_window_attention"] += 1
    return biased_window_attention_op(q, k, v, bias, mask, scale)
