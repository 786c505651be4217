"""Batched multi-head attention for the many-windows, few-tokens regime.

Counterpart of `micformer_tpu/ops/attention.py`. The head axis lives inside
the token layout: q is [N, Tq, h, d] and k, v are [N, Tk, h, d], and
split_heads / merge_heads are pure reshapes.

`multi_head_attention` dispatches by regime, as the JAX function does: the
unbiased, unmasked tiny-window regime (Tq, Tk <= 16), which the JAX package
runs through its window-attention kernels, goes to K1 (or K2 under
fused=True); anything with a bias, a mask or more tokens, which the JAX
package computes with XLA, goes to `attention_chain`, the plain chain of
its einsums, on either device. `kernels.ATTENTION_PATHS` counts each call's
path.
"""

from __future__ import annotations

import torch

from micformer_tpu_torch.kernels import ATTENTION_PATHS
from micformer_tpu_torch.kernels.fused_window_attention import (
    fused_window_attention, should_use_fused,
)
from micformer_tpu_torch.kernels.window_attention import MAX_T, window_attention

MASK_VALUE = -100.0     # the Swin convention for token pairs of two regions


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         bias=None, mask=None, scale: float | None = None,
                         fused: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias + mask)·v over batched windows; scale
    defaults to d^-0.5. Returns [N, Tq, h, d] in q's dtype.

    bias: [h, Tq, Tk], broadcast over N. mask: [nW, Tq, Tk] additive, or
    [nW, T] region ids (pairs of unequal ids get MASK_VALUE), applied per
    window position with nW dividing N.

    Unbiased and unmasked with Tq, Tk <= 16: K1 (`window_attention`: the
    kernel for CUDA tensors, its plain version for CPU tensors), or with
    fused=True, where `should_use_fused` holds (equal token counts on a CUDA
    tensor), K2 on [N, h, T, d] views of the operands. Everything else:
    `attention_chain`."""
    Tq, d = q.shape[1], q.shape[3]
    if bias is None and mask is None and Tq <= MAX_T and k.shape[1] <= MAX_T:
        if fused and Tq == k.shape[1] and should_use_fused(Tq, d, bias, mask, q.device):
            ATTENTION_PATHS["k2"] += 1
            out = fused_window_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), scale)
            return out.transpose(1, 2)
        ATTENTION_PATHS["k1"] += 1
        return window_attention(q, k, v, scale)
    ATTENTION_PATHS["matmul"] += 1
    return attention_chain(q, k, v, bias=bias, mask=mask, scale=scale)


def attention_chain(q, k, v, *, bias=None, mask=None, scale=None) -> torch.Tensor:
    """The JAX package's XLA chain, step by step: logits in f32 for f32
    inputs and in the input dtype otherwise, the bias and the mask added,
    the max-subtracted exp stored in v's dtype, its row sums in f32, the PV
    product, then the divide by the sums. Same arguments as
    multi_head_attention."""
    N, Tq, h, d = q.shape
    s = d ** -0.5 if scale is None else scale
    acc = torch.float32 if q.dtype == torch.float32 else q.dtype
    attn = torch.einsum("nqhd,nkhd->nhqk", q.to(acc) * s, k.to(acc))
    if bias is not None:
        attn = attn + bias.to(acc)[None]
    if mask is not None:
        nW = mask.shape[0]
        if mask.dim() == 2:
            mask = torch.where(mask[:, :, None] == mask[:, None, :],
                               torch.zeros((), dtype=acc, device=mask.device),
                               torch.full((), MASK_VALUE, dtype=acc, device=mask.device))
        attn = (attn.reshape(N // nW, nW, h, Tq, -1) + mask.to(acc)[None, :, None]
                ).reshape(N, h, Tq, -1)
    m = attn.amax(-1, keepdim=True).detach()
    p = torch.exp(attn - m).to(v.dtype)
    denom = p.float().sum(-1, keepdim=True)
    out = torch.einsum("nhqk,nkhd->nqhd", p, v)
    return (out / denom.transpose(1, 2).to(v.dtype)).to(q.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[N, T, C] -> [N, T, h, C//h], a pure reshape."""
    N, T, C = x.shape
    return x.reshape(N, T, num_heads, C // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[N, T, h, d] -> [N, T, h*d], a pure reshape."""
    N, T, h, d = x.shape
    return x.reshape(N, T, h * d)
