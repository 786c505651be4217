"""Batched multi-head attention for the many-windows, few-tokens regime.

Counterpart of `micformer_tpu/ops/attention.py`. The head axis lives inside
the token layout: q is [N, Tq, h, d] and k, v are [N, Tk, h, d], and
split_heads / merge_heads are pure reshapes.
"""

from __future__ import annotations

import torch

from micformer_tpu_torch.kernels.fused_window_attention import (
    fused_window_attention, should_use_fused,
)
from micformer_tpu_torch.kernels.window_attention import window_attention


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         bias=None, mask=None, scale: float | None = None,
                         fused: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over batched windows; scale defaults to d^-0.5.

    fused=True is the counterpart of the JAX package's
    MICFORMER_FUSED_ATTENTION=1: where `should_use_fused` holds (equal token
    counts on a CUDA tensor), the fused kernel K2 takes [N, h, T, d] views of
    the operands and its result comes back as an [N, T, h, d] view.
    Otherwise CUDA tensors run the window-attention kernel K1, CPU tensors
    its plain version. Returns [N, Tq, h, d] in q's dtype."""
    if bias is not None or mask is not None:
        raise NotImplementedError("multi_head_attention: the biased and masked "
                                  "variants are not ported yet")
    Tq, d = q.shape[1], q.shape[3]
    if fused and Tq == k.shape[1] and should_use_fused(Tq, d, bias, mask, q.device):
        out = fused_window_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), scale)
        return out.transpose(1, 2)
    return window_attention(q, k, v, scale)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[N, T, C] -> [N, T, h, C//h], a pure reshape."""
    N, T, C = x.shape
    return x.reshape(N, T, num_heads, C // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[N, T, h, d] -> [N, T, h*d], a pure reshape."""
    N, T, h, d = x.shape
    return x.reshape(N, T, h * d)
