"""Batched multi-head attention for the many-windows, few-tokens regime.

Counterpart of `micformer_tpu/ops/attention.py`. The head axis lives inside
the token layout: q is [N, Tq, h, d] and k, v are [N, Tk, h, d], and
split_heads / merge_heads are pure reshapes.
"""

from __future__ import annotations

import torch

from micformer_tpu_torch.kernels.window_attention import window_attention


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         bias=None, mask=None, scale: float | None = None
                         ) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over batched windows; scale defaults to d^-0.5.

    CUDA tensors run the window-attention kernel, CPU tensors its plain
    version. Returns [N, Tq, h, d] in q's dtype."""
    if bias is not None or mask is not None:
        raise NotImplementedError("multi_head_attention: the biased and masked "
                                  "variants are not ported yet")
    return window_attention(q, k, v, scale)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[N, T, C] -> [N, T, h, C//h], a pure reshape."""
    N, T, C = x.shape
    return x.reshape(N, T, num_heads, C // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[N, T, h, d] -> [N, T, h*d], a pure reshape."""
    N, T, h, d = x.shape
    return x.reshape(N, T, h * d)
