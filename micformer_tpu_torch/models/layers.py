"""The building blocks of MicFormer, on channels-last [B, D, H, W, C] tensors.

Counterpart of the subset of `micformer_tpu/models/layers.py` that MicFormer
uses: Mlp, DropPath, WindowAttention3D (self and cross, no relative-position
bias), the unshifted SwinBlock3D, PatchEmbed3D, PatchMergingConv,
PatchExpandConv and pad_to_multiple. The JAX package's lane-major and
via-dot forms are TPU layouts of the same math; this is the plain math.
Convolutions take the channels-first view of the channels-last tensor.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from micformer_tpu_torch.ops.attention import (
    merge_heads, multi_head_attention, split_heads,
)
from micformer_tpu_torch.ops.windows import (
    adjust_window_shift, window_partition, window_reverse,
)

LN_EPS = 1e-5


def conv_cl(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv3d / ConvTranspose3d to channels-last [B, D, H, W, C]."""
    return conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


def pad_to_multiple(x: torch.Tensor, multiple) -> torch.Tensor:
    """Zero-pad the spatial dims of [B, D, H, W, C] up to multiples."""
    B, D, H, W, C = x.shape
    pd, ph, pw = ((-s) % m for s, m in zip((D, H, W), multiple))
    if pd or ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))
    return x


class Mlp(nn.Module):
    """Linear -> exact GELU -> Linear."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class DropPath(nn.Module):
    """Stochastic depth on a residual branch: identity in eval mode; in train
    mode each sample is kept with probability 1 - rate (and scaled by
    1 / keep), drawn from the caller's generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        dev = generator.device if generator is not None else x.device
        mask = torch.rand(shape, generator=generator, device=dev).to(x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class WindowAttention3D(nn.Module):
    """Windowed multi-head attention over [N, T, C] token windows.

    cross=False: fused qkv projection (split into thirds). cross=True: q from
    x, k and v from `context` through one kv projection (k is the first
    half)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 cross: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.cross = cross
        if cross:
            self.q = nn.Linear(dim, dim, bias=qkv_bias)
            self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        else:
            self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, context=None):
        h = self.num_heads
        if self.cross:
            q = self.q(x)
            k, v = self.kv(x if context is None else context).chunk(2, dim=-1)
        else:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        out = multi_head_attention(split_heads(q, h), split_heads(k, h),
                                   split_heads(v, h))
        return self.proj(merge_heads(out))


class SwinBlock3D(nn.Module):
    """Pre-norm window transformer block without shift or bias (MicFormer's
    TransformerBlock3D): x + attn(LN(x)), then x + mlp(LN(x))."""

    def __init__(self, dim: int, num_heads: int, window_size=(4, 4, 4),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0):
        super().__init__()
        self.window_size = tuple(window_size)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention3D(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator=None):
        B, D, H, W, C = x.shape
        ws = adjust_window_shift((D, H, W), self.window_size)
        xn = pad_to_multiple(self.norm1(x), ws)
        _, Dp, Hp, Wp, _ = xn.shape
        a = self.attn(window_partition(xn, ws))
        a = window_reverse(a, ws, B, Dp, Hp, Wp)[:, :D, :H, :W]
        x = x + self.drop_path(a, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class PatchEmbed3D(nn.Module):
    """Patch embedding: conv with kernel = stride = patch, optional LN."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size=(4, 4, 4),
                 use_norm: bool = True):
        super().__init__()
        self.proj = nn.Conv3d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS) if use_norm else None

    def forward(self, x):
        x = conv_cl(self.proj, x)
        return x if self.norm is None else self.norm(x)


class PatchMergingConv(nn.Module):
    """Downsample C -> 2C: conv k2 s2, then LN."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv3d(dim, 2 * dim, 2, stride=2)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x):
        return self.norm(conv_cl(self.conv, x))


class PatchExpandConv(nn.Module):
    """Upsample C -> C/2: transposed conv k2 s2, then LN."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose3d(dim, dim // 2, 2, stride=2)
        self.norm = nn.LayerNorm(dim // 2, eps=LN_EPS)

    def forward(self, x):
        return self.norm(conv_cl(self.conv, x))
