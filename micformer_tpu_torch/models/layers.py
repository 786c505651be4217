"""The building blocks of MicFormer and MedNeXt.

Counterpart of the subsets of `micformer_tpu/models/layers.py` that the two
models use. The JAX package's lane-major, via-dot, blocked and W-packed
forms are TPU layouts of the same math; this is the plain math.

MicFormer's blocks work on channels-last [B, D, H, W, C] tensors: Mlp,
DropPath, WindowAttention3D (self and cross, no relative-position bias), the
unshifted SwinBlock3D, PatchEmbed3D, PatchMergingConv, PatchExpandConv and
pad_to_multiple. Their convolutions take the channels-first view.

MedNeXt's blocks work on channels-first [B, C, D, H, W] tensors, the layout
the depthwise kernel takes, in which cuDNN's strided and transposed convs,
the norm and GELU run natively and a 1³ conv is one GEMM per batch element:
InstanceNorm, DepthwiseConv3D, PointwiseConv, PointwiseTranspose2 and
zero_dilate. Their parameters have the shapes of the torch layers they
stand for, so `convert.from_flax` maps the flax tree onto them.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from micformer_tpu_torch.kernels.dw_conv3 import dw_conv3
from micformer_tpu_torch.ops.attention import (
    merge_heads, multi_head_attention, split_heads,
)
from micformer_tpu_torch.ops.windows import (
    adjust_window_shift, window_partition, window_reverse,
)

LN_EPS = 1e-5

# (first row, global batch size) of this rank's rows, inside batch_rows
_ROWS = contextvars.ContextVar("batch_rows", default=None)


@contextlib.contextmanager
def batch_rows(first: int, total: int):
    """Inside, DropPath draws its masks for a global batch of `total` rows
    and keeps the rows from `first` on: a data-parallel rank holding those
    rows draws what a single process draws for them."""
    token = _ROWS.set((first, total))
    try:
        yield
    finally:
        _ROWS.reset(token)


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
    1 / keep), drawn from the caller's generator (for the global batch
    inside `batch_rows`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        first, total = _ROWS.get() or (0, x.shape[0])
        shape = (total,) + (1,) * (x.dim() - 1)
        dev = generator.device if generator is not None else x.device
        mask = torch.rand(shape, generator=generator, device=dev).to(x.device) < keep
        mask = mask[first:first + x.shape[0]]
        return torch.where(mask, x / keep, torch.zeros_like(x))


class WindowAttention3D(nn.Module):
    """Windowed multi-head attention over [N, T, C] token windows.

    cross=False: fused qkv projection (split into thirds). cross=True: q from
    x, k and v from `context` through one kv projection (k is the first
    half). fused_attention selects `multi_head_attention(..., fused=True)`,
    the fused kernel K2 on the card."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 cross: bool = False, fused_attention: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.cross = cross
        self.fused_attention = fused_attention
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
                                   split_heads(v, h), fused=self.fused_attention)
        return self.proj(merge_heads(out))


class SwinBlock3D(nn.Module):
    """Pre-norm window transformer block without shift or bias (MicFormer's
    TransformerBlock3D): x + attn(LN(x)), then x + mlp(LN(x))."""

    def __init__(self, dim: int, num_heads: int, window_size=(4, 4, 4),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0, fused_attention: bool = False):
        super().__init__()
        self.window_size = tuple(window_size)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention3D(dim, num_heads, qkv_bias,
                                      fused_attention=fused_attention)
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


class InstanceNorm(nn.Module):
    """Affine instance norm of [B, C, *spatial] over the spatial axes
    (MedNeXt's GroupNorm with one group per channel). Statistics in f32 as the JAX
    default computes them, E[x²] − E[x]² clamped at 0; output in x's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        dims = tuple(range(2, x.dim()))
        n = math.prod(x.shape[2:])
        xf = x.float()
        mean = xf.sum(dims, keepdim=True) / n
        var = (xf.square().sum(dims, keepdim=True) / n - mean.square()).clamp_min(0.0)
        shape = (1, -1) + (1,) * len(dims)
        # ((x - mean) * rsqrt(var + eps)) * weight + bias as one pass over x
        # with per-(b, c) factors
        scale = torch.rsqrt(var + self.eps) * self.weight.float().view(shape)
        shift = self.bias.float().view(shape) - mean * scale
        return torch.addcmul(shift, xf, scale).to(x.dtype)


class DepthwiseConv3D(nn.Conv3d):
    """Depthwise k³ conv with bias on [B, C, D, H, W] (weight [C, 1, k, k, k]).

    Stride 1 with SAME padding k//2 runs the depthwise kernel (`dw_conv3`);
    stride 2 is cuDNN's grouped conv at padding k//2; `pad`, per axis
    (lo, hi), zero-pads first (a symmetric k//2 pad at stride 1 is the SAME
    conv and runs the kernel too); `transpose2` is the stride-2 transpose
    conv of MedNeXt's default up block, exactly 2L per axis:
    conv(zero_dilate(x), pad (k//2 + 1, k//2))."""

    def __init__(self, channels: int, kernel: int = 3, stride: int = 1,
                 pad=None, transpose2: bool = False):
        super().__init__(channels, channels, kernel, stride=stride, groups=channels)
        self.pad = None if pad is None else tuple(tuple(a) for a in pad)
        self.transpose2 = transpose2

    def forward(self, x):
        p, s = self.kernel_size[0] // 2, self.stride[0]
        # the parameters in x's dtype, as the JAX layer's w.astype(dtype): a
        # no-op when they already match, and under autocast over f32
        # parameters the cast's backward hands them f32 gradients
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype)
        if self.transpose2:
            # conv_transpose3d at padding p-1 with the flipped kernel yields
            # dilate-and-pad (p+1, p) plus one extra plane per axis; keep 2L
            D, H, W = x.shape[2:]
            y = F.conv_transpose3d(x, w.flip((2, 3, 4)), b, stride=2, padding=p - 1,
                                   groups=self.groups)
            return y[:, :, :2 * D, :2 * H, :2 * W]
        if s == 1 and self.pad in (None, ((p, p),) * 3):
            # a tensor with size-1 axes can come out of F.pad channels-last;
            # on the serving path x is already contiguous and this is free
            return dw_conv3(x.contiguous(), w, b)
        if self.pad is None:
            return F.conv3d(x, w, b, s, p, groups=self.groups)
        (dl, dh), (hl, hh), (wl, wh) = self.pad
        return F.conv3d(F.pad(x, (wl, wh, hl, hh, dl, dh)), w, b, s, groups=self.groups)


class PointwiseConv(nn.Conv3d):
    """1³ conv with bias on [B, C, D, H, W] as one GEMM per batch element;
    stride 2 takes the even indices (ceil(n/2) per axis)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__(in_channels, out_channels, 1, stride=stride)

    def gemm(self, x):
        B, C, D, H, W = x.shape
        Fo = self.out_channels
        # bmm with the weight broadcast over the batch: torch.matmul of a 2-D
        # weight by a 3-D x would fold x into [B·DHW, C], a transposing copy
        w = self.weight.view(1, Fo, C).expand(B, Fo, C)
        y = torch.bmm(w, x.reshape(B, C, D * H * W))
        return y.add_(self.bias.view(Fo, 1)).view(B, Fo, D, H, W)

    def forward(self, x):
        if self.stride[0] == 2:
            x = x[:, :, ::2, ::2, ::2]
        return self.gemm(x)


class PointwiseTranspose2(PointwiseConv):
    """MedNeXt's default up-block residual: a 1³ conv over the lead-padded
    zero-dilated input, [B, C, L...] -> [B, F, 2L...]. The all-odd parity
    class holds W·x[q] + b, every other voxel the bias."""

    def forward(self, x):
        B, C, D, H, W = x.shape
        Fo = self.out_channels
        y = self.gemm(x)
        # in the GEMM's dtype (bf16 under autocast), not the bias's
        out = self.bias.to(y.dtype).view(1, Fo, 1, 1, 1).expand(
            B, Fo, 2 * D, 2 * H, 2 * W).clone()
        out[:, :, 1::2, 1::2, 1::2] = y
        return out


def zero_dilate(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Insert factor-1 zeros between the spatial elements of [B, C, D, H, W]:
    each spatial size n becomes factor*n - (factor-1)."""
    B, C, D, H, W = x.shape
    out = x.new_zeros((B, C) + tuple(factor * n - (factor - 1) for n in (D, H, W)))
    out[:, :, ::factor, ::factor, ::factor] = x
    return out
