"""SwinUNETR (Hatamizadeh et al., arXiv:2201.01266; MONAI's
`monai.networks.nets.SwinUNETR`, which SwinUnter/train_mmwhs_noPad.py:26,92-93
trains) in plain f32 PyTorch, for judging the program's output.

A patch-2 embed (a conv whose kernel equals its stride, no norm); four Swin
stages of `depths[i]` blocks at feature_size·2^i channels, block b shifted
by half the window when b is odd, each block pre-norm window attention with
a learned relative-position bias (and on shifted blocks the region mask:
-100 between tokens of two pre-shift regions) and a pre-norm GELU MLP of 4×
width; a linear merge after each stage. The hidden states after the embed
and after each merge are tapped. A residual conv block (2 × (conv k3,
InstanceNorm), LeakyReLU 0.01 between and after the residual add) on the
input and on the first three taps, and on the last; four up blocks (a
transposed conv k2 s2, the skip concatenated, a residual conv block) and one
more at full resolution; a 1³ head.

Where this follows the program and not MONAI's class (each stated in the
configuration's `assumed`):
- the taps are not normalized (MONAI's default `normalize=True` puts a
  parameter-free LayerNorm on each);
- the merge concatenates the 2³ neighbourhood in (d, h, w) order, d slowest
  (MONAI's `PatchMergingV2`; its default `PatchMerging` repeats two
  neighbours and leaves two out);
- the residual conv blocks' convs and the transposed convs carry biases, the
  InstanceNorms are affine, and the residual 1³ conv has no norm after it
  (MONAI's `UnetResBlock`: bias-free convs, non-affine norms, a norm after
  the residual conv);
- each stage's bias table is that of the window clamped to the stage's grid
  at `input_size` (MONAI keeps the 7³ table and slices its index to the
  clamped window's first T rows and columns); no stage clamps at 128³.

The window-attention core is one module (`WindowAttention`, `heads`; input
[N, T, C]), computed over whole images at a time so that the f32 scores of
the first stage fit. Every matmul and conv operand passes through
`Precision.q`. Parameter names are the program's, so one state_dict loads
strictly into both.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.common import (
    Conv, Linear, PatchConv, PatchConvT, Precision, gelu, layer_norm,
)
from perfbench.reference.mednext import Norm

LN_EPS = 1e-5
MASKED = -100.0            # the Swin mask between tokens of two regions
CHUNK_WINDOWS = 1000       # windows of scores held at once, in whole images


def clamp_window(grid, window):
    """The window clamped to a grid: an axis no longer than its window is
    one window; with it, whether each axis keeps its shift."""
    return (tuple(min(g, w) for g, w in zip(grid, window)),
            tuple(g > w for g, w in zip(grid, window)))


def relative_index(window, device) -> torch.Tensor:
    """[T, T]: the bias table's row of each (query, key) pair of a window,
    the coordinate deltas made nonnegative and read as mixed-radix digits."""
    coords = torch.cartesian_prod(*(torch.arange(w, device=device) for w in window))
    delta = coords[:, None, :] - coords[None, :, :] + torch.tensor(
        [w - 1 for w in window], device=device)
    radix = [(2 * window[1] - 1) * (2 * window[2] - 1), 2 * window[2] - 1, 1]
    return (delta * torch.tensor(radix, device=device)).sum(-1)


def partition(x, window):
    """[B, D, H, W, C] -> [B·nW, T, C], windows in (d, h, w) order."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, C)


def unpartition(x, window, B, D, H, W):
    wd, wh, ww = window
    x = x.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def region_mask(grid, window, shift, device) -> torch.Tensor:
    """[nW, T, T] of a cyclic-shifted padded grid: 0 between tokens of one
    pre-shift region, MASKED between two. Along each axis the regions are
    [0, P - w), [P - w, P - s) and [P - s, P)."""
    labels = []
    for P, w, s in zip(grid, window, shift):
        pos = torch.arange(P, device=device)
        labels.append((pos >= P - w).long() + (pos >= P - s).long())
    ids = labels[0][:, None, None] * 9 + labels[1][None, :, None] * 3 + labels[2][None, None]
    ids = partition(ids[None, ..., None], window)[..., 0]
    return torch.where(ids[:, :, None] == ids[:, None, :], 0.0, MASKED)


class WindowAttention(nn.Module):
    """Multi-head self-attention over windows [N, T, C]: qkv projection,
    softmax(q·kᵀ/√d + bias + mask)·v per head, the output projection. The
    bias is the table's rows at `relative_index` of the window; `mask`
    [nW, T, T] is added window by window position."""

    def __init__(self, dim, heads, window, p: Precision):
        super().__init__()
        self.heads, self.window, self.p = heads, tuple(window), p
        self.qkv = Linear(dim, 3 * dim, p)
        self.proj = Linear(dim, dim, p)
        self.rel_pos_bias_table = nn.Parameter(
            torch.zeros(math.prod(2 * w - 1 for w in window), heads))

    def forward(self, x, window, mask=None):
        if tuple(window) != self.window:
            raise ValueError(f"window {tuple(window)} of this input, but the bias table is "
                             f"for window {self.window}")
        N, T, C = x.shape
        h, d = self.heads, C // self.heads
        q, k, v = self.qkv(x).reshape(N, T, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = self.p.q(q * d ** -0.5), self.p.q(k), self.p.q(v)
        idx = relative_index(window, x.device).reshape(-1)
        bias = self.rel_pos_bias_table[idx].reshape(T, T, h).permute(2, 0, 1)
        unit = 1 if mask is None else mask.shape[0]
        step = max(unit, CHUNK_WINDOWS // unit * unit)
        out = torch.empty_like(q)
        for i in range(0, N, step):
            s = q[i:i + step] @ k[i:i + step].transpose(-1, -2) + bias
            if mask is not None:
                s = (s.reshape(-1, unit, h, T, T) + mask[None, :, None]).reshape(-1, h, T, T)
            out[i:i + step] = self.p.q(torch.softmax(s, -1)) @ v[i:i + step]
        return self.proj(out.transpose(1, 2).reshape(N, T, C))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, p: Precision):
        super().__init__()
        self.fc1 = Linear(dim, hidden, p)
        self.fc2 = Linear(hidden, dim, p)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """x + attention(LN(x)) over the (shifted) windows of the zero-padded
    grid, then x + MLP(LN(x)), on channels-last [B, D, H, W, C]."""

    def __init__(self, dim, heads, window, shifted, table_window, p: Precision):
        super().__init__()
        self.window, self.shifted = tuple(window), shifted
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, table_window, p)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, 4 * dim, p)

    def forward(self, x):
        B, D, H, W, C = x.shape
        ws, keep = clamp_window((D, H, W), self.window)
        shift = tuple(w // 2 if self.shifted and kept else 0
                      for w, kept in zip(self.window, keep))
        pads = [(-n) % w for n, w in zip((D, H, W), ws)]
        h = F.pad(layer_norm(x, self.norm1), (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        grid = h.shape[1:4]
        mask = None
        if any(shift):
            h = torch.roll(h, tuple(-s for s in shift), (1, 2, 3))
            mask = region_mask(grid, ws, shift, x.device)
        a = unpartition(self.attn(partition(h, ws), ws, mask), ws, B, *grid)
        if any(shift):
            a = torch.roll(a, shift, (1, 2, 3))
        x = x + a[:, :D, :H, :W]
        return x + self.mlp(layer_norm(x, self.norm2))


class Merge(nn.Module):
    """C -> 2C on channels-last x: zero-pad to even extents, concatenate
    the 2³ neighbourhood in (d, h, w) order, LN(8C), a bias-free linear."""

    def __init__(self, dim, p: Precision):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=LN_EPS)
        self.reduction = Linear(8 * dim, 2 * dim, p, bias=False)

    def forward(self, x):
        D, H, W = x.shape[1:4]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2, 0, D % 2))
        x = torch.cat([x[:, a::2, b::2, c::2] for a, b, c in itertools.product(range(2), repeat=3)],
                      -1)
        return self.reduction(layer_norm(x, self.norm))


class Embed(nn.Module):
    def __init__(self, cin, dim, p: Precision):
        super().__init__()
        self.proj = PatchConv(cin, dim, 2, p)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 4, 1)


class ResConvBlock(nn.Module):
    def __init__(self, cin, features, p: Precision):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, p, padding=1)
        self.norm1 = Norm(features)
        self.conv2 = Conv(features, features, 3, p, padding=1)
        self.norm2 = Norm(features)
        self.res = None if cin == features else Conv(cin, features, 1, p)

    def forward(self, x):
        h = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        h = self.norm2(self.conv2(h))
        return F.leaky_relu(h + (x if self.res is None else self.res(x)), 0.01)


class UpBlock(nn.Module):
    def __init__(self, cin, skip, features, p: Precision):
        super().__init__()
        self.up = PatchConvT(cin, features, 2, p)
        self.block = ResConvBlock(features + skip, features, p)

    def forward(self, x, skip):
        return self.block(torch.cat([self.up(x), skip], 1))


class SwinUNETR(nn.Module):
    """[B, in_channels, D, H, W] -> f32 logits [B, num_classes, D, H, W]; D,
    H, W multiples of 32. `input_size` fixes each stage's bias table to the
    window clamped to that stage's grid (None: the configured window)."""

    def __init__(self, num_classes, feature_size, depths, num_heads, window_size,
                 in_channels=2, input_size=None, fp8=False):
        super().__init__()
        p = Precision(fp8)
        Fs = feature_size
        self.depths = list(depths)
        window = tuple(window_size)
        grids = [None] * 4
        if input_size is not None:
            size = (input_size,) * 3 if isinstance(input_size, int) else tuple(input_size)
            grids = [tuple(s // 2 for s in size)]
            for _ in range(3):
                grids.append(tuple(-(-g // 2) for g in grids[-1]))
        self.patch_embed = Embed(in_channels, Fs, p)
        for i in range(4):
            dim = Fs * 2 ** i
            table = window if grids[i] is None else clamp_window(grids[i], window)[0]
            for b in range(depths[i]):
                self.add_module(f"swin{i}_b{b}",
                                SwinBlock(dim, num_heads[i], window, b % 2 == 1, table, p))
            self.add_module(f"merge{i}", Merge(dim, p))
        self.encoder1 = ResConvBlock(in_channels, Fs, p)
        self.encoder2 = ResConvBlock(Fs, Fs, p)
        self.encoder3 = ResConvBlock(2 * Fs, 2 * Fs, p)
        self.encoder4 = ResConvBlock(4 * Fs, 4 * Fs, p)
        self.encoder10 = ResConvBlock(16 * Fs, 16 * Fs, p)
        self.decoder5 = UpBlock(16 * Fs, 8 * Fs, 8 * Fs, p)
        self.decoder4 = UpBlock(8 * Fs, 4 * Fs, 4 * Fs, p)
        self.decoder3 = UpBlock(4 * Fs, 2 * Fs, 2 * Fs, p)
        self.decoder2 = UpBlock(2 * Fs, Fs, Fs, p)
        self.decoder1 = UpBlock(Fs, Fs, Fs, p)
        self.out = Conv(Fs, num_classes, 1, p)

    def forward(self, x):
        x = x.float()
        h = self.patch_embed(x)
        taps = [h]
        for i in range(4):
            for b in range(self.depths[i]):
                h = getattr(self, f"swin{i}_b{b}")(h)
            h = getattr(self, f"merge{i}")(h)
            taps.append(h)
        cf = [t.permute(0, 4, 1, 2, 3) for t in taps]
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(cf[0])
        enc2 = self.encoder3(cf[1])
        enc3 = self.encoder4(cf[2])
        d = self.decoder5(self.encoder10(cf[4]), cf[3])
        d = self.decoder4(d, enc3)
        d = self.decoder3(d, enc2)
        d = self.decoder2(d, enc1)
        return self.out(self.decoder1(d, enc0))
