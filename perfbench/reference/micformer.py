"""MicFormer (arXiv:2404.16371; MicFormer/models/MICFormer_self.py:881-1039)
in plain f32 PyTorch, for judging the program's output.

Dual-stream Swin U-shape on channels-last [B, D, H, W, C] streams: a shared
patch embed (conv k = s = patch) of each modality, four encoder and four
decoder stages, each `depth` times (a window self-attention block per stream,
then deformable cross-attention blocks both ways), conv k2 s2 merges and
transposed conv k2 s2 expands with LayerNorm, skip projections, and the head
(transposed conv k = s = patch, then a k3 conv). Attention is the einsum
chain softmax(q·kᵀ/√d)·v over 2³ windows; the cross block's offset net (conv
k3 2C -> 16, LN, GELU, conv 1³ 16 -> 3) plus the reference grid warps the
other stream with `F.grid_sample`. Parameter names follow the program's, so
one state_dict loads into both. Inference only: no DropPath (identity in
eval mode).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.common import (
    Conv, Linear, PatchConv, PatchConvT, Precision, gelu, layer_norm,
)

EPS = 1e-5


def partition(x, ws):
    """[B, D, H, W, C] -> [B·nW, T, C], windows of ws (D, H, W multiples of ws)."""
    B, D, H, W, C = x.shape
    a, b, c = ws
    x = x.reshape(B, D // a, a, H // b, b, W // c, c, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, a * b * c, C)


def unpartition(x, ws, B, D, H, W):
    a, b, c = ws
    x = x.reshape(B, D // a, H // b, W // c, a, b, c, -1).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


def clamp_window(dims, window):
    """Each axis of the window cut to the input's extent."""
    return tuple(min(d, w) for d, w in zip(dims, window))


def pad_to(x, ws):
    """Zero-pad [B, D, H, W, C] up to multiples of ws."""
    pads = [(-s) % w for s, w in zip(x.shape[1:4], ws)]
    if any(pads):
        x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    return x


class Attention(nn.Module):
    """Multi-head attention over [N, T, C] windows: qkv from x (self), or q
    from x and kv from the context (cross)."""

    def __init__(self, dim, heads, p: Precision, cross=False):
        super().__init__()
        self.heads, self.cross, self.p = heads, cross, p
        if cross:
            self.q = Linear(dim, dim, p)
            self.kv = Linear(dim, 2 * dim, p)
        else:
            self.qkv = Linear(dim, 3 * dim, p)
        self.proj = Linear(dim, dim, p)

    def forward(self, x, context=None):
        if self.cross:
            q = self.q(x)
            k, v = self.kv(context).chunk(2, dim=-1)
        else:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        N, T, C = q.shape
        h = self.heads
        d = C // h
        q, k, v = (t.reshape(N, -1, h, d) for t in (q, k, v))
        s = torch.einsum("nqhd,nkhd->nhqk", self.p.q(q), self.p.q(k)) * d ** -0.5
        a = torch.softmax(s, dim=-1)
        out = torch.einsum("nhqk,nkhd->nqhd", self.p.q(a), self.p.q(v))
        return self.proj(out.reshape(N, T, C))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, p: Precision):
        super().__init__()
        self.fc1 = Linear(dim, hidden, p)
        self.fc2 = Linear(hidden, dim, p)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class SelfBlock(nn.Module):
    """x + attn(LN(x)) over unshifted windows, then x + mlp(LN(x))."""

    def __init__(self, dim, heads, window, p: Precision):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = Attention(dim, heads, p)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, 4 * dim, p)

    def forward(self, x):
        B, D, H, W, C = x.shape
        ws = clamp_window((D, H, W), self.window)
        xn = pad_to(layer_norm(x, self.norm1), ws)
        Dp, Hp, Wp = xn.shape[1:4]
        a = unpartition(self.attn(partition(xn, ws)), ws, B, Dp, Hp, Wp)
        x = x + a[:, :D, :H, :W]
        return x + self.mlp(layer_norm(x, self.norm2))


def reference_grid(D, H, W, device):
    """MicFormer's reference points [1, 3, D, H, W] (z, y, x): voxel centres
    mapped to [-1, 1], with the source's normalisation of z by H, y by W and
    x by D."""
    lin = [(torch.arange(s, dtype=torch.float32, device=device) + 0.5) for s in (D, H, W)]
    gz, gy, gx = torch.meshgrid(*lin, indexing="ij")
    return torch.stack([gz / H * 2 - 1, gy / W * 2 - 1, gx / D * 2 - 1])[None]


def warp(src, flow):
    """The source's spatial transformer: sample src [B, D, H, W, C] at
    grid + flow (voxel units, [B, 3(z, y, x), D, H, W]), normalised by
    2·(loc / (S - 1) - 0.5), trilinear, zeros outside, align_corners False."""
    B, D, H, W, C = src.shape
    sizes = (D, H, W)
    axes = [torch.arange(s, dtype=torch.float32, device=src.device) for s in sizes]
    loc = torch.stack(torch.meshgrid(*axes, indexing="ij"))[None] + flow
    norm = [2.0 * (loc[:, i] / (sizes[i] - 1) - 0.5) if sizes[i] > 1
            else torch.full_like(loc[:, i], -1.0 + 1.0 / sizes[i]) for i in range(3)]
    grid = torch.stack([norm[2], norm[1], norm[0]], dim=-1)
    out = F.grid_sample(src.permute(0, 4, 1, 2, 3), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 4, 1)


class CrossBlock(nn.Module):
    """Windows of LN(x) attend to windows of the other stream warped by the
    offset net's flow plus the reference grid; then the MLP."""

    def __init__(self, dim, heads, window, p: Precision, hidden=16):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.offset_conv1 = Conv(2 * dim, hidden, 3, p, padding=1)
        self.offset_norm = nn.LayerNorm(hidden, eps=EPS)
        self.offset_conv2 = Conv(hidden, 3, 1, p, bias=False)
        self.cross_attn = Attention(dim, heads, p, cross=True)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, 4 * dim, p)

    def forward(self, x, xa):
        B, D, H, W, C = x.shape
        ws = clamp_window((D, H, W), self.window)
        xn = pad_to(layer_norm(x, self.norm1), ws)
        xap = pad_to(xa, ws)
        Dp, Hp, Wp = xn.shape[1:4]
        off = self.offset_conv1(torch.cat([xn, xap], -1).permute(0, 4, 1, 2, 3))
        off = gelu(layer_norm(off.permute(0, 2, 3, 4, 1), self.offset_norm))
        flow = self.offset_conv2(off.permute(0, 4, 1, 2, 3)) + reference_grid(Dp, Hp, Wp, x.device)
        moved = warp(xap, flow)
        a = self.cross_attn(partition(xn, ws), partition(moved, ws))
        x = x + unpartition(a, ws, B, Dp, Hp, Wp)[:, :D, :H, :W]
        return x + self.mlp(layer_norm(x, self.norm2))


class Merge(nn.Module):
    """C -> 2C at half the extents: conv k2 s2, then LN."""

    def __init__(self, dim, p: Precision):
        super().__init__()
        self.conv = PatchConv(dim, 2 * dim, 2, p)
        self.norm = nn.LayerNorm(2 * dim, eps=EPS)

    def forward(self, x):
        return layer_norm(self.conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1), self.norm)


class Expand(nn.Module):
    """C -> C/2 at twice the extents: transposed conv k2 s2, then LN."""

    def __init__(self, dim, p: Precision):
        super().__init__()
        self.conv = PatchConvT(dim, dim // 2, 2, p)
        self.norm = nn.LayerNorm(dim // 2, eps=EPS)

    def forward(self, x):
        return layer_norm(self.conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1), self.norm)


class Stage(nn.Module):
    """depth × (self block per stream, then cross1(x ← xa) and cross2(xa ← x),
    both reading the streams from before either), then the shared merge or
    expand. Returns the streams before and after it."""

    def __init__(self, dim, depth, heads, window, p: Precision, resample=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"self1_{i}", SelfBlock(dim, heads, window, p))
            self.add_module(f"self2_{i}", SelfBlock(dim, heads, window, p))
            self.add_module(f"cross1_{i}", CrossBlock(dim, heads, window, p))
            self.add_module(f"cross2_{i}", CrossBlock(dim, heads, window, p))
        self.downsample = Merge(dim, p) if resample == "merge" else None
        self.upsample = Expand(dim, p) if resample == "expand" else None

    def forward(self, x, xa):
        for i in range(self.depth):
            x = getattr(self, f"self1_{i}")(x)
            xa = getattr(self, f"self2_{i}")(xa)
            x, xa = getattr(self, f"cross1_{i}")(x, xa), getattr(self, f"cross2_{i}")(xa, x)
        res = self.downsample or self.upsample
        if res is None:
            return x, xa, x, xa
        return x, xa, res(x), res(xa)


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, p: Precision):
        super().__init__()
        self.proj = PatchConv(1, dim, patch, p)


class MicFormer(nn.Module):
    """[B, 2 (CT, MR), D, H, W] -> f32 logits [B, num_classes, D, H, W]."""

    def __init__(self, num_classes=8, embed_dim=48, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window_size=(2, 2, 2), patch_size=(4, 4, 4),
                 fp8=False):
        super().__init__()
        p = Precision(fp8)
        n = len(depths)
        self.n = n
        patch = patch_size[0]
        self.patch_embed = PatchEmbed(embed_dim, patch, p)
        for i in range(n):
            self.add_module(f"enc{i}", Stage(embed_dim * 2 ** i, depths[i], num_heads[i],
                                             tuple(window_size), p,
                                             "merge" if i < n - 1 else None))
        self.norm = nn.LayerNorm(embed_dim * 2 ** (n - 1), eps=EPS)
        for inx, i in enumerate(reversed(range(n))):
            dim = embed_dim * 2 ** i
            if inx > 0:
                self.add_module(f"concat_back{inx}", Linear(2 * dim, dim, p))
            self.add_module(f"dec{inx}", Stage(dim, depths[i], num_heads[i], tuple(window_size),
                                               p, "expand" if i > 0 else None))
        self.norm2 = nn.LayerNorm(2 * embed_dim, eps=EPS)
        self.reverse_patch_embed = PatchConvT(2 * embed_dim, embed_dim // 2, patch, p)
        self.out_conv = Conv(embed_dim // 2, num_classes, 3, p, padding=1)

    def embed(self, x):
        return self.patch_embed.proj(x).permute(0, 2, 3, 4, 1)

    def forward(self, x):
        x = x.float()
        moving, fixed = self.embed(x[:, 0:1]), self.embed(x[:, 1:2])
        skips = []
        for i in range(self.n):
            m, f, moving, fixed = getattr(self, f"enc{i}")(moving, fixed)
            skips.append((m, f))
        moving, fixed = layer_norm(moving, self.norm), layer_norm(fixed, self.norm)
        for inx in range(self.n):
            if inx > 0:
                back = getattr(self, f"concat_back{inx}")
                m, f = skips[self.n - 1 - inx]
                moving = back(torch.cat([moving, m], -1))
                fixed = back(torch.cat([fixed, f], -1))
            _, _, moving, fixed = getattr(self, f"dec{inx}")(moving, fixed)
        out = layer_norm(torch.cat([moving, fixed], -1), self.norm2)
        return self.out_conv(self.reverse_patch_embed(out.permute(0, 4, 1, 2, 3)))
