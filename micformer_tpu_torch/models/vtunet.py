"""VT-UNet: a volumetric Swin U-shape whose decoder blocks also attend to
the encoder's saved keys and values.

Counterpart of `micformer_tpu/models/vtunet.py` (registry name `vtunet`):
a patch-4 embed with LN; encoder stages of (regular, shifted) window blocks
with a relative-position bias (embed E·2^i, depths 2-2-2-1, heads
3-6-12-24, window 7³); each stage saves its last even block's (v, k) and its
last odd block's; Swin merges between stages. The decoder expands, then per
stage concatenates the skip, projects it back (`concat_back`, a bias-free
Linear), and runs blocks that fuse self-attention, cross-attention of the
same queries against the encoder block of the same shift parity, and an MLP
of the sinusoidal encoding alone:

    x = (1 - α)·x_sa + α·x_ca + mlp(norm2(PE)),    α = 0.5

Then LN, a x4 final expand and a bias-free 1³ head. Merges and expands are
true 3D by default; `faithful_2d_merge` takes the reference's H/W-only
merge and expand (`PatchMerging2D`, `PatchExpand2D`). Channels-last inside,
[B, C, D, H, W] at the interface; module names follow the flax tree, so
`convert.from_flax` maps its weights.

Two reference quirks are kept, as the JAX package keeps them: the decoder's
cross-attention runs at scale d^-1 (q scaled twice), and the bias table is
built for the construction window (7³) whatever window the grid clamps it
to (`vt_rel_pos_bias`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from micformer_tpu_torch import registry
from micformer_tpu_torch.models.layers import (
    LN_EPS, DropPath, FinalPatchExpand, Mlp, PatchEmbed3D, PatchExpandLinear,
    PatchMergingLinear, add_rel_pos_table, pad_to_multiple, rel_pos_bias_cached,
)
from micformer_tpu_torch.ops.attention import merge_heads, multi_head_attention, split_heads
from micformer_tpu_torch.ops.pe import sinusoidal_pe_3d
from micformer_tpu_torch.ops.windows import (
    adjust_window_shift, cyclic_shift, shifted_window_region_ids, window_partition,
    window_reverse,
)


class PatchMerging2D(nn.Module):
    """The reference's merge: H and W halved, D kept; the four neighbours
    (h0 w0, h1 w0, h0 w1, h1 w1) concatenated, LN(4C), a bias-free
    Linear(4C, 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2],
                       x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchExpand2D(nn.Module):
    """The reference's expand: a bias-free Linear(C, 2C), shuffled into
    H and W only as (h, w, C/2) blocks, then LN(C/2)."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 2, eps=LN_EPS)

    def forward(self, x):
        B, D, H, W, C = x.shape
        c = C // 2
        x = self.expand(x).reshape(B, D, H, W, 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
        return self.norm(x.reshape(B, D, 2 * H, 2 * W, c))


def vt_rel_pos_bias(module: nn.Module, T: int) -> torch.Tensor:
    """[h, T, T]: the table gathered at the top-left T x T block of the
    construction window's index. The reference quirk that VT-UNet keeps:
    its table and index are for the window it was built with (7³), and a
    window clamped to a smaller grid still takes `index[:T, :T]`, rows that
    are not that window's relative positions (the weights were trained so).
    Where the window does not clamp, this is the standard gather. At
    inference it is read from the module's cache (`rel_pos_bias_cached`),
    whose key holds T, so the quirk's rows are what the cache keeps."""
    return rel_pos_bias_cached(module, T)


class VTWindowAttention(nn.Module):
    """Fused-qkv window attention with a relative-position bias; with the
    encoder's saved (prev_k, prev_v) also the decoder's cross path: the same
    q, bias, mask and proj, at scale d^-1. Returns (out, out2, v, k), out2
    None without the saved pair."""

    def __init__(self, dim: int, num_heads: int, table_window, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        add_rel_pos_table(self, table_window, num_heads)

    def forward(self, x, mask=None, prev_k=None, prev_v=None):
        h = self.num_heads
        q, k, v = (split_heads(t, h) for t in self.qkv(x).chunk(3, dim=-1))
        bias = vt_rel_pos_bias(self, x.shape[1])
        out = self.proj(merge_heads(multi_head_attention(q, k, v, bias=bias, mask=mask)))
        out2 = None
        if prev_k is not None:
            out2 = self.proj(merge_heads(multi_head_attention(
                q, prev_k, prev_v, bias=bias, mask=mask, scale=float(q.shape[-1]) ** -1.0)))
        return out, out2, v, k


class VTBlock(nn.Module):
    """Pre-norm (shifted-)window block; with `prev` = the encoder's saved
    (v, k) the decoder's fusion of self- and cross-attention and the
    encoding's MLP. Returns (x, v, k): v and k per window, [N, T, h, d]."""

    def __init__(self, dim: int, num_heads: int, window_size=(7, 7, 7), shift: bool = False,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, alpha: float = 0.5):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift = shift
        self.alpha = alpha
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = VTWindowAttention(dim, num_heads, self.window_size)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, prev=None, generator=None):
        B, D, H, W, C = x.shape
        shift = tuple(w // 2 for w in self.window_size) if self.shift else (0, 0, 0)
        ws, ss = adjust_window_shift((D, H, W), self.window_size, shift)
        xn = cyclic_shift(pad_to_multiple(self.norm1(x), ws), ss)
        _, Dp, Hp, Wp, _ = xn.shape
        ids = shifted_window_region_ids((Dp, Hp, Wp), ws, ss)
        mask = None if ids is None else torch.from_numpy(ids).to(x.device)
        pv, pk = (None, None) if prev is None else prev
        a, a2, v, k = self.attn(window_partition(xn, ws), mask=mask, prev_k=pk, prev_v=pv)

        def unwindow(t):
            t = cyclic_shift(window_reverse(t, ws, B, Dp, Hp, Wp), ss, reverse=True)
            return t[:, :D, :H, :W]

        def branch(t):
            t = x + self.drop_path(unwindow(t), generator)
            return t + self.drop_path(self.mlp(self.norm2(t)), generator)

        out = branch(a)
        if a2 is not None:
            pe = torch.from_numpy(sinusoidal_pe_3d(D, H, W, C)).to(x.device, out.dtype)[None]
            out = ((1 - self.alpha) * out + self.alpha * branch(a2)
                   + self.mlp(self.norm2(pe)))
        return out, v, k


class VTUNet(nn.Module):
    """Input [B, in_channels, D, H, W]; logits [B, num_classes, D, H, W] in
    f32. DropPath draws from the generator passed to forward."""

    def __init__(self, num_classes: int = 8, embed_dim: int = 96, depths=(2, 2, 2, 1),
                 num_heads=(3, 6, 12, 24), window_size=(7, 7, 7), patch_size=(4, 4, 4),
                 drop_path_rate: float = 0.1, faithful_2d_merge: bool = False,
                 in_channels: int = 2):
        super().__init__()
        Merge = PatchMerging2D if faithful_2d_merge else PatchMergingLinear
        Expand = PatchExpand2D if faithful_2d_merge else PatchExpandLinear
        # an expand's output channels: C / 2 (H, W only) or C / 4 (2³)
        shrink = 2 if faithful_2d_merge else 4
        E, n = embed_dim, len(depths)
        self.depths = list(depths)
        self.patch_embed = PatchEmbed3D(in_channels, E, tuple(patch_size), use_norm=True)
        dpr = list(np.linspace(0, drop_path_rate, sum(depths)))

        def blocks(prefix, i):
            for b in range(depths[i]):
                self.add_module(f"{prefix}_b{b}", VTBlock(
                    E * 2 ** i, num_heads[i], window_size, shift=b % 2 == 1,
                    drop_path=float(dpr[sum(depths[:i]) + b])))

        for i in range(n):
            blocks(f"enc{i}", i)
            if i < n - 1:
                self.add_module(f"merge{i}", Merge(E * 2 ** i))
        ch = E * 2 ** (n - 1)
        self.norm = nn.LayerNorm(ch, eps=LN_EPS)
        self.up0 = Expand(ch)
        ch //= shrink
        for inx in range(1, n):
            dim = E * 2 ** (n - 1 - inx)
            self.add_module(f"concat_back{inx}", nn.Linear(ch + dim, dim, bias=False))
            blocks(f"dec{inx}", n - 1 - inx)
            ch = dim
            if inx < n - 1:
                self.add_module(f"up{inx}", Expand(dim))
                ch //= shrink
        self.norm_up = nn.LayerNorm(ch, eps=LN_EPS)
        self.final_expand = FinalPatchExpand(ch, scale=patch_size[0])
        self.head = nn.Conv3d(ch, num_classes, 1, bias=False)

    def forward(self, x, generator=None):
        n = len(self.depths)
        x = self.patch_embed(x.to(self.norm.weight.dtype).permute(0, 2, 3, 4, 1))
        skips, saved = [], []
        for i in range(n):
            skips.append(x)
            kv = [None, None]            # the last even and the last odd block's (v, k)
            for b in range(self.depths[i]):
                x, v, k = getattr(self, f"enc{i}_b{b}")(x, generator=generator)
                kv[b % 2] = (v, k)
            saved.append(kv)
            if i < n - 1:
                x = getattr(self, f"merge{i}")(x)
        x = self.up0(self.norm(x))
        for inx in range(1, n):
            i = n - 1 - inx
            x = getattr(self, f"concat_back{inx}")(torch.cat([x, skips[i]], dim=-1))
            for b in range(self.depths[i]):
                x, _, _ = getattr(self, f"dec{inx}_b{b}")(x, prev=saved[i][b % 2],
                                                         generator=generator)
            if inx < n - 1:
                x = getattr(self, f"up{inx}")(x)
        x = self.final_expand(self.norm_up(x))
        return self.head(x.permute(0, 4, 1, 2, 3)).float()


@registry.register("vtunet", num_classes=8, embed_dim=96)
def build_vtunet(**kw):
    return VTUNet(**kw)
