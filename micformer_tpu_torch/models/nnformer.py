"""nnFormer: interleaved conv and shifted-window transformer stages in a U
shape, with skip-K/V decoder blocks.

Counterpart of `micformer_tpu/models/nnformer.py` (registry names
`nnformer` and `nnformer_singlemodal`): a two-stem conv patch embed, four
encoder stages of (regular, shifted) Swin blocks with a relative-position
bias (windows 4-4-8-4 at MM-WHS), conv merges (GELU, LN, conv k3 s2), and
three decoder stages (LN, transposed conv k2 s2, an additive skip, a
`SkipKVBlock`, then shifted Swin blocks), then transposed-conv heads
(k = s = patch); under deep supervision one head a decoder stage, highest
resolution first. The bias index is the standard 3D Swin index, as the JAX
package documents. Channels-last inside, [B, C, D, H, W] at the interface;
module names follow the flax tree, so `convert.from_flax` maps its weights.

`input_size` ([D, H, W] of the windows the model is built for, the training
patch) fixes each stage's clamped window and so the shapes of the bias
tables, as the JAX model's tables take their shapes from the input it was
initialised on. None builds them for the configured windows (any input of
128³ or more at the default patch and windows).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from micformer_tpu_torch import registry
from micformer_tpu_torch.models.layers import (
    LN_EPS, DropPath, Mlp, SwinBlock3D, add_rel_pos_table, conv_cl, pad_to_multiple,
    rel_pos_bias,
)
from micformer_tpu_torch.ops.attention import merge_heads, multi_head_attention, split_heads
from micformer_tpu_torch.ops.windows import adjust_window_shift, window_partition, window_reverse


class ConvStem(nn.Module):
    """conv k3 (stride s, pad 1) -> GELU -> LN -> conv k3 s1 [-> GELU -> LN
    unless last], channels-last."""

    def __init__(self, in_ch: int, features: int, stride: int, last: bool = False):
        super().__init__()
        self.conv1 = nn.Conv3d(in_ch, features, 3, stride=stride, padding=1)
        self.norm1 = nn.LayerNorm(features, eps=LN_EPS)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1)
        self.norm2 = None if last else nn.LayerNorm(features, eps=LN_EPS)

    def forward(self, x):
        x = conv_cl(self.conv2, self.norm1(F.gelu(conv_cl(self.conv1, x))))
        return x if self.norm2 is None else self.norm2(F.gelu(x))


class SkipKVBlock(nn.Module):
    """nnFormer's SwinTransformerBlock_kv: unshifted windows, K and V from
    a projection of LN(skip), Q = LN(x_up) itself (no projection), a
    relative-position bias; residual on x (= x_up + skip), then the MLP."""

    def __init__(self, dim: int, num_heads: int, window_size, drop_path: float = 0.0,
                 input_size=None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        table_window = self.window_size if input_size is None else adjust_window_shift(
            tuple(input_size), self.window_size)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.kv = nn.Linear(dim, 2 * dim)
        add_rel_pos_table(self, table_window, num_heads)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, 4 * dim, dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, skip, x_up, generator=None):
        B, D, H, W, C = x.shape
        ws = adjust_window_shift((D, H, W), self.window_size)
        sk = pad_to_multiple(self.norm1(skip), ws)
        up = pad_to_multiple(self.norm1(x_up), ws)
        _, Dp, Hp, Wp, _ = sk.shape
        h = self.num_heads
        k, v = self.kv(window_partition(sk, ws)).chunk(2, dim=-1)
        q = window_partition(up, ws)
        out = multi_head_attention(split_heads(q, h), split_heads(k, h), split_heads(v, h),
                                   bias=rel_pos_bias(self, ws))
        out = self.proj(merge_heads(out))
        out = window_reverse(out, ws, B, Dp, Hp, Wp)[:, :D, :H, :W]
        x = x + self.drop_path(out, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class NnFormer(nn.Module):
    """Input [B, in_channels, D, H, W]; logits [B, num_classes, D, H, W] in
    f32, or under deep supervision a list of the heads' logits, highest
    resolution first. DropPath draws from the generator passed to forward."""

    def __init__(self, num_classes: int = 8, embed_dim: int = 96, depths=(2, 2, 2, 2),
                 num_heads=(3, 6, 12, 24), window_sizes=(4, 4, 8, 4), patch_size=(4, 4, 4),
                 drop_path_rate: float = 0.2, deep_supervision: bool = False,
                 in_channels: int = 2, input_size=None):
        super().__init__()
        E, n = embed_dim, len(depths)
        self.depths = list(depths)
        self.deep_supervision = deep_supervision
        self.stem1 = ConvStem(in_channels, E // 2, patch_size[0] // 2)
        self.stem2 = ConvStem(E // 2, E, patch_size[0] // 2, last=True)
        self.patch_norm = nn.LayerNorm(E, eps=LN_EPS)
        # each stage's [D, H, W] at input_size: the stems and merges halve
        # (rounding up), the decoder stages return to the encoder's
        res = None
        if input_size is not None:
            stride = (patch_size[0] // 2) ** 2
            res = [tuple(math.ceil(s / (stride * 2 ** i)) for s in _triple(input_size))
                   for i in range(n)]
        dpr = list(np.linspace(0, drop_path_rate, sum(depths)))
        for i in range(n):
            dim, ws = E * 2 ** i, (window_sizes[i],) * 3
            for b in range(depths[i]):
                self.add_module(f"enc{i}_b{b}", SwinBlock3D(
                    dim, num_heads[i], ws, shift_size=tuple(w // 2 for w in ws) if b % 2
                    else (0, 0, 0), rel_pos_bias=True,
                    drop_path=float(dpr[sum(depths[:i]) + b]),
                    input_size=None if res is None else res[i]))
            self.add_module(f"skip_norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
            if i < n - 1:
                self.add_module(f"merge_norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
                self.add_module(f"merge{i}", nn.Conv3d(dim, 2 * dim, 3, stride=2, padding=1))
        dec_ws = list(window_sizes[::-1][1:])
        dec_heads = list(num_heads[::-1][:-1])
        self.dec_depths = list(depths[::-1][1:])
        for s in range(n - 1):
            i = n - 2 - s
            dim, ws = E * 2 ** i, (dec_ws[s],) * 3
            size = None if res is None else res[i]
            self.add_module(f"up_norm{s}", nn.LayerNorm(2 * dim, eps=LN_EPS))
            self.add_module(f"up{s}", nn.ConvTranspose3d(2 * dim, dim, 2, stride=2))
            self.add_module(f"dec{s}_kv", SkipKVBlock(dim, dec_heads[s], ws,
                                                      drop_path=float(dpr[0]), input_size=size))
            for b in range(1, self.dec_depths[s]):
                self.add_module(f"dec{s}_b{b}", SwinBlock3D(
                    dim, dec_heads[s], ws, shift_size=tuple(w // 2 for w in ws),
                    rel_pos_bias=True, drop_path=float(dpr[b]), input_size=size))
        for j in range(n - 1 if deep_supervision else 1):
            self.add_module(f"head{j}", nn.ConvTranspose3d(E * 2 ** j, num_classes,
                                                           patch_size, stride=patch_size))

    def forward(self, x, generator=None):
        n = len(self.depths)
        x = x.to(self.patch_norm.weight.dtype).permute(0, 2, 3, 4, 1)    # the weights' dtype
        x = self.patch_norm(self.stem2(self.stem1(x)))
        skips = []
        for i in range(n):
            for b in range(self.depths[i]):
                x = getattr(self, f"enc{i}_b{b}")(x, generator)
            skips.append(getattr(self, f"skip_norm{i}")(x))
            if i < n - 1:
                x = getattr(self, f"merge_norm{i}")(F.gelu(x))
                x = conv_cl(getattr(self, f"merge{i}"), x)
        x = skips[-1]
        outs = []
        for s in range(n - 1):
            i = n - 2 - s
            x_up = conv_cl(getattr(self, f"up{s}"), getattr(self, f"up_norm{s}")(x))
            x = getattr(self, f"dec{s}_kv")(x_up + skips[i], skips[i], x_up, generator)
            for b in range(1, self.dec_depths[s]):
                x = getattr(self, f"dec{s}_b{b}")(x, generator)
            outs.append(x)

        def head(j):
            return conv_cl(getattr(self, f"head{j}"), outs[-1 - j]).permute(
                0, 4, 1, 2, 3).float()

        if self.deep_supervision:
            return [head(j) for j in range(len(outs))]
        return head(0)


def _triple(size):
    return (size,) * 3 if isinstance(size, int) else tuple(size)


@registry.register("nnformer", num_classes=8, embed_dim=96, input_size=None)
def build_nnformer(**kw):
    return NnFormer(**kw)


@registry.register("nnformer_singlemodal", num_classes=8, embed_dim=96, in_channels=1,
                   input_size=None)
def build_nnformer_sm(**kw):
    """SingleModal_nnformer: the same model on the CT channel alone."""
    return NnFormer(**kw)
