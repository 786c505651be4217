"""TransBTS: a conv U-Net encoder, a ViT bottleneck over its 1/8 grid, and
a conv-cascade decoder that emits probabilities.

Counterpart of `micformer_tpu/models/transbts.py` (registry name
`transbts`; MM-WHS: base 16 channels, embed 512, 8 heads, 4 layers, MLP
4096, dropout 0.1): InitConv (conv k3 and dropout 0.2), pre-activation
GroupNorm residual `EnBlock`s (min(8, C) groups) and stride-2 convs down to
1/8; InstanceNorm, ReLU and a conv k3 to the embedding; the tokens plus a
learned positional embedding, dropout, pre-LN `ViTBlock`s; back to the
grid, a double conv (no residual), a residual block, three DeUp stages (1³
conv, transposed conv k2 s2, the skip concatenated first, 1³ conv, a
residual block), a 1³ head and, by default, the softmax over classes: the
reference emits probabilities and so does this model, to its callers.
Channels-first [B, C, D, H, W]; module names follow the flax tree, so
`convert.from_flax` maps its weights.

`pos_embed` is [1, D·H·W/512, E] for the input the model is built for, so
the model needs `input_size` ([D, H, W], the training patch; cli/train
fills it in and records it, serve and predict read it back).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from micformer_tpu_torch import registry
from micformer_tpu_torch.models.layers import (
    LN_EPS, DoubleConv, Dropout, GroupNorm, InstanceNorm, Mlp,
)
from micformer_tpu_torch.ops.attention import merge_heads, multi_head_attention, split_heads


class EnBlock(nn.Module):
    """Pre-activation residual: GN, ReLU, conv k3, GN, ReLU, conv k3, + x."""

    def __init__(self, channels: int):
        super().__init__()
        groups = min(8, channels)
        self.norm1 = GroupNorm(groups, channels)
        self.conv1 = nn.Conv3d(channels, channels, 3, padding=1)
        self.norm2 = GroupNorm(groups, channels)
        self.conv2 = nn.Conv3d(channels, channels, 3, padding=1)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(h))) + x


class ViTBlock(nn.Module):
    """Pre-LN transformer block over [B, N, C] tokens: fused qkv, global
    attention, proj and dropout; then the MLP with dropout."""

    def __init__(self, dim: int, num_heads: int, hidden: int, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.drop = Dropout(dropout)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, hidden, dim, dropout)

    def forward(self, x, generator=None):
        q, k, v = (split_heads(t, self.num_heads)
                   for t in self.qkv(self.norm1(x)).chunk(3, dim=-1))
        x = x + self.drop(self.proj(merge_heads(multi_head_attention(q, k, v))), generator)
        return x + self.mlp(self.norm2(x), generator)


class TransBTS(nn.Module):
    """Input [B, in_channels, D, H, W]; [B, num_classes, D, H, W] in f32:
    probabilities (softmax_output) or logits. Dropout draws from the
    generator passed to forward."""

    def __init__(self, num_classes: int = 8, base_channels: int = 16,
                 embedding_dim: int = 512, num_heads: int = 8, num_layers: int = 4,
                 hidden_dim: int = 4096, dropout: float = 0.1, softmax_output: bool = True,
                 in_channels: int = 2, input_size=None):
        super().__init__()
        if input_size is None:
            raise ValueError("transbts: pass input_size=[D, H, W], the input the model is "
                             "built for (its learned pos_embed has D·H·W/512 rows)")
        size = (input_size,) * 3 if isinstance(input_size, int) else tuple(input_size)
        bc, e = base_channels, embedding_dim
        self.num_layers = num_layers
        self.softmax_output = softmax_output
        self.init_conv = nn.Conv3d(in_channels, bc, 3, padding=1)
        self.init_drop = Dropout(0.2)
        self.en1 = EnBlock(bc)
        for j, c in enumerate((bc, 2 * bc, 4 * bc), start=1):
            self.add_module(f"down{j}", nn.Conv3d(c, 2 * c, 3, stride=2, padding=1))
        self.en2_1, self.en2_2 = EnBlock(2 * bc), EnBlock(2 * bc)
        self.en3_1, self.en3_2 = EnBlock(4 * bc), EnBlock(4 * bc)
        for j in range(1, 5):
            self.add_module(f"en4_{j}", EnBlock(8 * bc))
        self.pre_vit_norm = InstanceNorm(8 * bc)
        self.conv_x = nn.Conv3d(8 * bc, e, 3, padding=1)
        # three stride-2 convs at padding 1 take n to ceil(n / 2) each
        tokens = math.prod(math.ceil(s / 8) for s in size)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, e))
        self.tok_drop = Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"vit{i}", ViTBlock(e, num_heads, hidden_dim, dropout))
        self.bneck = DoubleConv(e, e // 4)
        self.deblock8 = DoubleConv(e // 4, e // 4, residual=True)
        cin = e // 4
        for j, (cout, skip) in enumerate([(e // 8, 4 * bc), (e // 16, 2 * bc), (e // 32, bc)]):
            self.add_module(f"deup{j}_c1", nn.Conv3d(cin, cout, 1))
            self.add_module(f"deup{j}_up", nn.ConvTranspose3d(cout, cout, 2, stride=2))
            self.add_module(f"deup{j}_c3", nn.Conv3d(skip + cout, cout, 1))
            self.add_module(f"deblock{j}", DoubleConv(cout, cout, residual=True))
            cin = cout
        self.endconv = nn.Conv3d(cin, num_classes, 1)

    def forward(self, x, generator=None):
        x = x.to(self.endconv.weight.dtype)           # the weights' dtype
        h = self.init_drop(self.init_conv(x), generator)
        x1 = self.en1(h)
        x2 = self.en2_2(self.en2_1(self.down1(x1)))
        x3 = self.en3_2(self.en3_1(self.down2(x2)))
        h = self.down3(x3)
        for j in range(1, 5):
            h = getattr(self, f"en4_{j}")(h)
        h = self.conv_x(F.relu(self.pre_vit_norm(h)))
        B, E, D, H, W = h.shape
        if D * H * W != self.pos_embed.shape[1]:
            raise ValueError(f"transbts: a {tuple(x.shape[2:])} input has {D * H * W} tokens, "
                             f"but pos_embed has {self.pos_embed.shape[1]}: build the model "
                             "with the input_size it is called at")
        t = self.tok_drop(h.flatten(2).transpose(1, 2) + self.pos_embed, generator)
        for i in range(self.num_layers):
            t = getattr(self, f"vit{i}")(t, generator)
        h = self.deblock8(self.bneck(t.transpose(1, 2).reshape(B, E, D, H, W)))
        for j, skip in enumerate((x3, x2, x1)):
            h = getattr(self, f"deup{j}_up")(getattr(self, f"deup{j}_c1")(h))
            h = getattr(self, f"deup{j}_c3")(torch.cat([skip, h], dim=1))
            h = getattr(self, f"deblock{j}")(h)
        out = self.endconv(h).float()
        return torch.softmax(out, dim=1) if self.softmax_output else out


@registry.register("transbts", num_classes=8, input_size=None)
def build_transbts(**kw):
    return TransBTS(**kw)
