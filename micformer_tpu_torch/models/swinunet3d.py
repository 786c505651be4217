"""SwinUnet3D: a Swin U shape whose stages gate a depthwise conv path.

Counterpart of `micformer_tpu/models/swinunet3d.py` (registry names
`swinunet3d` and `swinunet3d_pure`): each stage resamples (conv k = s =
dsf down, transposed conv up), normalises over the channels, then adds a
gated conv path (`GatedConvBlock`: two depthwise k3 convs, each followed by
the channel norm and PReLU, times the input) to (regular, shifted) Swin
block pairs with no qkv bias, head_dim 32 and no relative-position bias;
the decoder converges each stage with its skip (add, channel norm); a
transposed conv k = s = dsf[0], norm and PReLU, then a 1³ head.
`faithful_scramble` keeps the reference's shifted-window scramble (see
`SwinBlock3D`). `pure` is the attention-only sibling: linear patch merge
and pixel-shuffle expand, no conv paths.

The gated path's convs are `DepthwiseConv3D`s (groups = channels, k3, SAME,
stride 1, bias): K3 on the card, and K3 for dx and the weight-gradient
kernel for dw and db in training; 14 K3 launches a forward (seven stages,
two convs each), none in the pure sibling. Channels-last inside (the conv
path takes the channels-first view), [B, C, D, H, W] at the interface;
module names follow the flax tree, so `convert.from_flax` maps its weights.
"""

from __future__ import annotations

import torch.nn as nn

from micformer_tpu_torch import registry
from micformer_tpu_torch.models.layers import (
    LN_EPS, DepthwiseConv3D, PReLU, SwinBlock3D, conv_cl,
)


class ChannelNorm(nn.Module):
    """The reference's `Norm`: LayerNorm over the channels of [B, D, H, W, C]."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        return self.norm(x)


class GatedConvBlock(nn.Module):
    """Two depthwise k3 convs, each followed by ChannelNorm and PReLU; the
    result times the input. Channels-last in and out."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = DepthwiseConv3D(features)
        self.norm1 = ChannelNorm(features)
        self.act1 = PReLU()
        self.conv2 = DepthwiseConv3D(features)
        self.norm2 = ChannelNorm(features)
        self.act2 = PReLU()

    def forward(self, x):
        h = self.act1(self.norm1(conv_cl(self.conv1, x)))
        h = self.act2(self.norm2(conv_cl(self.conv2, h)))
        return h * x


def _shuffle(x, s: int, features: int):
    """[B, D, H, W, s³·F] -> [B, sD, sH, sW, F], the '(f1 f2 f3 c)' split."""
    B, D, H, W, _ = x.shape
    x = x.reshape(B, D, H, W, s, s, s, features).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D * s, H * s, W * s, features)


class SwinStage(nn.Module):
    """Resample -> ChannelNorm -> Swin pairs (+ the gated conv path of the
    normalised input unless pure)."""

    def __init__(self, in_ch: int, features: int, layers: int, factor: int, num_heads: int,
                 head_dim: int, window_size: int, up: bool = False, pure: bool = False,
                 faithful_scramble: bool = False):
        super().__init__()
        self.factor, self.features, self.up, self.pure = factor, features, up, pure
        s = factor
        if pure and up:
            self.expand = nn.Linear(in_ch, s ** 3 * features)
        elif pure:
            self.merge = nn.Linear(s ** 3 * in_ch, features)
        elif up:
            self.expand = nn.ConvTranspose3d(in_ch, features, s, stride=s)
        else:
            self.merge = nn.Conv3d(in_ch, features, s, stride=s)
        self.norm = ChannelNorm(features)
        self.conv_block = None if pure else GatedConvBlock(features)
        ws = (window_size,) * 3
        self.pairs = layers // 2
        for i in range(self.pairs):
            self.add_module(f"swin{i}_reg", SwinBlock3D(
                features, num_heads, ws, qkv_bias=False, head_dim=head_dim))
            self.add_module(f"swin{i}_shift", SwinBlock3D(
                features, num_heads, ws, shift_size=tuple(w // 2 for w in ws), qkv_bias=False,
                head_dim=head_dim, swinunet_scramble=faithful_scramble))

    def forward(self, x, generator=None):
        s = self.factor
        if self.pure and self.up:
            x = _shuffle(self.expand(x), s, self.features)
        elif self.pure:
            B, D, H, W, C = x.shape
            x = x.reshape(B, D // s, s, H // s, s, W // s, s, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
            x = self.merge(x.reshape(B, D // s, H // s, W // s, s ** 3 * C))
        else:
            x = conv_cl(self.expand if self.up else self.merge, x)
        x = self.norm(x)
        conv_path = None if self.conv_block is None else self.conv_block(x)
        h = x
        for i in range(self.pairs):
            h = getattr(self, f"swin{i}_reg")(h, generator)
            h = getattr(self, f"swin{i}_shift")(h, generator)
        return h if conv_path is None else h + conv_path


class SwinUnet3D(nn.Module):
    """Input [B, in_channels, D, H, W]; logits [B, num_classes, D, H, W] in
    f32."""

    def __init__(self, num_classes: int = 8, hidden_dim: int = 96, layers=(2, 2, 4, 2),
                 heads=(3, 6, 9, 12), head_dim: int = 32, window_size: int = 4,
                 downscaling_factors=(4, 2, 2, 2), stl_channels: int = 32,
                 faithful_scramble: bool = False, pure: bool = False, in_channels: int = 2):
        super().__init__()
        hd, dsf = hidden_dim, downscaling_factors
        self.pure, self.dsf0, self.stl_channels = pure, dsf[0], stl_channels
        common = dict(head_dim=head_dim, window_size=window_size,
                      faithful_scramble=faithful_scramble, pure=pure)
        self.down12 = SwinStage(in_channels, hd, layers[0], dsf[0], heads[0], **common)
        self.down3 = SwinStage(hd, hd * 2, layers[1], dsf[1], heads[1], **common)
        self.down4 = SwinStage(hd * 2, hd * 4, layers[2], dsf[2], heads[2], **common)
        self.features = SwinStage(hd * 4, hd * 8, layers[3], dsf[3], heads[3], **common)
        self.up4 = SwinStage(hd * 8, hd * 4, layers[2], dsf[3], heads[2], up=True, **common)
        self.converge4 = ChannelNorm(hd * 4)
        self.up3 = SwinStage(hd * 4, hd * 2, layers[1], dsf[2], heads[1], up=True, **common)
        self.converge3 = ChannelNorm(hd * 2)
        self.up12 = SwinStage(hd * 2, hd, layers[0], dsf[1], heads[0], up=True, **common)
        self.converge12 = ChannelNorm(hd)
        if pure:
            self.final_expand = nn.Linear(hd, dsf[0] ** 3 * stl_channels)
        else:
            self.final_expand = nn.ConvTranspose3d(hd, stl_channels, dsf[0], stride=dsf[0])
        self.final_norm = ChannelNorm(stl_channels)
        self.final_act = PReLU()
        self.head = nn.Conv3d(stl_channels, num_classes, 1)

    def forward(self, x, generator=None):
        """`generator` is passed to the Swin blocks (DropPath is 0 in this
        model, so nothing draws). x is cast to the weights' dtype."""
        x = x.to(self.head.weight.dtype).permute(0, 2, 3, 4, 1)
        d1 = self.down12(x, generator)
        d2 = self.down3(d1, generator)
        d3 = self.down4(d2, generator)
        feat = self.features(d3, generator)
        u4 = self.converge4(self.up4(feat, generator) + d3)
        u3 = self.converge3(self.up3(u4, generator) + d2)
        u12 = self.converge12(self.up12(u3, generator) + d1)
        if self.pure:
            out = _shuffle(self.final_expand(u12), self.dsf0, self.stl_channels)
        else:
            out = conv_cl(self.final_expand, u12)
        out = self.final_act(self.final_norm(out))
        return conv_cl(self.head, out).permute(0, 4, 1, 2, 3).float()


@registry.register("swinunet3d", num_classes=8)
def build_swinunet3d(**kw):
    return SwinUnet3D(**kw)


@registry.register("swinunet3d_pure", num_classes=8)
def build_swinunet3d_pure(**kw):
    """The attention-only sibling: linear patch merge and expand."""
    kw.setdefault("pure", True)
    return SwinUnet3D(**kw)
