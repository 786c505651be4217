"""SwinUNETR: a Swin transformer encoder under a residual conv UNETR decoder.

Counterpart of `micformer_tpu/models/swinunetr.py` (registry name
`swinunetr`, the MONAI model the reference trains: feature size 12, depths
2-4-2-2, heads 2-4-8-12, window 7³): a patch-2 embed without norm, four
stages of (regular, shifted) Swin blocks with a relative-position bias,
each followed by a linear merge, and the hidden states after the embed and
each stage tapped; `ResConvBlock`s on the input and the taps; `UpBlock`s
(transposed conv, skip concatenation, `ResConvBlock`) back to full
resolution; a 1³ head. The JAX package runs the full- and half-resolution
conv blocks W-packed by default, an exact reformulation with the same
parameter tree; this is the plain math. Swin stages channels-last, the conv
path channels-first, [B, C, D, H, W] at the interface; module names follow
the flax tree, so `convert.from_flax` maps its weights.

`input_size` ([D, H, W] the model is built for, the training patch) fixes
each stage's clamped window and so the shapes of the bias tables, as in
nnFormer; None builds them for the configured window (no stage clamps at
128³: grids 64-32-16-8).

Tracing: the forward's parts are spans of a profiler's trace
(`tracing.span`): `swinunetr.embed`; each Swin block as
`swinunetr.swin<i>.b<b>` with its branches `.attn` (norm1 through the
residual add) and `.mlp` nested in it, and in `.attn` the attention's core,
`swinunetr.swin<i>.b<b>.attn.core` (the bias lookup and
`multi_head_attention`); `swinunetr.merge<i>`; the conv blocks
`swinunetr.encoder<k>` and `swinunetr.decoder<k>` under their module names;
`swinunetr.out`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from micformer_tpu_torch import registry
from micformer_tpu_torch.models.layers import (
    InstanceNorm, PatchEmbed3D, PatchMergingLinear, SwinBlock3D,
)
from micformer_tpu_torch.tracing import span


class ResConvBlock(nn.Module):
    """UnetrBasicBlock: 2 x (conv k3, affine InstanceNorm), LeakyReLU 0.01
    between and after the residual add; a 1³ conv residual when the
    channels change."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv3d(in_ch, features, 3, padding=1)
        self.norm1 = InstanceNorm(features)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1)
        self.norm2 = InstanceNorm(features)
        self.res = None if in_ch == features else nn.Conv3d(in_ch, features, 1)

    def forward(self, x):
        h = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        h = self.norm2(self.conv2(h))
        return F.leaky_relu(h + (x if self.res is None else self.res(x)), 0.01)


class UpBlock(nn.Module):
    """UnetrUpBlock: transposed conv k2 s2, concatenated with the skip, a
    ResConvBlock."""

    def __init__(self, in_ch: int, skip_ch: int, features: int):
        super().__init__()
        self.up = nn.ConvTranspose3d(in_ch, features, 2, stride=2)
        self.block = ResConvBlock(features + skip_ch, features)

    def forward(self, x, skip):
        return self.block(torch.cat([self.up(x), skip], dim=1))


class SwinUNETR(nn.Module):
    """Input [B, in_channels, D, H, W]; logits [B, num_classes, D, H, W] in
    f32."""

    def __init__(self, num_classes: int = 8, feature_size: int = 12, depths=(2, 4, 2, 2),
                 num_heads=(2, 4, 8, 12), window_size=(7, 7, 7), in_channels: int = 2,
                 input_size=None):
        super().__init__()
        Fs = feature_size
        self.depths = list(depths)
        self.patch_embed = PatchEmbed3D(in_channels, Fs, (2, 2, 2), use_norm=False)
        # each stage's grid at input_size: the embed floors, the merges pad
        res = None
        if input_size is not None:
            size = (input_size,) * 3 if isinstance(input_size, int) else tuple(input_size)
            res = [tuple(s // 2 for s in size)]
            for _ in range(3):
                res.append(tuple(math.ceil(s / 2) for s in res[-1]))
        for i in range(4):
            dim = Fs * 2 ** i
            for b in range(depths[i]):
                block = SwinBlock3D(
                    dim, num_heads[i], window_size,
                    shift_size=tuple(w // 2 for w in window_size) if b % 2 else (0, 0, 0),
                    rel_pos_bias=True, input_size=None if res is None else res[i])
                name = f"swinunetr.swin{i}.b{b}"
                block.spans = (name, f"{name}.attn", f"{name}.mlp")
                block.attn.core_span = f"{name}.attn.core"
                self.add_module(f"swin{i}_b{b}", block)
            self.add_module(f"merge{i}", PatchMergingLinear(dim))
        self.encoder1 = ResConvBlock(in_channels, Fs)
        self.encoder2 = ResConvBlock(Fs, Fs)
        self.encoder3 = ResConvBlock(2 * Fs, 2 * Fs)
        self.encoder4 = ResConvBlock(4 * Fs, 4 * Fs)
        self.encoder10 = ResConvBlock(16 * Fs, 16 * Fs)
        self.decoder5 = UpBlock(16 * Fs, 8 * Fs, 8 * Fs)
        self.decoder4 = UpBlock(8 * Fs, 4 * Fs, 4 * Fs)
        self.decoder3 = UpBlock(4 * Fs, 2 * Fs, 2 * Fs)
        self.decoder2 = UpBlock(2 * Fs, Fs, Fs)
        self.decoder1 = UpBlock(Fs, Fs, Fs)
        self.out = nn.Conv3d(Fs, num_classes, 1)
        self._spans = {n: f"swinunetr.{n}" for n, _ in self.named_children()}

    def _run(self, name, *args):
        """Module `name` on args, as its span."""
        with span(self._spans[name]):
            return getattr(self, name)(*args)

    def forward(self, x, generator=None):
        x = x.to(self.out.weight.dtype)               # the weights' dtype
        with span("swinunetr.embed"):
            h = self.patch_embed(x.permute(0, 2, 3, 4, 1))
        hiddens = [h]
        for i in range(4):
            for b in range(self.depths[i]):
                h = getattr(self, f"swin{i}_b{b}")(h, generator)
            h = self._run(f"merge{i}", h)
            hiddens.append(h)
        cf = [t.permute(0, 4, 1, 2, 3) for t in hiddens]
        enc0 = self._run("encoder1", x)
        enc1 = self._run("encoder2", cf[0])
        enc2 = self._run("encoder3", cf[1])
        enc3 = self._run("encoder4", cf[2])
        d = self._run("decoder5", self._run("encoder10", cf[4]), cf[3])
        d = self._run("decoder4", d, enc3)
        d = self._run("decoder3", d, enc2)
        d = self._run("decoder2", d, enc1)
        d = self._run("decoder1", d, enc0)
        with span("swinunetr.out"):
            return self.out(d).float()


@registry.register("swinunetr", num_classes=8, feature_size=12, input_size=None)
def build_swinunetr(**kw):
    return SwinUNETR(**kw)
