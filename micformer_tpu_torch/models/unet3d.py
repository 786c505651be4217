"""3D U-Net, the reference's MONAI UNet configuration.

Counterpart of `micformer_tpu/models/unet3d.py` (registry name `unet3d`):
channels 4-8-16-32-64 by default; Conv -> InstanceNorm (not affine) ->
PReLU units (`ConvNormAct`), a stride-2 conv into every level below the
first, transposed-conv up, skip concatenation, a 1³ head. Channels-first
[B, C, D, H, W]; module names follow the flax tree (`down{i}`, `bottom`,
`up{i}`, `dec{i}`, `head`), so `convert.from_flax` maps its weights.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from micformer_tpu_torch import registry
from micformer_tpu_torch.models.layers import ConvNormAct


class UNet3D(nn.Module):
    """Input [B, in_channels, D, H, W], logits [B, num_classes, D, H, W] in
    f32. `in_channels` is the torch model's own: flax infers it."""

    def __init__(self, num_classes: int = 8, channels=(4, 8, 16, 32, 64),
                 in_channels: int = 2):
        super().__init__()
        chs = list(channels)
        self.levels = len(chs) - 1
        ch = in_channels
        for i, c in enumerate(chs[:-1]):
            self.add_module(f"down{i}", ConvNormAct(ch, c, stride=2 if i > 0 else 1))
            ch = c
        self.bottom = ConvNormAct(ch, chs[-1], stride=2)
        ch = chs[-1]
        for i in reversed(range(self.levels)):
            self.add_module(f"up{i}", ConvNormAct(ch, chs[i], stride=2, transpose=True))
            self.add_module(f"dec{i}", ConvNormAct(2 * chs[i], chs[i]))
            ch = chs[i]
        self.head = nn.Conv3d(ch, num_classes, 1)

    def forward(self, x, generator=None):
        """`generator` is accepted so a trainer calls every model alike;
        nothing here draws. x is cast to the weights' dtype (bf16 serving)."""
        x = x.to(self.head.weight.dtype)
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"down{i}")(x)
            skips.append(x)
        x = self.bottom(x)
        for i in reversed(range(self.levels)):
            x = getattr(self, f"up{i}")(x)
            x = getattr(self, f"dec{i}")(torch.cat([x, skips[i]], dim=1))
        return self.head(x).float()


@registry.register("unet3d", num_classes=8, channels=(4, 8, 16, 32, 64))
def build_unet3d(**kw):
    return UNet3D(**kw)
