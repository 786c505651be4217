"""MedNeXt: ConvNeXt-style 3-D segmentation network, on [B, C, D, H, W].

Counterpart of `micformer_tpu/models/mednext.py` in its default forms:
MedNeXtBlock (same, down and up modes, both `faithful_up` forms) and MedNeXt
with the deep-supervision pyramid. The JAX package's blocked, class-packed
and W-packed forms (`_up_blocked`, `_up_packed`, `MedNeXtBlockW`) are TPU
layouts of the same math and are not ported. Submodules carry the flax
names (`stem`, `enc{s}_{b}`, `down{s}`, `bottleneck_{b}`, `up{s}`,
`dec{s}_{b}`, `out`, `ds{i}`; `dw`, `norm`, `expand`, `compress`, `res` in a
block), so `convert.from_flax` maps the flax tree with no renames.

Tracing: the forward's parts are spans of a profiler's trace
(`tracing.span`): `mednext.stem`, per stage s `mednext.enc<s>` and
`mednext.down<s>`, `mednext.bottleneck`, per stage `mednext.up<s>` (the up
block and the skip's add) and `mednext.dec<s>`, then `mednext.head`.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from micformer_tpu_torch import registry
from micformer_tpu_torch.models.layers import (
    DepthwiseConv3D, InstanceNorm, PointwiseConv, PointwiseTranspose2, zero_dilate,
)
from micformer_tpu_torch.tracing import span

# the leading zero plane per spatial axis of the faithful up block
_LEAD = (1, 0, 1, 0, 1, 0)


class MedNeXtBlock(nn.Module):
    """depthwise k³ conv -> InstanceNorm -> 1³ expand (×exp_r) -> exact GELU
    -> 1³ compress, plus a residual.

    mode "same": stride-1 SAME depthwise conv (the kernel), identity residual.
    mode "down": stride-2 depthwise conv, 1³ stride-2 residual.
    mode "up": 2× upsampling. faithful_up=False (default) is the fused
    transpose conv straight to 2L with the PointwiseTranspose2 residual;
    faithful_up=True convs the zero-dilated input at padding k//2 (2L-1) and
    pads the leading plane after, for both branches."""

    def __init__(self, in_channels: int, out_channels: int, exp_r: int = 4,
                 kernel: int = 3, mode: str = "same", faithful_up: bool = False):
        super().__init__()
        C, p = in_channels, kernel // 2
        if mode not in ("same", "down", "up"):
            raise ValueError(f"MedNeXtBlock: unknown mode {mode!r}")
        if mode == "same" and out_channels != C:
            raise ValueError("MedNeXtBlock: a same-mode block keeps its channels")
        self.mode, self.faithful_up = mode, faithful_up
        if mode == "down":
            self.dw = DepthwiseConv3D(C, kernel, stride=2)
        elif mode == "up" and not faithful_up:
            self.dw = DepthwiseConv3D(C, kernel, transpose2=True)
        elif mode == "up":
            self.dw = DepthwiseConv3D(C, kernel, pad=((p, p),) * 3)
        else:
            self.dw = DepthwiseConv3D(C, kernel)
        self.norm = InstanceNorm(C)
        self.expand = PointwiseConv(C, exp_r * C)
        self.compress = PointwiseConv(exp_r * C, out_channels)
        if mode == "down":
            self.res = PointwiseConv(C, out_channels, stride=2)
        elif mode == "up":
            self.res = (PointwiseConv(C, out_channels) if faithful_up
                        else PointwiseTranspose2(C, out_channels))

    def forward(self, x):
        faithful = self.mode == "up" and self.faithful_up
        h = self.dw(zero_dilate(x) if faithful else x)
        h = self.compress(F.gelu(self.expand(self.norm(h))))
        if self.mode == "same":
            return h + x
        if faithful:
            return F.pad(h, _LEAD) + F.pad(self.res(zero_dilate(x)), _LEAD)
        return h + self.res(x)


_SIZES = {
    "S": dict(exp_r=[2] * 9, block_counts=[2] * 9),
    "B": dict(exp_r=[2, 3, 4, 4, 4, 4, 4, 3, 2], block_counts=[2] * 9),
    "M": dict(exp_r=[2, 3, 4, 4, 4, 4, 4, 3, 2], block_counts=[3, 4, 4, 4, 4, 4, 4, 4, 3]),
    "L": dict(exp_r=[3, 4, 8, 8, 8, 8, 8, 4, 3], block_counts=[3, 4, 8, 8, 8, 8, 8, 4, 3]),
}


class MedNeXt(nn.Module):
    """Input [B, 2, D, H, W] -> logits [B, num_classes, D, H, W] f32, or with
    deep supervision the pyramid [full, 1/2, 1/4, 1/8, 1/16] of f32 logits.

    Stem 1³ conv to n_channels, four encoder stages (C·2^s) each followed by
    a down block, a bottleneck at 16·C, four decoder stages each after an up
    block and an additive skip, and a 1³ head. Spatial sizes must be
    multiples of 16."""

    def __init__(self, num_classes: int = 8, n_channels: int = 32,
                 exp_r: Sequence[int] = (2,) * 9, kernel: int = 3,
                 block_counts: Sequence[int] = (2,) * 9,
                 deep_supervision: bool = False, faithful_up: bool = False,
                 in_channels: int = 2):
        super().__init__()
        n, er, bc = n_channels, list(exp_r), list(block_counts)
        self.block_counts = bc
        self.deep_supervision = deep_supervision
        self.stem = PointwiseConv(in_channels, n)
        for s in range(4):
            c = n * 2 ** s
            for b in range(bc[s]):
                self.add_module(f"enc{s}_{b}", MedNeXtBlock(c, c, er[s], kernel))
            self.add_module(f"down{s}", MedNeXtBlock(c, 2 * c, er[s + 1], kernel,
                                                     mode="down"))
        for b in range(bc[4]):
            self.add_module(f"bottleneck_{b}", MedNeXtBlock(16 * n, 16 * n, er[4], kernel))
        for s in range(4):
            c_out = n * 2 ** (3 - s)
            self.add_module(f"up{s}", MedNeXtBlock(2 * c_out, c_out, er[5 + s], kernel,
                                                   mode="up", faithful_up=faithful_up))
            for b in range(bc[5 + s]):
                self.add_module(f"dec{s}_{b}", MedNeXtBlock(c_out, c_out, er[5 + s], kernel))
        self.out = PointwiseConv(n, num_classes)
        if deep_supervision:
            for i in range(1, 5):
                self.add_module(f"ds{i}", PointwiseConv(n * 2 ** i, num_classes))
        self._spans = {part: [f"mednext.{part}{s}" for s in range(4)]
                       for part in ("enc", "down", "up", "dec")}

    def forward(self, x, generator=None):
        """`generator` is accepted so a trainer calls every model alike;
        MedNeXt has no stochastic layer (the JAX `deterministic` argument is
        unused too)."""
        bc, spans = self.block_counts, self._spans
        with span("mednext.stem"):
            x = self.stem(x.to(self.out.weight.dtype))
        skips = []
        for s in range(4):
            with span(spans["enc"][s]):
                for b in range(bc[s]):
                    x = getattr(self, f"enc{s}_{b}")(x)
            skips.append(x)
            with span(spans["down"][s]):
                x = getattr(self, f"down{s}")(x)
        with span("mednext.bottleneck"):
            for b in range(bc[4]):
                x = getattr(self, f"bottleneck_{b}")(x)
            ds = [self.ds4(x)] if self.deep_supervision else []
        for s in range(4):
            with span(spans["up"][s]):
                x = getattr(self, f"up{s}")(x) + skips[3 - s]
            with span(spans["dec"][s]):
                for b in range(bc[5 + s]):
                    x = getattr(self, f"dec{s}_{b}")(x)
                if self.deep_supervision and s < 3:
                    ds.append(getattr(self, f"ds{3 - s}")(x))
        with span("mednext.head"):
            logits = self.out(x).float()
            if self.deep_supervision:
                return [logits] + [d.float() for d in reversed(ds)]
            return logits


@registry.register("mednext", num_classes=8, size="S", kernel=3, deep_supervision=False)
def build_mednext(num_classes=8, size="S", kernel=3, deep_supervision=False,
                  faithful_up=False, n_channels=32, in_channels=2):
    """`n_channels` (the stem width, 32 in every published size) narrows
    the model for small runs on the CPU; `in_channels` is the stem's input
    (1 single-modal; + num_classes - 1 under the cascade)."""
    cfg = _SIZES[size]
    return MedNeXt(num_classes=num_classes, n_channels=n_channels, kernel=kernel,
                   exp_r=cfg["exp_r"], block_counts=cfg["block_counts"],
                   deep_supervision=deep_supervision, faithful_up=faithful_up,
                   in_channels=in_channels)
