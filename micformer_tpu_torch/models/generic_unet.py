"""The plan-driven Generic U-Net (nnU-Net's dynamic architecture), 3D or 2D.

Counterpart of `micformer_tpu/models/generic_unet.py` (registry name
`generic_unet`): per-stage pool and conv kernels from an experiment plan, so
anisotropic data gets anisotropic schedules; the kernel rank selects 3D or
2D. conv_per_stage blocks of conv -> affine InstanceNorm -> LeakyReLU(0.01);
stage i > 0 opens with a conv strided by the plan's pool kernel; transposed
convs (kernel = stride = the pool kernel) go up, the skip is concatenated,
and 1³ (1²) seg heads read each decoder stage under deep supervision (the
full-resolution one alone otherwise). Widths double from
base_num_features, capped at max_features (320 in 3D, 512 in 2D from a
plan).

Channels-first [B, C, *spatial]. Convs pad as flax's "SAME" does (for a
stride s and kernel k over n: total max((ceil(n/s) - 1)·s + k - n, 0), the
lower half first, so a stride-2 k3 conv over an even extent pads (0, 1)).
`in_channels` is the torch model's own: flax infers it from the input.
Module names follow the flax tree (`enc{i}_conv{c}`, `dec{j}_conv{c}`,
`up{j}`, `seg{j}`; a block's `conv` and `norm` are flax's `Conv_0` and
`InstanceNorm_0`), so `convert.from_flax` maps its weights.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from micformer_tpu_torch import registry
from micformer_tpu_torch.models.layers import InstanceNorm, conv_same, same_pads  # noqa: F401


def _conv_cls(ndim: int, transpose: bool = False):
    if ndim == 3:
        return nn.ConvTranspose3d if transpose else nn.Conv3d
    return nn.ConvTranspose2d if transpose else nn.Conv2d


class ConvInLRelu(nn.Module):
    """conv -> affine InstanceNorm -> LeakyReLU(0.01) (nnU-Net's
    ConvDropoutNormNonlin without dropout)."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=None):
        super().__init__()
        kernel = tuple(kernel)
        stride = tuple(stride) if stride else (1,) * len(kernel)
        self.conv = _conv_cls(len(kernel))(in_ch, out_ch, kernel, stride=stride)
        self.norm = InstanceNorm(out_ch)

    def forward(self, x):
        return F.leaky_relu(self.norm(conv_same(self.conv, x)), 0.01)


class GenericUNet(nn.Module):
    """Input [B, in_channels, *spatial] (rank from the kernels' length),
    logits [B, num_classes, *spatial]; with deep supervision a list of the
    seg heads' logits, highest resolution first."""

    def __init__(self, num_classes: int = 8, base_num_features: int = 32,
                 pool_kernels=((2, 2, 2),) * 5, conv_kernels=((3, 3, 3),) * 6,
                 conv_per_stage: int = 2, max_features: int = 320,
                 deep_supervision: bool = False, in_channels: int = 2):
        super().__init__()
        self.pool_kernels = [tuple(p) for p in pool_kernels]
        self.conv_kernels = [tuple(k) for k in conv_kernels]
        if len(self.conv_kernels) != len(self.pool_kernels) + 1:
            raise ValueError("need one conv kernel schedule per resolution stage")
        self.conv_per_stage = conv_per_stage
        self.deep_supervision = deep_supervision
        n_stages = len(self.conv_kernels)
        ndim = len(self.conv_kernels[0])

        def width(i):
            return min(base_num_features * 2 ** i, max_features)

        ch = in_channels
        for i in range(n_stages):
            stride = self.pool_kernels[i - 1] if i > 0 else None
            for c in range(conv_per_stage):
                self.add_module(f"enc{i}_conv{c}", ConvInLRelu(
                    ch, width(i), self.conv_kernels[i], stride if c == 0 else None))
                ch = width(i)
        for j in range(n_stages - 2, -1, -1):
            up = self.pool_kernels[j]
            self.add_module(f"up{j}", _conv_cls(ndim, transpose=True)(ch, width(j), up,
                                                                       stride=up))
            ch = 2 * width(j)
            for c in range(conv_per_stage):
                self.add_module(f"dec{j}_conv{c}", ConvInLRelu(ch, width(j),
                                                               self.conv_kernels[j]))
                ch = width(j)
            if deep_supervision or j == 0:
                self.add_module(f"seg{j}", _conv_cls(ndim)(ch, num_classes, 1))

    def forward(self, x, generator=None):
        """`generator` is accepted so a trainer calls every model alike;
        nothing here draws."""
        n_stages = len(self.conv_kernels)
        skips = []
        for i in range(n_stages):
            for c in range(self.conv_per_stage):
                x = getattr(self, f"enc{i}_conv{c}")(x)
            if i < n_stages - 1:
                skips.append(x)
        seg_outputs = []
        for j in range(n_stages - 2, -1, -1):
            x = torch.cat([getattr(self, f"up{j}")(x), skips[j]], dim=1)
            for c in range(self.conv_per_stage):
                x = getattr(self, f"dec{j}_conv{c}")(x)
            if self.deep_supervision or j == 0:
                seg_outputs.append(getattr(self, f"seg{j}")(x).float())
        return seg_outputs[::-1] if self.deep_supervision else seg_outputs[-1]


def build_from_plan(plan: dict, num_classes: int | None = None,
                    deep_supervision: bool = False, in_channels: int = 2) -> GenericUNet:
    """GenericUNet of an experiment plan (its pool_op_kernel_sizes,
    conv_kernel_sizes, base_num_features and classes), as nnU-Net's
    trainers build it; no planner needed."""
    pools = [tuple(p) for p in plan["pool_op_kernel_sizes"]]
    convs = [tuple(k) for k in plan["conv_kernel_sizes"]]
    k = num_classes if num_classes is not None else len(plan.get("classes", [])) or 8
    return GenericUNet(num_classes=k, base_num_features=plan.get("base_num_features", 32),
                       pool_kernels=pools, conv_kernels=convs,
                       max_features=320 if len(convs[0]) == 3 else 512,
                       deep_supervision=deep_supervision, in_channels=in_channels)


@registry.register("generic_unet", num_classes=8)
def build_generic_unet(**kw):
    if "plan" in kw:
        return build_from_plan(kw.pop("plan"), **kw)
    return GenericUNet(**kw)
