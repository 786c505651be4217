"""MicFormer: dual-stream cross-modal Swin U-shape with deformable windowed
cross-attention.

Counterpart of `micformer_tpu/models/micformer.py`: CrossBlock3D,
DualStreamStage (unrolled) and MicFormer with the two-op head (transposed
conv k=s=patch, then a k3 conv), of which the JAX package's fused head is an
exact reformulation. Submodules carry the JAX parameter tree's names where
it names them, so `convert.from_flax` maps one onto the other.

Training: `model.train()` turns DropPath on (drawing from the generator the
caller passes to `forward`); `use_remat` recomputes each block's activations
in the backward (`torch.utils.checkpoint`, non-reentrant), the counterpart of
the JAX `nn.remat`; `fused_attention` runs every attention through the fused
kernel K2 on the card (the JAX MICFORMER_FUSED_ATTENTION=1).

Tracing: the forward's parts are spans of a profiler's trace
(`tracing.span`): `micformer.embed`, each block as
`micformer.<stage>.<block>` (`micformer.enc2.cross1_3`), each stage's
resample `micformer.<stage>.resample`, `micformer.bottleneck`,
`micformer.dec<i>.skip` and `micformer.head`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from micformer_tpu_torch import registry
from micformer_tpu_torch.models.layers import (
    LN_EPS, DropPath, Mlp, PatchEmbed3D, PatchExpandConv, PatchMergingConv,
    SwinBlock3D, WindowAttention3D, conv_cl, pad_to_multiple,
)
from micformer_tpu_torch.ops.warp import reference_points, stn_warp
from micformer_tpu_torch.ops.windows import (
    adjust_window_shift, window_partition, window_reverse,
)
from micformer_tpu_torch.tracing import span


class CrossBlock3D(nn.Module):
    """Deformable-warp windowed cross-attention block.

    The offset net reads concat(LN(x), xa) (conv k3 2C -> 16 with bias, LN,
    exact GELU, conv 1³ 16 -> 3 without bias); offsets plus the reference
    grid warp xa, and windows of LN(x) attend to windows of the warped xa.
    Then the pre-norm MLP. Each of four parts is a span (`spans`: the
    offset net with the reference grid, the warp, the attention, the MLP),
    which the stage names after the block."""

    spans = tuple(f"micformer.cross.{part}" for part in ("offset", "warp", "attn", "mlp"))

    def __init__(self, dim: int, num_heads: int, window_size=(2, 2, 2),
                 hidden_channels: int = 16, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0,
                 faithful_grid: bool = True, fused_attention: bool = False):
        super().__init__()
        self.window_size = tuple(window_size)
        self.faithful_grid = faithful_grid
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.offset_conv1 = nn.Conv3d(2 * dim, hidden_channels, 3, padding=1)
        self.offset_norm = nn.LayerNorm(hidden_channels, eps=LN_EPS)
        self.offset_conv2 = nn.Conv3d(hidden_channels, 3, 1, bias=False)
        self.cross_attn = WindowAttention3D(dim, num_heads, qkv_bias, cross=True,
                                            fused_attention=fused_attention)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, xa, generator=None):
        offset, warp, attn, mlp = self.spans
        B, D, H, W, C = x.shape
        ws = adjust_window_shift((D, H, W), self.window_size)
        with span(offset):
            xn = pad_to_multiple(self.norm1(x), ws)
            xap = pad_to_multiple(xa, ws)
            _, Dp, Hp, Wp, _ = xn.shape

            off = conv_cl(self.offset_conv1, torch.cat([xn, xap], dim=-1))
            off = F.gelu(self.offset_norm(off))
            off = self.offset_conv2(off.permute(0, 4, 1, 2, 3))     # [B, 3, Dp, Hp, Wp]
            ref = reference_points(Dp, Hp, Wp, self.faithful_grid, device=x.device)
        with span(warp):
            xa_warp = stn_warp(xap, off.float() + ref)
        with span(attn):
            a = self.cross_attn(window_partition(xn, ws),
                                context=window_partition(xa_warp, ws))
            a = window_reverse(a, ws, B, Dp, Hp, Wp)[:, :D, :H, :W]
            x = x + self.drop_path(a, generator)
        with span(mlp):
            return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class DualStreamStage(nn.Module):
    """depth x (self block per stream, then cross blocks both ways), then one
    resample module shared by both streams. Returns the pre-resample streams
    and the resampled ones. use_remat checkpoints each block (see
    `_block`). `name` (`enc2`, `dec1`) names the stage's spans."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size=(2, 2, 2), drop_paths: Sequence[float] = (0.0,),
                 resample: str | None = None, qkv_bias: bool = True,
                 faithful_grid: bool = True, use_remat: bool = False,
                 fused_attention: bool = False, name: str = "stage"):
        super().__init__()
        self.depth = depth
        self.use_remat = use_remat
        parts = [f"{kind}_{i}" for i in range(depth) for kind in ("self1", "self2", "cross1",
                                                                   "cross2")]
        self._spans = {p: f"micformer.{name}.{p}" for p in parts + ["resample"]}
        for i in range(depth):
            dp = drop_paths[i] if i < len(drop_paths) else drop_paths[-1]
            common = dict(dim=dim, num_heads=num_heads, window_size=window_size,
                          qkv_bias=qkv_bias, drop_path=dp,
                          fused_attention=fused_attention)
            self.add_module(f"self1_{i}", SwinBlock3D(**common))
            self.add_module(f"self2_{i}", SwinBlock3D(**common))
            for cross in (f"cross1_{i}", f"cross2_{i}"):
                block = CrossBlock3D(faithful_grid=faithful_grid, **common)
                block.spans = tuple(f"{self._spans[cross]}.{part}"
                                    for part in ("offset", "warp", "attn", "mlp"))
                self.add_module(cross, block)
        self.downsample = PatchMergingConv(dim) if resample == "merge" else None
        self.upsample = PatchExpandConv(dim) if resample == "expand" else None

    def _block(self, name, *args, generator=None):
        """Run block `name` on args; under use_remat with autograd on, through
        a non-reentrant checkpoint whose recompute replays the generator's
        draws (it sets the generator to its state before the block, then
        back to where it was), so DropPath keeps the same masks. The call
        is the block's span."""
        block = getattr(self, name)
        with span(self._spans[name]):
            if not (self.use_remat and torch.is_grad_enabled()):
                return block(*args, generator)
            start = None if generator is None else generator.get_state()
            first = [True]

            def run(*a):
                if first[0] or generator is None:
                    first[0] = False
                    return block(*a, generator)
                now = generator.get_state()
                generator.set_state(start)
                try:
                    return block(*a, generator)
                finally:
                    generator.set_state(now)

            return checkpoint(run, *args, use_reentrant=False)

    def forward(self, x, xa, generator=None):
        for i in range(self.depth):
            x = self._block(f"self1_{i}", x, generator=generator)
            xa = self._block(f"self2_{i}", xa, generator=generator)
            # cross2 reads the x from before cross1 updated it
            x, xa = (self._block(f"cross1_{i}", x, xa, generator=generator),
                     self._block(f"cross2_{i}", xa, x, generator=generator))
        resample = self.downsample if self.downsample is not None else self.upsample
        if resample is None:
            return x, xa, x, xa
        with span(self._spans["resample"]):
            return x, xa, resample(x), resample(xa)


class MicFormer(nn.Module):
    """Input [B, 2(CT, MR), D, H, W] -> logits [B, num_classes, D, H, W] f32.

    Both streams share the patch embed, each stage's resample module, the
    bottleneck norm and the decoder's skip projections (concat_back{i})."""

    def __init__(self, num_classes: int = 8, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size=(2, 2, 2), patch_size=(4, 4, 4),
                 drop_path_rate: float = 0.2, faithful_grid: bool = True,
                 use_remat: bool = False, fused_attention: bool = False):
        super().__init__()
        n = len(depths)
        self.n_layers = n
        self.patch_embed = PatchEmbed3D(1, embed_dim, patch_size, use_norm=False)
        dpr = list(np.linspace(0, drop_path_rate, sum(depths)))

        def stage(i, resample, name):
            return DualStreamStage(
                embed_dim * 2 ** i, depths[i], num_heads[i], window_size,
                drop_paths=tuple(dpr[sum(depths[:i]):sum(depths[:i + 1])]),
                resample=resample, faithful_grid=faithful_grid, use_remat=use_remat,
                fused_attention=fused_attention, name=name)

        for i in range(n):
            self.add_module(f"enc{i}", stage(i, "merge" if i < n - 1 else None, f"enc{i}"))
        self.norm = nn.LayerNorm(embed_dim * 2 ** (n - 1), eps=LN_EPS)
        for inx, i in enumerate(reversed(range(n))):
            dim = embed_dim * 2 ** i
            if inx > 0:
                self.add_module(f"concat_back{inx}", nn.Linear(2 * dim, dim))
            self.add_module(f"dec{inx}", stage(i, "expand" if i > 0 else None, f"dec{inx}"))
        self.norm2 = nn.LayerNorm(2 * embed_dim, eps=LN_EPS)
        self.reverse_patch_embed = nn.ConvTranspose3d(
            2 * embed_dim, embed_dim // 2, patch_size, stride=patch_size)
        self.out_conv = nn.Conv3d(embed_dim // 2, num_classes, 3, padding=1)
        self._skip_spans = [f"micformer.dec{inx}.skip" for inx in range(n)]

    def forward(self, x, generator: torch.Generator | None = None):
        with span("micformer.embed"):
            x = x.to(self.out_conv.weight.dtype)
            moving = self.patch_embed(x[:, 0:1].permute(0, 2, 3, 4, 1))
            fixed = self.patch_embed(x[:, 1:2].permute(0, 2, 3, 4, 1))

        n = self.n_layers
        feats_m, feats_f = [], []
        for i in range(n):
            m_out, f_out, moving, fixed = getattr(self, f"enc{i}")(moving, fixed, generator)
            feats_m.append(m_out)
            feats_f.append(f_out)
        with span("micformer.bottleneck"):
            moving, fixed = self.norm(moving), self.norm(fixed)

        for inx in range(n):
            if inx > 0:
                with span(self._skip_spans[inx]):
                    back = getattr(self, f"concat_back{inx}")
                    moving = back(torch.cat([moving, feats_m[n - 1 - inx]], dim=-1))
                    fixed = back(torch.cat([fixed, feats_f[n - 1 - inx]], dim=-1))
            _, _, moving, fixed = getattr(self, f"dec{inx}")(moving, fixed, generator)

        with span("micformer.head"):
            out = self.norm2(torch.cat([moving, fixed], dim=-1))
            out = self.out_conv(self.reverse_patch_embed(out.permute(0, 4, 1, 2, 3)))
            return out.float()


@registry.register("micformer", num_classes=8, embed_dim=48)
def build_micformer(**kw):
    return MicFormer(**kw)
