"""TransUNet (3D) and its three conv U-Nets.

Counterpart of `micformer_tpu/models/transunet.py` (registry names
`transunet`, `unet_conv`, `halfunet`, `unet_patchify`; MM-WHS channels
16-32-64-128-190-256). Every level is a `DoubleConv`, with 2³ max pools
between levels and the skips tapped before each pool.
  - TransUNet: each skip is gated by the decoder state (`AttentionGate`)
    before the decoder's transposed conv, the concatenation (skip first)
    and a DoubleConv; `attention_gates=False` is the plain conv U-Net
    (`unet_conv`).
  - HalfUNet: an additive decoder (transposed conv, plus the skip), a 1³
    resize to `channel_outputconv` and `num_outputconv` DoubleConvs.
  - UNetPatch: a patch-embedding stem (conv k = s = patch), the raw input
    prepended to the skips, each skip through a channel-preserving
    DoubleConv (plus itself under `skip_leak`), the last decoder level
    expanding by the patch.
The JAX package runs the lane-starved levels W-packed and the gates'
patchify convs as matmuls by default, exact reformulations with the same
parameter trees; this is the plain math (the gates' convs with k = s = p
are a space-to-depth reshape and one matmul here too). Channels-first
[B, C, D, H, W]; module names follow the flax tree, so `convert.from_flax`
maps its weights.

A gate's patch is its skip's smallest extent over `patch_size_factor`, so
the gates' parameter shapes follow the input: TransUNet is built for
`input_size` ([D, H, W], the training patch; None: 128³, the published
patch), and an input whose patches differ raises.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from micformer_tpu_torch import registry
from micformer_tpu_torch.models.layers import DoubleConv
from micformer_tpu_torch.ops.attention import merge_heads, multi_head_attention, split_heads
from micformer_tpu_torch.ops.pe import sinusoidal_pe_3d_interleaved


def patchify(conv: nn.Conv3d, x: torch.Tensor):
    """conv (k = s = p, no padding) of [B, C, D, H, W] as tokens [B, L, E]
    in (d, h, w) order, by a space-to-depth reshape and one matmul; and the
    patch grid."""
    B, C, D, H, W = x.shape
    p = conv.kernel_size[0]
    g = (D // p, H // p, W // p)
    xs = x.reshape(B, C, g[0], p, g[1], p, g[2], p).permute(0, 2, 4, 6, 1, 3, 5, 7)
    w = conv.weight.reshape(conv.out_channels, -1)
    return F.linear(xs.reshape(B, g[0] * g[1] * g[2], -1), w, conv.bias), g


def unpatchify(tconv: nn.ConvTranspose3d, t: torch.Tensor, grid) -> torch.Tensor:
    """The transposed conv (k = s = p) of tokens [B, L, E] on `grid`: one
    matmul, then depth to space; [B, C, *grid·p]."""
    B = t.shape[0]
    p, C = tconv.kernel_size[0], tconv.out_channels
    y = (t @ tconv.weight.reshape(t.shape[-1], -1)).reshape(B, *grid, C, p, p, p)
    y = y.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(B, C, *(n * p for n in grid))
    return y + tconv.bias.view(1, C, 1, 1, 1)


class AttentionGate(nn.Module):
    """The skip gated by the decoder state: both patchified (conv k = s = p
    to `embed_size`) with the interleaved sinusoidal encoding added;
    `num_heads`-head attention of the skip's tokens (queries) to the
    decoder's; `out`; a transposed conv back to the skip's grid; plus the
    skip."""

    def __init__(self, skip_ch: int, dec_ch: int, embed_size: int = 64, num_heads: int = 8,
                 patch_size: int = 2):
        super().__init__()
        self.num_heads = num_heads
        p = patch_size
        self.embed_skip = nn.Conv3d(skip_ch, embed_size, p, stride=p)
        self.embed_dec = nn.Conv3d(dec_ch, embed_size, p, stride=p)
        self.q = nn.Linear(embed_size, embed_size)
        self.k = nn.Linear(embed_size, embed_size)
        self.v = nn.Linear(embed_size, embed_size)
        self.out = nn.Linear(embed_size, embed_size)
        self.upscale = nn.ConvTranspose3d(embed_size, skip_ch, p, stride=p)

    def forward(self, skip, dec):
        def tokens(conv, x):
            t, g = patchify(conv, x)
            pe = sinusoidal_pe_3d_interleaved(*g, t.shape[-1]).reshape(-1, t.shape[-1])
            return t + torch.from_numpy(pe).to(t.device, t.dtype), g

        q, grid = tokens(self.embed_skip, skip)
        kv, _ = tokens(self.embed_dec, dec)
        h = self.num_heads
        o = multi_head_attention(split_heads(self.q(q), h), split_heads(self.k(kv), h),
                                 split_heads(self.v(kv), h))
        return unpatchify(self.upscale, self.out(merge_heads(o)), grid) + skip


def _encode(mod: nn.Module, x: torch.Tensor, levels: int):
    """enc0 .. enc{levels-1}, a 2³ max pool after each but the last; (x, the
    skips before each pool)."""
    skips = []
    for i in range(levels):
        x = getattr(mod, f"enc{i}")(x)
        if i < levels - 1:
            skips.append(x)
            x = F.max_pool3d(x, 2)
    return x, skips


def _triple(size):
    return (size,) * 3 if isinstance(size, int) else tuple(size)


class TransUNet(nn.Module):
    """Input [B, in_channels, D, H, W]; logits [B, num_classes, D, H, W] in
    f32."""

    def __init__(self, num_classes: int = 8, num_channels_list=(16, 32, 64, 128, 190, 256),
                 patch_size_factor: int = 8, embed_size: int = 64, num_heads: int = 8,
                 attention_gates: bool = True, in_channels: int = 2, input_size=None):
        super().__init__()
        chs = list(num_channels_list)
        self.levels = len(chs)
        self.attention_gates = attention_gates
        self.patch_size_factor = patch_size_factor
        ch = in_channels
        for i, c in enumerate(chs):
            self.add_module(f"enc{i}", DoubleConv(ch, c))
            ch = c
        size = _triple(128 if input_size is None else input_size)
        for j, c in enumerate(chs[-2::-1]):
            level = len(chs) - 2 - j
            if attention_gates:
                patch = self._patch([s // 2 ** level for s in size])
                self.add_module(f"gate{j}", AttentionGate(c, ch, embed_size, num_heads, patch))
            self.add_module(f"up{j}", nn.ConvTranspose3d(ch, c, 2, stride=2))
            self.add_module(f"dec{j}", DoubleConv(2 * c, c))
            ch = c
        self.head = nn.Conv3d(ch, num_classes, 1)

    def _patch(self, extents) -> int:
        return max(min(extents) // self.patch_size_factor, 1)

    def forward(self, x, generator=None):
        x = x.to(self.head.weight.dtype)              # the weights' dtype
        x, skips = _encode(self, x, self.levels)
        for j in range(self.levels - 1):
            skip = skips[-1 - j]
            if self.attention_gates:
                gate = getattr(self, f"gate{j}")
                if self._patch(skip.shape[2:]) != gate.embed_skip.kernel_size[0]:
                    raise ValueError(f"transunet: a {tuple(skip.shape[2:])} skip takes patch "
                                     f"{self._patch(skip.shape[2:])}, but gate{j} is built for "
                                     f"{gate.embed_skip.kernel_size[0]}: build the model with "
                                     "the input_size it is called at")
                skip = gate(skip, x)
            x = getattr(self, f"up{j}")(x)
            x = getattr(self, f"dec{j}")(torch.cat([skip, x], dim=1))
        return self.head(x).float()


class HalfUNet(nn.Module):
    """Input [B, in_channels, D, H, W]; logits [B, num_classes, D, H, W] in
    f32."""

    def __init__(self, num_classes: int = 8, num_channels_list=(16, 32, 64, 128, 190, 256),
                 channel_outputconv: int = 64, num_outputconv: int = 2, in_channels: int = 2):
        super().__init__()
        chs = list(num_channels_list)
        self.levels = len(chs)
        self.num_outputconv = num_outputconv
        ch = in_channels
        for i, c in enumerate(chs):
            self.add_module(f"enc{i}", DoubleConv(ch, c))
            ch = c
        for j, c in enumerate(chs[-2::-1]):
            self.add_module(f"up{j}", nn.ConvTranspose3d(ch, c, 2, stride=2))
            ch = c
        self.resize = nn.Conv3d(ch, channel_outputconv, 1)
        ch = channel_outputconv
        for k in range(num_outputconv):
            cout = channel_outputconv if k < num_outputconv - 1 else chs[0]
            self.add_module(f"outconv{k}", DoubleConv(ch, cout))
            ch = cout
        self.head = nn.Conv3d(ch, num_classes, 1)

    def forward(self, x, generator=None):
        x = x.to(self.head.weight.dtype)
        x, skips = _encode(self, x, self.levels)
        for j in range(self.levels - 1):
            x = getattr(self, f"up{j}")(x) + skips[-1 - j]
        x = self.resize(x)
        for k in range(self.num_outputconv):
            x = getattr(self, f"outconv{k}")(x)
        return self.head(x).float()


class UNetPatch(nn.Module):
    """Input [B, in_channels, D, H, W]; logits [B, num_classes, D, H, W] in
    f32."""

    def __init__(self, num_classes: int = 8, num_channels_list=(16, 32, 64, 128, 190, 256),
                 channel_embedding: int = 32, patch_size: int = 2, skip_leak: bool = False,
                 in_channels: int = 2):
        super().__init__()
        chs = list(num_channels_list)
        self.levels = len(chs)
        self.skip_leak = skip_leak
        p = patch_size
        self.patch_embed = nn.Conv3d(in_channels, channel_embedding, p, stride=p)
        ch = channel_embedding
        for i, c in enumerate(chs):
            self.add_module(f"enc{i}", DoubleConv(ch, c))
            ch = c
        skip_chs = [in_channels] + chs[:-1]
        for i, c in enumerate(skip_chs):
            self.add_module(f"skip{i}", DoubleConv(c, c))
        dec_chs = ([in_channels] + chs)[-2::-1]          # ends at in_channels
        for j, c in enumerate(dec_chs):
            up = p if j == len(dec_chs) - 1 else 2
            self.add_module(f"up{j}", nn.ConvTranspose3d(ch, c, up, stride=up))
            self.add_module(f"dec{j}", DoubleConv(skip_chs[-1 - j] + c, c))
            ch = c
        self.head = nn.Conv3d(ch, num_classes, 1)

    def forward(self, x, generator=None):
        x = x.to(self.head.weight.dtype)
        raw = x
        x, skips = _encode(self, self.patch_embed(x), self.levels)
        skips = [raw] + skips
        mod = []
        for i, s in enumerate(skips):
            m = getattr(self, f"skip{i}")(s)
            mod.append(m + s if self.skip_leak else m)
        for j in range(self.levels):
            x = getattr(self, f"up{j}")(x)
            x = getattr(self, f"dec{j}")(torch.cat([mod[-1 - j], x], dim=1))
        return self.head(x).float()


@registry.register("transunet", num_classes=8, input_size=None)
def build_transunet(**kw):
    return TransUNet(**kw)


@registry.register("unet_conv", num_classes=8)
def build_unet_conv(**kw):
    """The TransUnet repo's plain conv U-Net: TransUNet without the gates."""
    kw.setdefault("attention_gates", False)
    return TransUNet(**kw)


@registry.register("halfunet", num_classes=8)
def build_halfunet(**kw):
    return HalfUNet(**kw)


@registry.register("unet_patchify", num_classes=8)
def build_unet_patchify(**kw):
    return UNetPatch(**kw)
