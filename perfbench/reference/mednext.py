"""MedNeXt (arXiv:2303.09975; MedNeXt/train_mmwhs_noPad.py:92-95) in plain f32
PyTorch, for judging the program's output and its training step.

ConvNeXt-style blocks on [B, C, D, H, W]: depthwise k³ conv, InstanceNorm,
1³ expand, exact GELU, 1³ compress, plus a residual. A stem 1³ conv, four
encoder stages (C·2^s) each followed by a stride-2 down block (residual: a
1³ conv of the even voxels), a bottleneck at 16·C, four decoder stages each
after a transposed up block (the depthwise conv of the zero-dilated input,
padded (k//2 + 1, k//2), exactly twice the extent; residual: a 1³ conv of the
lead-padded zero-dilated input) and an additive skip, and a 1³ head. Every
conv is `F.conv3d`; the up block's is taken one output parity at a time, so
no zero is multiplied. Parameter names follow the program's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.common import Conv, Precision, gelu


def up_conv(x, conv: Conv):
    """The depthwise 3³ conv of the zero-dilated input padded (2, 1) on each
    axis, [B, C, L...] -> [B, C, 2L...], computed by output parity: an even
    output 2i reads taps 0 and 2 at x[i-1] and x[i], an odd one tap 1 at
    x[i], so each of the 8 parity classes is a small conv of x and no zero
    is multiplied."""
    B, C, D, H, W = x.shape
    xp = F.pad(x, (1, 0, 1, 0, 1, 0))
    out = x.new_empty((B, C, 2 * D, 2 * H, 2 * W))
    taps = {0: [0, 2], 1: [1]}
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                w = conv.weight[:, :, taps[a]][:, :, :, taps[b]][:, :, :, :, taps[c]]
                inp = xp[:, :, a:, b:, c:]
                out[:, :, a::2, b::2, c::2] = F.conv3d(conv.p.q(inp), conv.p.q(w), conv.bias,
                                                       groups=C)
    return out


class Norm(nn.Module):
    """Per-sample, per-channel norm over space (biased variance), affine."""

    def __init__(self, C, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(C))
        self.bias = nn.Parameter(torch.zeros(C))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(2, 3, 4), unbiased=False, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.weight.view(1, -1, 1, 1, 1) + self.bias.view(1, -1, 1, 1, 1)


class Block(nn.Module):
    def __init__(self, cin, cout, exp_r, k, p: Precision, mode="same"):
        super().__init__()
        self.mode, self.k = mode, k
        self.dw = Conv(cin, cin, k, p, groups=cin)
        self.norm = Norm(cin)
        self.expand = Conv(cin, exp_r * cin, 1, p)
        self.compress = Conv(exp_r * cin, cout, 1, p)
        if mode in ("down", "up"):
            self.res = Conv(cin, cout, 1, p)

    def forward(self, x):
        r = self.k // 2
        if self.mode == "up":
            h = up_conv(x, self.dw)
        else:
            h = self.dw(F.pad(x, (r, r) * 3), stride=2 if self.mode == "down" else 1)
        h = self.compress(gelu(self.expand(self.norm(h))))
        if self.mode == "same":
            return h + x
        if self.mode == "down":
            return h + self.res(x[:, :, ::2, ::2, ::2])
        # the 1³ conv of the lead-padded zero-dilated input: the bias
        # everywhere, plus W·x at the all-odd voxels
        res = self.res.bias.view(1, -1, 1, 1, 1).expand_as(h).clone()
        res[:, :, 1::2, 1::2, 1::2] += self.res(x) - self.res.bias.view(1, -1, 1, 1, 1)
        return h + res


class MedNeXt(nn.Module):
    """[B, 2, D, H, W] -> f32 logits [B, num_classes, D, H, W]; D, H, W
    multiples of 16. The widths are the configuration's: the stem's
    `n_channels`, and of each of the 9 stages (4 encoder, the bottleneck, 4
    decoder) its expansion `exp_r` and its number of blocks."""

    def __init__(self, num_classes, n_channels, exp_r, kernel, block_counts, in_channels=2,
                 fp8=False):
        super().__init__()
        p = Precision(fp8)
        er, bc = list(exp_r), list(block_counts)
        n = n_channels
        self.bc = bc
        self.stem = Conv(in_channels, n, 1, p)
        for s in range(4):
            c = n * 2 ** s
            for b in range(bc[s]):
                self.add_module(f"enc{s}_{b}", Block(c, c, er[s], kernel, p))
            self.add_module(f"down{s}", Block(c, 2 * c, er[s + 1], kernel, p, "down"))
        for b in range(bc[4]):
            self.add_module(f"bottleneck_{b}", Block(16 * n, 16 * n, er[4], kernel, p))
        for s in range(4):
            c = n * 2 ** (3 - s)
            self.add_module(f"up{s}", Block(2 * c, c, er[5 + s], kernel, p, "up"))
            for b in range(bc[5 + s]):
                self.add_module(f"dec{s}_{b}", Block(c, c, er[5 + s], kernel, p))
        self.out = Conv(n, num_classes, 1, p)

    def forward(self, x):
        x = self.stem(x.float())
        skips = []
        for s in range(4):
            for b in range(self.bc[s]):
                x = getattr(self, f"enc{s}_{b}")(x)
            skips.append(x)
            x = getattr(self, f"down{s}")(x)
        for b in range(self.bc[4]):
            x = getattr(self, f"bottleneck_{b}")(x)
        for s in range(4):
            x = getattr(self, f"up{s}")(x) + skips[3 - s]
            for b in range(self.bc[5 + s]):
                x = getattr(self, f"dec{s}_{b}")(x)
        return self.out(x)
