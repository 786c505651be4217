"""Plain PyTorch pieces the reference models share: parameter holders whose
forward is a plain functional call, the precision hook, the tiled blend of
the serving path, and the training step's augmentation, loss and Adam.

Nothing here imports the program under test. Every matmul and conv input
passes through `Precision.q`, the identity for the reference and an fp8
(e4m3, per-tensor scale) round trip for the lower-precision control.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0     # largest finite float8_e4m3fn


class _FakeFp8(torch.autograd.Function):
    """x rounded to float8_e4m3fn under a per-tensor scale that maps its
    largest magnitude to FP8_MAX; the backward passes the gradient through
    unchanged (a straight-through estimate)."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp_min(1e-30)
        scale = FP8_MAX / amax
        return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """fp8=False: the identity. fp8=True: each operand of a matmul or conv
    rounded to fp8 as `_FakeFp8` does, the product accumulated in f32."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _FakeFp8.apply(x) if self.fp8 else x


@contextlib.contextmanager
def strict_f32():
    """f32 matmuls and convs with TF32 off, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Linear(nn.Linear):
    def __init__(self, cin, cout, p: Precision, bias=True):
        super().__init__(cin, cout, bias=bias)
        self.p = p

    def forward(self, x):
        return F.linear(self.p.q(x), self.p.q(self.weight), self.bias)


class Conv(nn.Conv3d):
    """A conv3d with stride 1 and `padding` on each side (groups allowed)."""

    def __init__(self, cin, cout, k, p: Precision, padding=0, groups=1, bias=True):
        super().__init__(cin, cout, k, padding=padding, groups=groups, bias=bias)
        self.p = p

    def forward(self, x, stride=1):
        return F.conv3d(self.p.q(x), self.p.q(self.weight), self.bias, stride,
                        self.padding, 1, self.groups)


class PatchConv(nn.Conv3d):
    """A conv whose kernel equals its stride (non-overlapping patches), as a
    contraction over each patch: [B, C, D, H, W] -> [B, O, D/s, H/s, W/s]."""

    def __init__(self, cin, cout, s, p: Precision):
        super().__init__(cin, cout, s, stride=s)
        self.p = p

    def forward(self, x):
        B, C, D, H, W = x.shape
        s = self.kernel_size[0]
        xp = x.reshape(B, C, D // s, s, H // s, s, W // s, s)
        y = torch.einsum("bcdxhywz,ocxyz->bodhw", self.p.q(xp), self.p.q(self.weight))
        return y + self.bias.view(1, -1, 1, 1, 1)


class PatchConvT(nn.ConvTranspose3d):
    """A transposed conv whose kernel equals its stride: each input voxel
    writes its own s³ block, [B, C, D, H, W] -> [B, O, sD, sH, sW]."""

    def __init__(self, cin, cout, s, p: Precision):
        super().__init__(cin, cout, s, stride=s)
        self.p = p

    def forward(self, x):
        B, C, D, H, W = x.shape
        s = self.kernel_size[0]
        y = torch.einsum("bcdhw,coxyz->bodxhywz", self.p.q(x), self.p.q(self.weight))
        y = y + self.bias.view(1, -1, 1, 1, 1, 1, 1, 1)
        return y.reshape(B, -1, D * s, H * s, W * s)


def layer_norm(x, ln: nn.LayerNorm):
    """LayerNorm over the last axis, mean and biased variance in f32."""
    var, mean = torch.var_mean(x, dim=-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + ln.eps) * ln.weight + ln.bias


def gelu(x):
    """Exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


# -- weights -------------------------------------------------------------------

def fan_in_std(name: str, module: nn.Module, w: torch.Tensor) -> float:
    """The init's std for weight `w` of `module`: 1/sqrt(fan_in), fan_in the
    input channels a kernel reads times its taps (a transposed conv's weight
    is [in, out, k...])."""
    taps = w[0, 0].numel() if w.dim() > 2 else 1
    fan_in = (w.shape[0] if isinstance(module, nn.ConvTranspose3d) else w.shape[1]) * taps
    return fan_in ** -0.5


def make_state(model: nn.Module, generator: torch.Generator, device) -> dict:
    """A state_dict for `model` (built on any device, meta included) drawn
    from `generator` on `device` in one call: each matrix or kernel a normal
    of std 1/sqrt(fan_in), biases a normal of std 0.05, norm scales one plus
    such a normal, each normal clipped at two std. f32; the same generator
    state gives the same tensors."""
    leaves = []
    for mname, mod in model.named_modules():
        for pname, prm in mod.named_parameters(recurse=False):
            leaves.append((f"{mname}.{pname}" if mname else pname, mod, pname, prm))
    total = sum(prm.numel() for *_, prm in leaves)
    flat = torch.randn(total, generator=generator, device=device, dtype=torch.float32)
    state, off = {}, 0
    for name, mod, pname, prm in leaves:
        n = prm.numel()
        z = flat[off:off + n].view(prm.shape).clamp_(-2.0, 2.0)
        off += n
        if pname == "weight" and prm.dim() >= 2:
            state[name] = z * fan_in_std(name, mod, prm)
        elif pname == "weight":                         # a norm's scale
            state[name] = 1.0 + 0.05 * z
        else:
            state[name] = 0.05 * z
    return state


# -- the serving path: tiles, blend, argmax ------------------------------------

def monai_starts(size: int, roi: int, overlap: float) -> list[int]:
    """MONAI's tile starts along one axis: interval roi·(1 - overlap), the
    last start clamped to size - roi."""
    if roi >= size:
        return [0]
    interval = max(int(roi * (1 - overlap)), 1)
    num = -(-(size - roi) // interval) + 1
    return sorted({min(i * interval, size - roi) for i in range(num)})


def gaussian_map(roi: int, sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """The nnU-Net gaussian over a cubic roi: exp(-|x - centre|² / 2σ²), σ =
    roi·sigma_scale, scaled to a maximum of 1, zeros raised to the smallest
    nonzero value. float32 [roi, roi, roi]."""
    ax = (np.arange(roi, dtype=np.float64) - (roi - 1) / 2) / (roi * sigma_scale)
    g = np.exp(-0.5 * (ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2))
    g /= g.max()
    if (g == 0).any():
        g[g == 0] = g[g > 0].min()
    return g.astype(np.float32)


@torch.no_grad()
def tiled_logits(model, volume: torch.Tensor, roi: int, overlap: float, num_classes: int,
                 block: int = 4) -> torch.Tensor:
    """Blended f32 logits [B, K, D, H, W] of `model` over cubic roi tiles of
    volume [B, C, D, H, W] (each side at least roi), `block` tiles a forward:
    each tile's logits weighted by the gaussian, summed, divided by the
    summed weights."""
    B = volume.shape[0]
    dims = volume.shape[2:]
    starts = [(z, y, x) for z in monai_starts(dims[0], roi, overlap)
              for y in monai_starts(dims[1], roi, overlap)
              for x in monai_starts(dims[2], roi, overlap)]
    wmap = torch.from_numpy(gaussian_map(roi)).to(volume.device)
    acc = torch.zeros((B, num_classes) + tuple(dims), dtype=torch.float32, device=volume.device)
    wsum = torch.zeros(tuple(dims), dtype=torch.float32, device=volume.device)
    tiles = [(b, s) for s in starts for b in range(B)]
    for i in range(0, len(tiles), block):
        part = tiles[i:i + block]
        x = torch.stack([volume[b, :, z:z + roi, y:y + roi, w:w + roi] for b, (z, y, w) in part])
        out = model(x.float()).float()
        for j, (b, (z, y, w)) in enumerate(part):
            acc[b, :, z:z + roi, y:y + roi, w:w + roi] += out[j] * wmap
    for z, y, w in starts:
        wsum[z:z + roi, y:y + roi, w:w + roi] += wmap
    return acc / wsum


# -- the training step: augmentation, loss, Adam --------------------------------

def draw_augment(generator: torch.Generator, batch: int) -> dict:
    """The monai stack's draws, in this order: flips [B, 3] (p 0.5), the
    intensity scale [B] and shift [B], each U(-0.1, 0.1)."""
    def u(shape):
        return torch.rand(shape, generator=generator, device=generator.device)

    return {"flip": u((batch, 3)) < 0.5, "scale": u((batch,)) * 0.2 - 0.1,
            "shift": u((batch,)) * 0.2 - 0.1}


def augment(images: torch.Tensor, onehot: torch.Tensor, draws: dict):
    """Per sample: the drawn flips of image and label along each spatial
    axis, then per channel the z-score over the nonzero voxels (zeros stay
    zero), times 1 + scale, plus shift."""
    imgs, labs = [], []
    for b in range(images.shape[0]):
        x, y = images[b], onehot[b]
        for axis in range(3):
            if bool(draws["flip"][b, axis]):
                x, y = x.flip(axis + 1), y.flip(axis + 1)
        out = []
        for c in range(x.shape[0]):
            ch = x[c]
            nz = ch != 0
            vals = ch[nz]
            if vals.numel():
                mean = vals.mean()
                std = ((vals - mean) ** 2).mean().clamp_min(1e-12).sqrt()
                ch = torch.where(nz, (ch - mean) / std, ch)
            out.append(ch)
        x = torch.stack(out) * (1.0 + draws["scale"][b]) + draws["shift"][b]
        imgs.append(x)
        labs.append(y)
    return torch.stack(imgs), torch.stack(labs)


def mdice_loss(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """(0.7·Σ_c (1 - soft Dice_c) + 0.3·Σ_c BCE_c) / C, with sigmoid
    probabilities, squared denominators and smooth 1, each channel reduced
    over batch and space together."""
    x = logits.float()
    t = onehot.float()
    axes = (0, 2, 3, 4)
    p = torch.sigmoid(x)
    dice = 1.0 - (2.0 * (p * t).sum(axes) + 1.0) / ((p * p).sum(axes) + (t * t).sum(axes) + 1.0)
    bce = -(t * F.logsigmoid(x) + (1.0 - t) * F.logsigmoid(-x)).mean(axes)
    return (0.7 * dice.sum() + 0.3 * bce.sum()) / x.shape[1]


class Adam:
    """Adam (β 0.9, 0.999, ε 1e-8, no weight decay) over a dict of f32
    tensors, the step's learning rate given to each update."""

    def __init__(self, params: dict):
        self.params = params
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def update(self, grads: dict, lr: float):
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            p -= lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + 1e-8)


def cosine_lr(base: float, step: int, t_max: int) -> float:
    """base·(1 + cos(π·step / t_max)) / 2, the step counted per batch."""
    return base * (1 + math.cos(math.pi * step / t_max)) / 2
