"""The building blocks of MicFormer, MedNeXt and the zoo.

Counterpart of the subsets of `micformer_tpu/models/layers.py` that the
port's models use. The JAX package's lane-major, via-dot, blocked and
W-packed forms are TPU layouts of the same math; this is the plain math.

The window blocks work on channels-last [B, D, H, W, C] tensors: Mlp,
Dropout, DropPath, WindowAttention3D (self and cross; relative-position
bias, with its inference cache `materialize_rpe_cache`, masks and the
SwinUnet3D window scramble for the zoo), SwinBlock3D
(shifted or not), PatchEmbed3D, PatchMergingConv, PatchExpandConv, the Swin
merges and expands PatchMergingLinear, PatchExpandLinear and
FinalPatchExpand, and pad_to_multiple. Their convolutions take the
channels-first view.

The conv blocks of the zoo work on channels-first [B, C, *spatial] tensors:
GroupNorm, DoubleConv, PReLU and ConvNormAct (convs padded as flax's "SAME"
pads them: same_pads, conv_same).

MedNeXt's blocks work on channels-first [B, C, D, H, W] tensors, the layout
the depthwise kernel takes, in which cuDNN's strided and transposed convs,
the norm and GELU run natively and a 1³ conv is one GEMM per batch element:
InstanceNorm, DepthwiseConv3D, PointwiseConv, PointwiseTranspose2 and
zero_dilate. Their parameters have the shapes of the torch layers they
stand for, so `convert.from_flax` maps the flax tree onto them.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from micformer_tpu_torch.kernels.dw_conv3 import dw_conv3
from micformer_tpu_torch.ops.attention import (
    merge_heads, multi_head_attention, split_heads,
)
from micformer_tpu_torch.ops.windows import (
    adjust_window_shift, cyclic_shift, relative_position_index, shifted_window_region_ids,
    window_partition, window_reverse,
)

LN_EPS = 1e-5

# (first row, global batch size) of this rank's rows, inside batch_rows
_ROWS = contextvars.ContextVar("batch_rows", default=None)


@contextlib.contextmanager
def batch_rows(first: int, total: int):
    """Inside, DropPath and Dropout draw their masks for a global batch of
    `total` rows and keep the rows from `first` on: a data-parallel rank
    holding those rows draws what a single process draws for them."""
    token = _ROWS.set((first, total))
    try:
        yield
    finally:
        _ROWS.reset(token)


def conv_cl(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv3d / ConvTranspose3d to channels-last [B, D, H, W, C]."""
    return conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


def pad_to_multiple(x: torch.Tensor, multiple) -> torch.Tensor:
    """Zero-pad the spatial dims of [B, D, H, W, C] up to multiples."""
    B, D, H, W, C = x.shape
    pd, ph, pw = ((-s) % m for s, m in zip((D, H, W), multiple))
    if pd or ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))
    return x


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax "SAME" padding (lo, hi) of one axis of extent n."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """conv (padding 0) on channels-first x zero-padded as flax's "SAME"
    pads it."""
    pads = []
    for n, k, s in reversed(list(zip(x.shape[2:], conv.kernel_size, conv.stride))):
        pads += same_pads(n, k, s)
    return conv(F.pad(x, pads) if any(pads) else x)


def conv_transpose_same(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A transposed conv (padding 0) cropped to flax's ConvTranspose with
    "SAME" padding: n·s per axis. flax pads the dilated input by
    (a, k + s - 2 - a), a = k - 1 when s > k - 1 else ceil((k + s - 2) / 2);
    the full transposed conv is that input padded by k - 1 on both sides."""
    sl = [slice(None), slice(None)]
    for n, k, s in zip(x.shape[2:], conv.kernel_size, conv.stride):
        a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        sl.append(slice(k - 1 - a, k - 1 - a + n * s))
    return conv(x)[tuple(sl)]


class Mlp(nn.Module):
    """Linear -> exact GELU -> dropout -> Linear -> dropout (TransBTS sets
    the dropout; every other model has none)."""

    def __init__(self, dim: int, hidden: int, out: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)
        self.drop = Dropout(dropout)

    def forward(self, x, generator: torch.Generator | None = None):
        x = self.drop(F.gelu(self.fc1(x)), generator)
        return self.drop(self.fc2(x), generator)


class Dropout(nn.Module):
    """Element-wise dropout: identity in eval mode; in train mode each
    element is kept with probability 1 - rate (and scaled by 1 / keep),
    drawn from the caller's generator (for the global batch inside
    `batch_rows`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.rate == 0.0:
            return x
        return _keep(x, self.rate, x.shape[1:], generator)


def _keep(x, rate, tail, generator):
    """x with rows dropped by masks of shape [rows, *tail] drawn for the
    global batch (`batch_rows`), the kept entries scaled by 1 / (1 - rate)."""
    keep = 1.0 - rate
    first, total = _ROWS.get() or (0, x.shape[0])
    dev = generator.device if generator is not None else x.device
    mask = torch.rand((total,) + tuple(tail), generator=generator, device=dev).to(x.device)
    mask = mask[first:first + x.shape[0]] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth on a residual branch: identity in eval mode; in train
    mode each sample is kept with probability 1 - rate (and scaled by
    1 / keep), drawn from the caller's generator (for the global batch
    inside `batch_rows`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.rate == 0.0:
            return x
        return _keep(x, self.rate, (1,) * (x.dim() - 1), generator)


# table gathers of the rel-pos biases ("gathered"), and the biases a forward
# read from a module's cache instead ("cached")
RPE_COUNTS: dict[str, int] = {"gathered": 0, "cached": 0}
# set while materialize_rpe_cache's forward runs: each gather is then kept
_MATERIALIZING = contextvars.ContextVar("materialize_rpe_cache", default=False)


def _clear_rpe_cache_on_load(module, incompatible_keys):
    module.rpe_cache = None
    module.rpe_cache_key = None


def add_rel_pos_table(module: nn.Module, window_size, num_heads: int) -> None:
    """Give `module` a relative-position bias table for `window_size`,
    `rel_pos_bias_table` [(2wd-1)(2wh-1)(2ww-1), heads] (the flax leaf's name
    and shape), and its index as a buffer that no state_dict holds.
    `bias_heads`, the table's columns a forward gathers, is all of them but
    under tensor parallelism (`parallel/tensor.py`: the rank's heads). The
    inference cache of the gathered bias, `rpe_cache`, is a buffer that no
    state_dict holds either, emptied whenever the module's weights are loaded
    (`load_state_dict` of it or of any module that holds it)."""
    wd, wh, ww = module.table_window = tuple(window_size)
    module.bias_heads = slice(None)
    module.rel_pos_bias_table = nn.Parameter(
        torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
    module.register_buffer("rel_pos_index", torch.from_numpy(
        relative_position_index(module.table_window).astype(np.int64)), persistent=False)
    module.register_buffer("rpe_cache", None, persistent=False)
    module.rpe_cache_key = None
    module.register_load_state_dict_post_hook(_clear_rpe_cache_on_load)


def rel_pos_bias_cached(module: nn.Module, T: int | None = None) -> torch.Tensor:
    """[h, T, T]: `module`'s table gathered at the top-left T x T block of
    its window's relative_position_index (T None: the whole window), the
    gather of the JAX layer's `rel_pos_bias_cached`.

    At inference the bias is constant for a checkpoint: after
    `materialize_rpe_cache` a forward under `torch.no_grad()` or
    `torch.inference_mode()` reads the module's cached bias instead of
    gathering. The cache is keyed by T, the gathered heads and the table's
    version counter, so a forward at another window, or after the table was
    written in place, gathers as before. A forward with grad enabled always
    gathers: a cached bias is a constant, and a table trained through it
    would silently receive no gradient."""
    T = len(module.rel_pos_index) if T is None else T
    table = module.rel_pos_bias_table
    key = (T, module.bias_heads, table._version)
    if (module.rpe_cache is not None and not torch.is_grad_enabled()
            and module.rpe_cache_key == key):
        RPE_COUNTS["cached"] += 1
        return module.rpe_cache
    RPE_COUNTS["gathered"] += 1
    idx = module.rel_pos_index[:T, :T].reshape(-1)
    bias = table[:, module.bias_heads][idx].reshape(T, T, -1).permute(2, 0, 1)
    if _MATERIALIZING.get():
        module.rpe_cache, module.rpe_cache_key = bias.detach().contiguous(), key
    return bias


def rel_pos_bias(module: nn.Module, window_size) -> torch.Tensor:
    """[h, T, T]: `module`'s bias at its window's whole
    relative_position_index (`rel_pos_bias_cached`). The call's (clamped)
    window must be the table's: the JAX layer's table takes the window
    clamped to the input it was initialised on, and an input that clamps
    otherwise fails there on the table's shape."""
    if tuple(window_size) != module.table_window:
        raise ValueError(f"window {tuple(window_size)} of this input, but the bias table "
                         f"is for window {module.table_window}: build the model with the "
                         "input_size it is called at")
    return rel_pos_bias_cached(module)


def materialize_rpe_cache(model: nn.Module, *example_inputs, **kwargs) -> nn.Module:
    """Gather every relative-position bias of `model` once, for inference
    at the shape of `example_inputs`: one forward under no_grad in which
    each biased module keeps its gathered [h, T, T] bias (`rpe_cache`).
    Returns `model`; a model without bias tables is left as it is. The
    cache is for the windows of that shape (windows clamp to the input); a
    forward at another shape gathers as before. INFERENCE ONLY: training
    never reads the cache (`rel_pos_bias_cached`), and loading weights
    empties it."""
    if not any(getattr(m, "rel_pos_bias_table", None) is not None for m in model.modules()):
        return model
    token = _MATERIALIZING.set(True)
    try:
        with torch.no_grad():
            model(*example_inputs, **kwargs)
    finally:
        _MATERIALIZING.reset(token)
    return model


def clear_rpe_cache(model: nn.Module) -> None:
    """Empty the rel-pos cache of every module of `model`."""
    for m in model.modules():
        if getattr(m, "rpe_cache", None) is not None:
            _clear_rpe_cache_on_load(m, None)


class WindowAttention3D(nn.Module):
    """Windowed multi-head attention over [N, T, C] token windows.

    cross=False: fused qkv projection (split into thirds). cross=True: q from
    x, k and v from `context` through one kv projection (k is the first
    half). Projections are heads · head_dim wide (dim when head_dim is None).
    rel_pos_bias: a learned table
    [(2wd-1)(2wh-1)(2ww-1), heads] for `window_size`, gathered each forward
    by relative_position_index(window_size) (`rel_pos_bias`; at inference
    read from its cache after `materialize_rpe_cache`). fused_attention selects
    `multi_head_attention(..., fused=True)`, the fused kernel K2 on the
    card."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 cross: bool = False, fused_attention: bool = False,
                 window_size=None, rel_pos_bias: bool = False, head_dim: int | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.cross = cross
        self.fused_attention = fused_attention
        inner = head_dim * num_heads if head_dim else dim
        if cross:
            self.q = nn.Linear(dim, inner, bias=qkv_bias)
            self.kv = nn.Linear(dim, 2 * inner, bias=qkv_bias)
        else:
            self.qkv = nn.Linear(dim, 3 * inner, bias=qkv_bias)
        self.proj = nn.Linear(inner, dim)
        self.rel_pos_bias_table = None
        if rel_pos_bias:
            add_rel_pos_table(self, window_size, num_heads)

    def forward(self, x, context=None, mask=None, window_perm=None, window=None):
        """mask: multi_head_attention's ([nW, T] region ids or [nW, T, T]).
        window_perm: SwinUnet3D's scramble of the window grid, applied to q
        and k (not v): window w of each batch element attends with window
        perm[w]'s q·k. window: the windows' [wd, wh, ww], which a rel-pos
        bias needs."""
        h = self.num_heads
        if self.cross:
            q = self.q(x)
            k, v = self.kv(x if context is None else context).chunk(2, dim=-1)
        else:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        if window_perm is not None:
            nW = len(window_perm)
            idx = (torch.arange(x.shape[0] // nW)[:, None] * nW
                   + torch.as_tensor(window_perm)).reshape(-1).to(x.device)
            q, k = q[idx], k[idx]
        bias = None if self.rel_pos_bias_table is None else rel_pos_bias(self, window)
        out = multi_head_attention(split_heads(q, h), split_heads(k, h), split_heads(v, h),
                                   bias=bias, mask=mask,
                                   fused=self.fused_attention)
        return self.proj(merge_heads(out))


class SwinBlock3D(nn.Module):
    """Pre-norm (shifted-)window transformer block: x + attn(LN(x)), then
    x + mlp(LN(x)), each branch through DropPath.

    MicFormer's TransformerBlock3D is the unshifted, unbiased form. The zoo's
    steps: the window clamped to the input (`adjust_window_shift`, which
    also zeroes the shift on clamped axes), pad, cyclic shift, region-id
    mask, partition, attention, reverse, unshift, crop. swinunet_scramble
    keeps SwinUnet3D's reference quirks: no clamp, and on a cubic window grid
    the shifted windows' grid flattened as (z, x, y) for q·k.

    input_size: the [D, H, W] the block is built for. With a rel-pos bias
    the table is that of the window clamped to it, as the JAX block's table
    is that of the window clamped to the input it was initialised on; None
    builds it for the configured window."""

    def __init__(self, dim: int, num_heads: int, window_size=(4, 4, 4),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0, fused_attention: bool = False,
                 shift_size=(0, 0, 0), rel_pos_bias: bool = False,
                 head_dim: int | None = None, swinunet_scramble: bool = False,
                 input_size=None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.swinunet_scramble = swinunet_scramble
        table_window = self.window_size
        if input_size is not None and not swinunet_scramble:
            table_window = adjust_window_shift(tuple(input_size), self.window_size)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention3D(dim, num_heads, qkv_bias, fused_attention=fused_attention,
                                      window_size=table_window, rel_pos_bias=rel_pos_bias,
                                      head_dim=head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator=None):
        B, D, H, W, C = x.shape
        if self.swinunet_scramble:
            ws, ss = self.window_size, self.shift_size
        else:
            ws, ss = adjust_window_shift((D, H, W), self.window_size, self.shift_size)
        xn = cyclic_shift(pad_to_multiple(self.norm1(x), ws), ss)
        _, Dp, Hp, Wp, _ = xn.shape
        ids = shifted_window_region_ids((Dp, Hp, Wp), ws, ss)
        perm = None
        if self.swinunet_scramble and any(ss):
            g = (Dp // ws[0], Hp // ws[1], Wp // ws[2])
            if g[0] == g[1] == g[2] and g[0] > 1:
                perm = np.arange(g[0] * g[1] * g[2]).reshape(g).transpose(2, 0, 1).ravel()
                ids = ids[perm]
        mask = None if ids is None else torch.from_numpy(ids).to(x.device)
        a = self.attn(window_partition(xn, ws), mask=mask, window_perm=perm, window=ws)
        a = cyclic_shift(window_reverse(a, ws, B, Dp, Hp, Wp), ss, reverse=True)
        x = x + self.drop_path(a[:, :D, :H, :W], generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class PatchEmbed3D(nn.Module):
    """Patch embedding: conv with kernel = stride = patch, optional LN."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size=(4, 4, 4),
                 use_norm: bool = True):
        super().__init__()
        self.proj = nn.Conv3d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS) if use_norm else None

    def forward(self, x):
        x = conv_cl(self.proj, x)
        return x if self.norm is None else self.norm(x)


class PatchMergingConv(nn.Module):
    """Downsample C -> 2C: conv k2 s2, then LN."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv3d(dim, 2 * dim, 2, stride=2)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x):
        return self.norm(conv_cl(self.conv, x))


class PatchExpandConv(nn.Module):
    """Upsample C -> C/2: transposed conv k2 s2, then LN."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose3d(dim, dim // 2, 2, stride=2)
        self.norm = nn.LayerNorm(dim // 2, eps=LN_EPS)

    def forward(self, x):
        return self.norm(conv_cl(self.conv, x))


class PatchMergingLinear(nn.Module):
    """Swin merge C -> 2C on channels-last x: pad to even extents, the 2³
    neighbourhood concatenated as (d, h, w) channel blocks, LN(8C), a
    bias-free Linear."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = pad_to_multiple(x, (2, 2, 2))
        B, D, H, W, C = x.shape
        x = x.reshape(B, D // 2, 2, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        return self.reduction(self.norm(x.reshape(B, D // 2, H // 2, W // 2, 8 * C)))


class PatchExpandLinear(nn.Module):
    """Swin expand C -> C/4 at twice the extents on channels-last x: a
    bias-free Linear(C, 2C), its output read as (d, h, w, C/4) blocks
    shuffled into the 2³ neighbourhood, then LN(C/4)."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 4, eps=LN_EPS)

    def forward(self, x):
        B, D, H, W, C = x.shape
        x = self.expand(x).reshape(B, D, H, W, 2, 2, 2, C // 4)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, 2 * D, 2 * H, 2 * W, C // 4)
        return self.norm(x)


class FinalPatchExpand(nn.Module):
    """The last expand by `scale` per axis, keeping C: a bias-free
    Linear(C, scale³·C) shuffled into the scale³ neighbourhood, then LN(C)."""

    def __init__(self, dim: int, scale: int = 4):
        super().__init__()
        self.scale = scale
        self.expand = nn.Linear(dim, scale ** 3 * dim, bias=False)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        B, D, H, W, C = x.shape
        s = self.scale
        x = self.expand(x).reshape(B, D, H, W, s, s, s, C)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, s * D, s * H, s * W, C)
        return self.norm(x)


class InstanceNorm(nn.Module):
    """Instance norm of [B, C, *spatial] over the spatial axes, affine
    (MedNeXt's GroupNorm with one group per channel, GenericUNet's) or not
    (the zoo's ConvNormAct, torch's InstanceNorm3d default). Statistics in
    f32 as the JAX default computes them, E[x²] − E[x]² clamped at 0;
    output in x's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if affine else None

    def forward(self, x):
        dims = tuple(range(2, x.dim()))
        n = math.prod(x.shape[2:])
        xf = x.float()
        mean = xf.sum(dims, keepdim=True) / n
        var = (xf.square().sum(dims, keepdim=True) / n - mean.square()).clamp_min(0.0)
        shape = (1, -1) + (1,) * len(dims)
        # ((x - mean) * rsqrt(var + eps)) * weight + bias as one pass over x
        # with per-(b, c) factors
        scale = torch.rsqrt(var + self.eps)
        if self.weight is None:
            return ((xf - mean) * scale).to(x.dtype)
        scale = scale * self.weight.float().view(shape)
        shift = self.bias.float().view(shape) - mean * scale
        return torch.addcmul(shift, xf, scale).to(x.dtype)


class GroupNorm(InstanceNorm):
    """flax's GroupNorm (affine) of [B, C, *spatial]: `num_groups`
    contiguous channel blocks, statistics over each block and the spatial
    axes in f32 as E[x²] − E[x]² clamped at 0, as flax computes them.
    TransBTS's encoder takes min(8, C) groups."""

    def __init__(self, num_groups: int, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps)
        self.num_groups = num_groups

    def forward(self, x):
        B = x.shape[0]
        xf = x.float().reshape(B, self.num_groups, -1)
        n = xf.shape[-1]
        mean = xf.sum(-1, keepdim=True) / n
        var = (xf.square().sum(-1, keepdim=True) / n - mean.square()).clamp_min(0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (y * self.weight.float().view(shape) + self.bias.float().view(shape)).to(x.dtype)


class DoubleConv(nn.Module):
    """2 x (conv k3 pad 1, affine InstanceNorm, ReLU) on [B, C, D, H, W]:
    TransUNet's level block; with `residual`, plus the input (TransBTS's
    decoder block)."""

    def __init__(self, in_ch: int, features: int, residual: bool = False):
        super().__init__()
        self.residual = residual
        self.conv1 = nn.Conv3d(in_ch, features, 3, padding=1)
        self.norm1 = InstanceNorm(features)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1)
        self.norm2 = InstanceNorm(features)

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return h + x if self.residual else h


class PReLU(nn.Module):
    """Parametric ReLU with one shared slope `alpha` (torch's PReLU default,
    0.25 at init)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class ConvNormAct(nn.Module):
    """Conv (or transposed conv) with flax's "SAME" padding, a non-affine
    instance norm and a PReLU, on [B, C, D, H, W]: UNet3D's unit, the JAX
    ConvNormAct's defaults."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1,
                 transpose: bool = False):
        super().__init__()
        self.transpose = transpose
        conv = nn.ConvTranspose3d if transpose else nn.Conv3d
        self.conv = conv(in_ch, features, kernel, stride=stride)
        self.norm = InstanceNorm(features, affine=False)
        self.act = PReLU()

    def forward(self, x):
        x = conv_transpose_same(self.conv, x) if self.transpose else conv_same(self.conv, x)
        return self.act(self.norm(x))


class DepthwiseConv3D(nn.Conv3d):
    """Depthwise k³ conv with bias on [B, C, D, H, W] (weight [C, 1, k, k, k]).

    Stride 1 with SAME padding k//2 runs the depthwise kernel (`dw_conv3`);
    stride 2 is cuDNN's grouped conv at padding k//2; `pad`, per axis
    (lo, hi), zero-pads first (a symmetric k//2 pad at stride 1 is the SAME
    conv and runs the kernel too); `transpose2` is the stride-2 transpose
    conv of MedNeXt's default up block, exactly 2L per axis:
    conv(zero_dilate(x), pad (k//2 + 1, k//2))."""

    def __init__(self, channels: int, kernel: int = 3, stride: int = 1,
                 pad=None, transpose2: bool = False):
        super().__init__(channels, channels, kernel, stride=stride, groups=channels)
        self.pad = None if pad is None else tuple(tuple(a) for a in pad)
        self.transpose2 = transpose2

    def forward(self, x):
        p, s = self.kernel_size[0] // 2, self.stride[0]
        # the parameters in x's dtype, as the JAX layer's w.astype(dtype): a
        # no-op when they already match, and under autocast over f32
        # parameters the cast's backward hands them f32 gradients
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype)
        if self.transpose2:
            # conv_transpose3d at padding p-1 with the flipped kernel yields
            # dilate-and-pad (p+1, p) plus one extra plane per axis; keep 2L
            D, H, W = x.shape[2:]
            y = F.conv_transpose3d(x, w.flip((2, 3, 4)), b, stride=2, padding=p - 1,
                                   groups=self.groups)
            return y[:, :, :2 * D, :2 * H, :2 * W]
        if s == 1 and self.pad in (None, ((p, p),) * 3):
            # a tensor with size-1 axes can come out of F.pad channels-last;
            # on the serving path x is already contiguous and this is free
            return dw_conv3(x.contiguous(), w, b)
        if self.pad is None:
            return F.conv3d(x, w, b, s, p, groups=self.groups)
        (dl, dh), (hl, hh), (wl, wh) = self.pad
        return F.conv3d(F.pad(x, (wl, wh, hl, hh, dl, dh)), w, b, s, groups=self.groups)


class PointwiseConv(nn.Conv3d):
    """1³ conv with bias on [B, C, D, H, W] as one GEMM per batch element;
    stride 2 takes the even indices (ceil(n/2) per axis)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__(in_channels, out_channels, 1, stride=stride)

    def gemm(self, x):
        B, C, D, H, W = x.shape
        Fo = self.out_channels
        # bmm with the weight broadcast over the batch: torch.matmul of a 2-D
        # weight by a 3-D x would fold x into [B·DHW, C], a transposing copy
        w = self.weight.view(1, Fo, C).expand(B, Fo, C)
        y = torch.bmm(w, x.reshape(B, C, D * H * W))
        return y.add_(self.bias.view(Fo, 1)).view(B, Fo, D, H, W)

    def forward(self, x):
        if self.stride[0] == 2:
            x = x[:, :, ::2, ::2, ::2]
        return self.gemm(x)


class PointwiseTranspose2(PointwiseConv):
    """MedNeXt's default up-block residual: a 1³ conv over the lead-padded
    zero-dilated input, [B, C, L...] -> [B, F, 2L...]. The all-odd parity
    class holds W·x[q] + b, every other voxel the bias."""

    def forward(self, x):
        B, C, D, H, W = x.shape
        Fo = self.out_channels
        y = self.gemm(x)
        # in the GEMM's dtype (bf16 under autocast), not the bias's
        out = self.bias.to(y.dtype).view(1, Fo, 1, 1, 1).expand(
            B, Fo, 2 * D, 2 * H, 2 * W).clone()
        out[:, :, 1::2, 1::2, 1::2] = y
        return out


def zero_dilate(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Insert factor-1 zeros between the spatial elements of [B, C, D, H, W]:
    each spatial size n becomes factor*n - (factor-1)."""
    B, C, D, H, W = x.shape
    out = x.new_zeros((B, C) + tuple(factor * n - (factor - 1) for n in (D, H, W)))
    out[:, :, ::factor, ::factor, ::factor] = x
    return out
