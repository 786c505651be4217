"""3D window partitioning on channels-last [B, D, H, W, C] tensors.

Counterpart of `micformer_tpu/ops/windows.py`: partition, reverse, the
27-neighbourhood area partition, the window clamp, the cyclic shift, and
the shifted-window region ids and relative-position indices, which are
numpy built on the host once per shape (as the JAX package builds them at
trace time) and reach the device with the attention that uses them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, window_size) -> torch.Tensor:
    """[B, D, H, W, C] -> [B * nWindows, prod(window_size), C].

    D, H, W must be multiples of the window (pad first; see
    models.layers.pad_to_multiple)."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, C)


def window_reverse(windows: torch.Tensor, window_size, B: int, D: int, H: int,
                   W: int) -> torch.Tensor:
    """Inverse of window_partition: [B*nW, prod(ws), C] -> [B, D, H, W, C]."""
    wd, wh, ww = window_size
    C = windows.shape[-1]
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, C)


def window_area_partition(x: torch.Tensor, window_size) -> torch.Tensor:
    """XMorpher-style 27-neighbourhood K/V area expansion: for every window,
    the tokens of its 3x3x3 neighbourhood on the window grid (zero-padded by
    one window slot a side). [B, D, H, W, C] -> [B * nWindows,
    27 * prod(window_size), C], the neighbour slots z-major, then y, then x
    (slot 13 is the window itself).

    The reference's K/V expansion (MicFormer/models/MICFormer_self.py:53-114,
    dead code there) with its defects left out, as the JAX package leaves
    them out: every slot written once, any batch size, any device."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    d, h, w = D // wd, H // wh, W // ww
    T = wd * wh * ww
    grid = x.reshape(B, d, wd, h, wh, w, ww, C)
    grid = grid.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, d, h, w, T, C)
    grid = F.pad(grid, (0, 0, 0, 0, 1, 1, 1, 1, 1, 1))
    slots = [grid[:, dz:dz + d, dy:dy + h, dx:dx + w]
             for dz in range(3) for dy in range(3) for dx in range(3)]
    return torch.stack(slots, dim=4).reshape(B * d * h * w, 27 * T, C)


def adjust_window_shift(input_size, window_size, shift_size=None):
    """Clamp the window to the input extent and zero the shift on clamped axes:
    an axis no longer than its window is covered by one window."""
    ws = list(window_size)
    ss = list(shift_size) if shift_size is not None else None
    for i in range(3):
        if input_size[i] <= window_size[i]:
            ws[i] = input_size[i]
            if ss is not None:
                ss[i] = 0
    if ss is None:
        return tuple(ws)
    return tuple(ws), tuple(ss)


def _region_ids(dims, window_size, shift_size) -> np.ndarray:
    """int32 [nWindows, T]: the pre-shift region (0-26) of every token of
    every window of a cyclic-shifted [D, H, W] grid."""
    D, H, W = dims
    img_mask = np.zeros((D, H, W), np.int32)

    def spans(w, s):
        return (slice(0, -w), slice(-w, -s if s else None),
                slice(-s, None) if s else slice(0, 0))

    cnt = 0
    for d in spans(window_size[0], shift_size[0]):
        for h in spans(window_size[1], shift_size[1]):
            for w in spans(window_size[2], shift_size[2]):
                img_mask[d, h, w] = cnt
                cnt += 1
    wd, wh, ww = window_size
    m = img_mask.reshape(D // wd, wd, H // wh, wh, W // ww, ww)
    return m.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)


@functools.lru_cache(maxsize=None)
def shifted_window_region_ids(dims, window_size, shift_size) -> np.ndarray | None:
    """Compact shifted-window mask: int32 [nWindows, T] region ids (the
    attention turns equal ids into 0 and others into -100), or None when no
    axis is shifted. Cached: callers must not write into the result."""
    if not any(shift_size):
        return None
    return _region_ids(dims, window_size, shift_size)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(dims, window_size, shift_size) -> np.ndarray | None:
    """The pairwise form of `shifted_window_region_ids`: float32
    [nWindows, T, T], 0 where two tokens share a pre-shift region and -100
    elsewhere (the Swin convention), or None when no axis is shifted. The
    attention takes the region ids; this is the mask they stand for.
    Cached: callers must not write into the result."""
    ids = shifted_window_region_ids(dims, window_size, shift_size)
    if ids is None:
        return None
    return np.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size) -> np.ndarray:
    """int32 [T, T] index into a ((2wd-1)(2wh-1)(2ww-1),) bias table: per-axis
    coordinate deltas shifted to be nonnegative, mixed-radix flattened.
    Cached: callers must not write into the result."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel += np.array([wd - 1, wh - 1, ww - 1])
    rel[..., 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[..., 1] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


def cyclic_shift(x: torch.Tensor, shift_size, reverse: bool = False) -> torch.Tensor:
    """Roll a [B, D, H, W, C] volume by -shift (by +shift when reverse)."""
    if not any(shift_size):
        return x
    sign = 1 if reverse else -1
    return torch.roll(x, shifts=tuple(sign * s for s in shift_size), dims=(1, 2, 3))
