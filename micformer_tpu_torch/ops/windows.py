"""3D window partitioning on channels-last [B, D, H, W, C] tensors.

Counterpart of `micformer_tpu/ops/windows.py` (partition, reverse and the
window clamp; shifted-window masks and relative-position indices come with
the models that use them).
"""

from __future__ import annotations

import torch


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
