"""Sinusoidal 3D positional encodings, numpy on the host.

Counterpart of `micformer_tpu/ops/pe.py`, the port's own copy. Each axis
gets a group of ch = 2·ceil(C/6) channels of sin and cos at the frequencies
1/10000^(2i/ch); the three groups (first spatial axis first) are stacked to
3·ch channels and cut to C. Built once per shape (cached) and moved to the
device by the caller, as the JAX package folds them in at trace time.
"""

from __future__ import annotations

import functools

import numpy as np


def _encoding(D: int, H: int, W: int, C: int, interleaved: bool) -> np.ndarray:
    ch = int(np.ceil(C / 6) * 2)
    if ch % 2:
        ch += 1
    inv_freq = 1.0 / (10000 ** (np.arange(0, ch, 2, dtype=np.float32) / ch))

    def axis_enc(n):
        ang = np.einsum("i,j->ij", np.arange(n, dtype=np.float32), inv_freq)
        if interleaved:
            return np.stack([np.sin(ang), np.cos(ang)], axis=-1).reshape(n, ch)
        return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)

    emb = np.zeros((D, H, W, ch * 3), np.float32)
    emb[..., :ch] = axis_enc(D)[:, None, None, :]
    emb[..., ch:2 * ch] = axis_enc(H)[None, :, None, :]
    emb[..., 2 * ch:] = axis_enc(W)[None, None, :, :]
    return emb[..., :C]


@functools.lru_cache(maxsize=None)
def sinusoidal_pe_3d(D: int, H: int, W: int, C: int) -> np.ndarray:
    """[D, H, W, C] float32, each axis group laid out (sin..., cos...):
    VT-UNet's encoding. Cached: callers must not write into the result."""
    return _encoding(D, H, W, C, interleaved=False)


@functools.lru_cache(maxsize=None)
def sinusoidal_pe_3d_interleaved(D: int, H: int, W: int, C: int) -> np.ndarray:
    """[D, H, W, C] float32, each axis group laid out (sin0, cos0, sin1,
    cos1, ...): the layout of TransUNet's attention gates. Cached."""
    return _encoding(D, H, W, C, interleaved=True)
