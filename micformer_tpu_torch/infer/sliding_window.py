"""Overlapped sliding-window inference with blended accumulation.

Counterpart of `micformer_tpu/infer/sliding_window.py`: MONAI and nnU-Net
tile placement, gaussian or constant blending, tiles batched sw_batch_size at
a time, zero padding of volumes smaller than the roi, and the 8-way mirror
ensemble, serial (the default) or batched. The f32 logit and weight
accumulators live on the volume's device and are updated in place, tile by
tile, in the JAX loop's order.
"""

from __future__ import annotations

import functools
import itertools
import os
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def compute_steps_monai(image_size, roi_size, overlap: float = 0.5):
    """MONAI placement: interval roi*(1-overlap), last start clamped to
    image - roi, repeats dropped."""
    starts = []
    for img, roi in zip(image_size, roi_size):
        if roi >= img:
            starts.append([0])
            continue
        interval = max(int(roi * (1 - overlap)), 1)
        num = int(np.ceil((img - roi) / interval)) + 1
        ax = [min(i * interval, img - roi) for i in range(num)]
        starts.append(list(dict.fromkeys(ax)))
    return starts


def compute_steps_nnunet(image_size, roi_size, step_size: float = 0.5):
    """nnU-Net placement: target step roi*step_size, starts spread evenly
    over [0, image - roi]."""
    starts = []
    for img, roi in zip(image_size, roi_size):
        if img < roi:
            raise ValueError("image smaller than patch: pad first")
        if roi == img:
            starts.append([0])
            continue
        num = int(np.ceil((img - roi) / (roi * step_size))) + 1
        actual = (img - roi) / max(num - 1, 1)
        starts.append([int(np.round(actual * i)) for i in range(num)])
    return starts


@functools.lru_cache(maxsize=None)
def gaussian_importance_map(roi_size, sigma_scale: float = 1.0 / 8,
                            eps_floor: bool = True) -> np.ndarray:
    """nnU-Net gaussian: centred in the patch, sigma = roi*sigma_scale,
    max-normalised, zeros replaced by the smallest nonzero value. float32
    [roi...]. Cached, so callers must not write into the result."""
    grids = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in roi_size],
                        indexing="ij")
    g = np.zeros(roi_size, np.float64)
    for grid, s in zip(grids, roi_size):
        g += ((grid - (s - 1) / 2) / (s * sigma_scale)) ** 2
    g = np.exp(-0.5 * g)
    g /= g.max()
    if eps_floor:
        nz = g[g > 0]
        g[g == 0] = nz.min() if nz.size else 1.0
    return g.astype(np.float32)


def _tile_starts(image_size, roi_size, mode: str, overlap: float,
                 step_size: float) -> np.ndarray:
    if mode == "nnunet":
        per_axis = compute_steps_nnunet(image_size, roi_size, step_size)
    else:
        per_axis = compute_steps_monai(image_size, roi_size, overlap)
    return np.stack([c.ravel() for c in np.meshgrid(
        *[np.asarray(a) for a in per_axis], indexing="ij")], axis=-1)


def _flip_subsets(mirror_axes):
    """Every flip subset of the mirror axes, as the tensor dims of a
    [B, C, D, H, W] batch, in the JAX package's order."""
    return [[a + 2 for a in s] for r in range(len(mirror_axes) + 1)
            for s in itertools.combinations(mirror_axes, r)]


def _flip(x, dims):
    return x.flip(dims) if dims else x


def _mirror_tta_predictor(predictor: Callable, mirror_axes=(0, 1, 2)) -> Callable:
    """Average of unflip(predict(flip(x))) over every flip subset of the
    spatial axes, one flip at a time, accumulated in f32."""
    subsets = _flip_subsets(mirror_axes)

    def wrapped(x):
        acc = None
        for dims in subsets:
            y = _flip(predictor(_flip(x, dims)).float(), dims)
            acc = y if acc is None else acc + y
        return acc / len(subsets)

    return wrapped


def _batched_tta_predictor(predictor: Callable, mirror_axes=(0, 1, 2)) -> Callable:
    """The same ensemble with the F flip variants on the predictor's batch
    axis: one forward at batch F·b, then the mean of the unflipped f32
    outputs."""
    subsets = _flip_subsets(mirror_axes)

    def wrapped(x):
        b = x.shape[0]
        preds = predictor(torch.cat([_flip(x, dims) for dims in subsets], 0)).float()
        return torch.stack([_flip(preds[i * b:(i + 1) * b], dims)
                            for i, dims in enumerate(subsets)], 0).mean(0)

    return wrapped


@torch.no_grad()
def sliding_window_inference(
    volume: torch.Tensor,
    roi_size,
    predictor: Callable,
    *,
    num_classes: int = 8,
    overlap: float = 0.5,
    blend: str = "gaussian",     # gaussian | constant
    step_mode: str = "monai",    # monai | nnunet
    step_size: float = 0.5,      # nnunet step fraction
    sw_batch_size: int = 1,
    mirror_tta: bool = False,
    mirror_axes=(0, 1, 2),
    tta_batched: bool | None = None,
    sigma_scale: float = 1.0 / 8,
) -> torch.Tensor:
    """Blended tiled prediction of a whole volume.

    volume: [B, C, D, H, W]; predictor: [b, C, *roi] -> [b, num_classes, *roi].
    Returns [B, num_classes, D, H, W] f32 blended logits on volume's device.

    tta_batched: run the mirror ensemble's flips as one forward at batch
    8·sw_batch_size·B instead of eight serial forwards (eight times the
    forward's activation memory); None reads MICFORMER_TTA_BATCHED=1, as
    the JAX function does.
    """
    B, C = volume.shape[:2]
    spatial = tuple(volume.shape[2:])
    roi = tuple(roi_size)
    dev = volume.device

    pads = [max(r - s, 0) for r, s in zip(roi, spatial)]
    if any(pads):
        cfg = []
        for p in reversed(pads):
            cfg += [p // 2, p - p // 2]
        volume = F.pad(volume, cfg)
    padded = tuple(volume.shape[2:])

    coords = _tile_starts(padded, roi, step_mode, overlap, step_size)
    n_tiles = coords.shape[0]
    if mirror_tta:
        batched = (os.environ.get("MICFORMER_TTA_BATCHED", "0") == "1"
                   if tta_batched is None else tta_batched)
        wrap = _batched_tta_predictor if batched else _mirror_tta_predictor
        predictor = wrap(predictor, mirror_axes)

    if blend == "gaussian":
        wmap = torch.from_numpy(gaussian_importance_map(roi, sigma_scale)).to(dev)
    else:
        wmap = torch.ones(roi, dtype=torch.float32, device=dev)

    # the last chunk is filled up with copies of tile 0 that get weight 0,
    # so every predictor call sees the same batch
    chunk = max(1, sw_batch_size)
    n_chunks = -(-n_tiles // chunk)
    pad_tiles = n_chunks * chunk - n_tiles
    coords = np.concatenate([coords, np.repeat(coords[:1], pad_tiles, 0)], 0)
    valid = np.arange(n_chunks * chunk) < n_tiles

    logit_acc = torch.zeros((B, num_classes) + padded, dtype=torch.float32, device=dev)
    weight_acc = torch.zeros((1, 1) + padded, dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        starts = coords[c * chunk:(c + 1) * chunk]
        tiles = [volume[:, :, z:z + roi[0], y:y + roi[1], x:x + roi[2]]
                 for z, y, x in starts]
        preds = predictor(torch.cat(tiles, 0)).float()
        preds = preds.reshape((chunk, B, num_classes) + roi)
        for j, (z, y, x) in enumerate(starts):
            if not valid[c * chunk + j]:
                continue
            sl = (slice(None), slice(None), slice(z, z + roi[0]),
                  slice(y, y + roi[1]), slice(x, x + roi[2]))
            logit_acc[sl] += preds[j] * wmap           # in place
            weight_acc[sl] += wmap

    out = logit_acc / weight_acc
    if any(pads):
        out = out[(slice(None), slice(None)) + tuple(
            slice(p // 2, p // 2 + s) for p, s in zip(pads, spatial))]
    return out
