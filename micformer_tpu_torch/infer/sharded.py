"""Sliding-window inference with the tile grid split over the ranks.

Counterpart of `micformer_tpu/infer/sharded.py`: every rank holds the whole
volume, the tile grid (MONAI or nnU-Net placement) is padded to a multiple
of the ranks with copies of tile 0 of weight 0, rank r takes the r-th
contiguous block of tiles and blends each of them (its gaussian or constant
weight times the tile's valid flag) into local logit and weight buffers,
one tile a predictor call (with mirror TTA, the 8 flips one after
another, as in JAX's `_mirror_tta_predictor`), and two all-reduces over the group sum the
buffers. Every rank returns the blended logits. Without a group (or with
one rank) this is `sliding_window_inference` at sw_batch_size 1, up to the
order of the sums.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from micformer_tpu_torch.infer.sliding_window import (
    _mirror_tta_predictor, _tile_starts, gaussian_importance_map,
)


@torch.no_grad()
def sliding_window_inference_sharded(
    volume: torch.Tensor,
    roi_size,
    predictor: Callable,
    *,
    group=None,
    num_classes: int = 8,
    overlap: float = 0.5,
    blend: str = "gaussian",
    step_mode: str = "monai",
    step_size: float = 0.5,
    mirror_tta: bool = False,
) -> torch.Tensor:
    """Blended tiled prediction of `volume` [B, C, D, H, W] (the same on
    every rank) with the tiles split over `group`'s ranks (default: the
    whole process group). Returns [B, num_classes, D, H, W] f32 logits on
    volume's device, on every rank."""
    import torch.distributed as dist

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
    rank, n_dev = ((dist.get_rank(group), dist.get_world_size(group))
                   if dist.is_initialized() else (0, 1))
    per_dev = -(-n_tiles // n_dev)
    pad_tiles = per_dev * n_dev - n_tiles
    coords = np.concatenate([coords, np.repeat(coords[:1], pad_tiles, 0)], 0)
    valid = np.arange(per_dev * n_dev) < n_tiles

    if mirror_tta:
        predictor = _mirror_tta_predictor(predictor)
    if blend == "gaussian":
        wmap = torch.from_numpy(gaussian_importance_map(roi)).to(dev)
    else:
        wmap = torch.ones(roi, dtype=torch.float32, device=dev)

    logit_acc = torch.zeros((B, num_classes) + padded, dtype=torch.float32, device=dev)
    weight_acc = torch.zeros((1, 1) + padded, dtype=torch.float32, device=dev)
    for t in range(rank * per_dev, (rank + 1) * per_dev):
        z, y, x = coords[t]
        sl = (slice(None), slice(None), slice(z, z + roi[0]), slice(y, y + roi[1]),
              slice(x, x + roi[2]))
        pred = predictor(volume[sl]).float()
        w = wmap * float(valid[t])
        logit_acc[sl] += pred * w
        weight_acc[sl] += w
    if n_dev > 1:
        dist.all_reduce(logit_acc, group=group)
        dist.all_reduce(weight_acc, group=group)
    out = logit_acc / weight_acc
    if any(pads):
        out = out[(slice(None), slice(None)) + tuple(
            slice(p // 2, p // 2 + s) for p, s in zip(pads, spatial))]
    return out
