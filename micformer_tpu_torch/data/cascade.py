"""The cascade's input channels: a previous stage's segmentation as one-hot.

The port's own copy of `seg_to_onehot` and `resize_seg_nearest` of
`micformer_tpu/data/cascade.py`, which predict's `--cascade-prev-seg-dir`
needs. The cascade dataset and its train-time augmentation are not ported
yet.
"""

from __future__ import annotations

import numpy as np


def seg_to_onehot(seg: np.ndarray, labels) -> np.ndarray:
    """[D, H, W] int -> [len(labels), D, H, W] float32 one-hot of `labels`
    (one channel a listed label; the cascade lists foreground labels
    1..K-1)."""
    seg = np.asarray(seg)
    return np.stack([(seg == l) for l in labels]).astype(np.float32)


def resize_seg_nearest(seg: np.ndarray, target_shape) -> np.ndarray:
    """Nearest-neighbour resize of an integer label map to `target_shape`,
    sampling each output voxel's centre."""
    seg = np.asarray(seg)
    if tuple(seg.shape) == tuple(target_shape):
        return seg
    idx = tuple(
        np.minimum((np.arange(t) + 0.5) * s / t, s - 1).astype(np.int64)
        for t, s in zip(target_shape, seg.shape)
    )
    return seg[np.ix_(*idx)]
