"""Host-side (numpy) image utilities that MM-WHS preprocessing uses.

The port's own copy of the preprocessing subset of
`micformer_tpu/data/image_utils.py`: min-max normalisation, the MM-WHS
one-hot encoding, and the trilinear and nearest resizes with the semantics of
`F.interpolate` (align_corners=False half-pixel sampling, floor nearest) in
numpy, the separable path `_resize_trilinear_py` of the JAX package (not its
native library). Also the train-time pad-or-crop jitter and the nonzero
bounding box of the dataset's sample dict.
"""

from __future__ import annotations

import numpy as np

# MM-WHS label values of the 7 cardiac structures
MMWHS_LABEL_VALUES = (205, 420, 500, 550, 600, 820, 850)
NUM_CLASSES = 8  # background + 7 structures


def minmax_normalize(image: np.ndarray) -> np.ndarray:
    """Full-volume min-max scaler to [0, 1]; a constant volume gives zeros."""
    image = np.asarray(image, dtype=np.float32)
    min_ = image.min()
    scale = image.max() - min_
    if scale == 0:
        return np.zeros_like(image)
    return (image - min_) / scale


NORMALIZERS = {"minmax": minmax_normalize}


def label_to_one_hot(label: np.ndarray, label_values=MMWHS_LABEL_VALUES) -> np.ndarray:
    """8-channel one-hot: channel 0 is the background (label == 0), channels
    1..7 the structures (label == value)."""
    label = np.asarray(label)
    chans = [(label == 0).astype(np.int16)]
    for v in label_values:
        chans.append((label == v).astype(np.int16))
    return np.stack(chans, axis=0)


def _linear_weights(out_size: int, in_size: int):
    """Half-pixel (align_corners=False) source coords: lo index + frac weight."""
    scale = in_size / out_size
    x = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    x = np.clip(x, 0, in_size - 1)
    lo = np.floor(x).astype(np.int64)
    lo = np.minimum(lo, in_size - 2) if in_size > 1 else np.zeros_like(lo)
    frac = (x - lo).astype(np.float32)
    return lo, frac


def resize_trilinear(volume: np.ndarray, out_shape) -> np.ndarray:
    """Trilinear resize of a 3D volume, as F.interpolate(mode='trilinear',
    align_corners=False): one separable linear pass per axis, float32."""
    volume = np.asarray(volume, dtype=np.float32)
    if volume.ndim != 3:
        raise ValueError(f"resize_trilinear: expected a 3D volume, got {volume.shape}")
    out = volume
    for axis, out_size in enumerate(out_shape):
        in_size = out.shape[axis]
        if in_size == out_size:
            continue
        lo, frac = _linear_weights(out_size, in_size)
        a = np.take(out, lo, axis=axis)
        b = np.take(out, np.minimum(lo + 1, in_size - 1), axis=axis)
        shape = [1, 1, 1]
        shape[axis] = out_size
        w = frac.reshape(shape)
        out = a * (1.0 - w) + b * w
    return out


def resize_nearest(volume: np.ndarray, out_shape) -> np.ndarray:
    """Nearest resize of the last 3 axes as F.interpolate(mode='nearest'):
    src = floor(dst · in / out)."""
    volume = np.asarray(volume)
    lead = volume.ndim - 3
    out = volume
    for i, out_size in enumerate(out_shape):
        axis = lead + i
        in_size = out.shape[axis]
        if in_size == out_size:
            continue
        idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
        idx = np.minimum(idx, in_size - 1)
        out = np.take(out, idx, axis=axis)
    return out


def pad_or_crop_image(image, seg=None, target_size=(128, 128, 128), rng=None):
    """Random-offset crop and pad of [C, Z, Y, X] arrays to the target
    spatial size: a larger axis is cropped at a random start, a smaller one
    padded with a random left/right split. rng: a np.random.Generator."""
    if rng is None:
        rng = np.random.default_rng()
    c, z, y, x = image.shape
    slices = []
    pads = [(0, 0)]
    for target, dim in zip(target_size, (z, y, x)):
        if dim > target:
            left = int(rng.integers(0, dim - target + 1))
            slices.append(slice(left, left + target))
            pads.append((0, 0))
        else:
            slices.append(slice(0, dim))
            deficit = target - dim
            left = int(rng.integers(0, deficit + 1)) if deficit > 0 else 0
            pads.append((left, deficit - left))
    image = np.pad(image[:, slices[0], slices[1], slices[2]], pads)
    if seg is not None:
        return image, np.pad(seg[:, slices[0], slices[1], slices[2]], pads)
    return image


def nonzero_bbox(volume_sum: np.ndarray):
    """Bounding box of the nonzero region, its lower corner one voxel out
    (clamped at 0): ((z0, z1), (y0, y1), (x0, x1))."""
    idx = np.nonzero(volume_sum != 0)
    mins = [max(0, int(a.min()) - 1) for a in idx]
    maxs = [int(a.max()) + 1 for a in idx]
    return tuple((lo, hi) for lo, hi in zip(mins, maxs))
