"""Host-side (numpy) image utilities of the data pipeline.

The port's own copy of `micformer_tpu/data/image_utils.py`: the min-max,
percentile-clip and z-score normalisations, the MM-WHS one-hot encoding and
its inverse, and the trilinear and nearest resizes with the semantics of
`F.interpolate` (align_corners=False half-pixel sampling, floor nearest).
The trilinear resize of a volume whose shape changes runs in the native
library (`micformer_tpu_torch.native`) when it is built, else in numpy, one
separable pass per axis, as the JAX package's does. Also the train-time
pad-or-crop jitter, the nonzero bounding box of the dataset's sample dict,
and the reference's batch helpers (padding a batch to a common shape, the
background crop, the random crop, the padding collate).
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


def percentile_clip_normalize(image: np.ndarray, low_perc=1, high_perc=99) -> np.ndarray:
    """Clip to the low_perc-high_perc percentiles of the nonzero voxels, then
    min-max; a volume with no positive voxel gives zeros."""
    image = np.asarray(image, dtype=np.float32)
    non_zeros = image > 0
    if not non_zeros.any():
        return np.zeros_like(image)
    low, high = np.percentile(image[non_zeros], [low_perc, high_perc])
    return minmax_normalize(np.clip(image, low, high))


def zscore_normalize(image: np.ndarray) -> np.ndarray:
    """Z-score over the nonzero voxels; zeros stay zero."""
    image = np.asarray(image, dtype=np.float32).copy()
    mask = image != 0
    if mask.any():
        vals = image[mask]
        std = vals.std()
        image[mask] = (vals - vals.mean()) / (std if std > 0 else 1.0)
    return image


NORMALIZERS = {
    "minmax": minmax_normalize,
    "percentile": percentile_clip_normalize,
    "zscore": zscore_normalize,
}


def label_to_one_hot(label: np.ndarray, label_values=MMWHS_LABEL_VALUES) -> np.ndarray:
    """8-channel one-hot: channel 0 is the background (label == 0), channels
    1..7 the structures (label == value)."""
    label = np.asarray(label)
    chans = [(label == 0).astype(np.int16)]
    for v in label_values:
        chans.append((label == v).astype(np.int16))
    return np.stack(chans, axis=0)


def one_hot_to_label(one_hot: np.ndarray, label_values=MMWHS_LABEL_VALUES) -> np.ndarray:
    """Inverse: the argmax channel as the MM-WHS label value (0 for the
    background)."""
    lut = np.array([0] + list(label_values))
    return lut[np.argmax(one_hot, axis=0)]


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
    """Trilinear resize of a 3D volume, or of each channel of a [C, D, H, W]
    array, as F.interpolate(mode='trilinear', align_corners=False), float32:
    the native kernel when it is built and the shape changes, else one
    separable linear pass per axis."""
    volume = np.asarray(volume, dtype=np.float32)
    if volume.ndim == 4:
        return np.stack([resize_trilinear(c, out_shape) for c in volume])
    if volume.ndim != 3:
        raise ValueError(f"resize_trilinear: expected a 3D or 4D volume, got {volume.shape}")
    if tuple(volume.shape) != tuple(out_shape):
        from micformer_tpu_torch import native

        out = native.resize_trilinear_f32(volume, out_shape)
        if out is not None:
            return out
    return _resize_trilinear_py(volume, out_shape)


def _resize_trilinear_py(volume: np.ndarray, out_shape) -> np.ndarray:
    """The numpy trilinear resize of a float32 3D volume: one separable
    linear pass per axis."""
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


def pad_batch_to_max_shape(shapes, divisor=16):
    """Common batch shape: the per-axis max rounded up to a multiple of
    `divisor` (reference batch_utils.py:7-20, deterministic)."""
    maxes = np.max(np.asarray(shapes), axis=0)
    return tuple(int(-(-m // divisor) * divisor) for m in maxes)


def remove_unwanted_background(image: np.ndarray, threshold: float = 1e-5) -> np.ndarray:
    """Crop to the bounding box of voxels above `threshold`; every axis is
    cropped, the channel axis too, as the reference does (image_utils.py:81-90)."""
    idx = np.nonzero(image > threshold)
    bbox = tuple(slice(int(a.min()), int(a.max()) + 1) for a in idx)
    return image[bbox]


def random_crop(*images, min_perc: float = 0.5, max_perc: float = 1.0, rng=None):
    """One random crop of channel-first arrays to a random fraction of each
    spatial extent; the channel axis is never cropped (reference
    random_crop2d, image_utils.py:93-118). `rng`: a np.random.Generator.

    The reference's random_crop3d hands its percentages positionally into
    random_crop2d's *images, a defect of the reference that the JAX package
    does not copy: both names are this function."""
    if len({tuple(im.shape) for im in images}) > 1:
        raise ValueError("Image shapes do not match")
    if rng is None:
        rng = np.random.default_rng()
    shape = images[0].shape
    bbox = [slice(0, shape[0])]
    for ax_size in shape[1:]:
        size = max(1, int(ax_size * rng.uniform(min_perc, max_perc)))
        lo = int(rng.integers(0, ax_size - size + 1))
        bbox.append(slice(lo, lo + size))
    bbox = tuple(bbox)
    cropped = [im[bbox] for im in images]
    return cropped[0] if len(cropped) == 1 else cropped


random_crop2d = random_crop
random_crop3d = random_crop


def collate_pad_batch(images, labels, divisor: int = 16, rng=None):
    """Stack [C, Z, Y, X] samples of several shapes into one batch, each
    padded to `pad_batch_to_max_shape` (reference custom_collate,
    batch_utils.py:7-37). With `rng` (a np.random.Generator) each deficit is
    split at random between the two sides; without, it all goes right."""
    target = pad_batch_to_max_shape([im.shape[1:] for im in images], divisor)
    out_im, out_lb = [], []
    for im, lb in zip(images, labels):
        pads = [(0, 0)]
        for t, dim in zip(target, im.shape[1:]):
            deficit = t - dim
            assert deficit >= 0, "Negative padding value error !!"
            left = int(rng.integers(0, deficit + 1)) if rng is not None and deficit else 0
            pads.append((left, deficit - left))
        out_im.append(np.pad(im, pads))
        out_lb.append(np.pad(lb, pads))
    return np.stack(out_im), np.stack(out_lb)


def pad_batch1_to_compatible_size(batch: np.ndarray, divisor: int = 16):
    """Right-pad a [B, C, Z, Y, X] array so each spatial axis divides
    `divisor`; returns (padded, (zpad, ypad, xpad)) for un-padding after
    inference (reference batch_utils.py:40-54)."""
    zyx = batch.shape[-3:]
    pads = tuple(int(-(-d // divisor) * divisor) - d for d in zyx)
    padded = np.pad(batch, [(0, 0)] * (batch.ndim - 3) + [(0, p) for p in pads])
    return padded, pads
