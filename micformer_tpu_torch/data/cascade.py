"""The cascade's data: a previous stage's segmentation as one-hot input
channels, and nnU-Net's pyramid augmentations of them at train time.

The port's own copy of `micformer_tpu/data/cascade.py` (host numpy and
scipy.ndimage morphology, so the same seeds give bitwise the same channels):
  - the V2 cascade's protocol constants: binary operator p 0.4, ball radius
    U(1, 8), p a label 1; remove a connected component p 0.2, at most 15 %
    of the volume, moved to another class with p 0; input channels grow by
    num_classes - 1, the one-hot of the foreground labels;
  - nnU-Net's moreDA wiring swaps the last two probabilities, which makes
    its remove-component augmentation a no-op at these defaults; the
    documented intent is the default here, and `faithful_moreda_swap=True`
    reproduces the swap.
"""

from __future__ import annotations

import os

import numpy as np
from scipy import ndimage

from micformer_tpu_torch.data.loader import VisitSeeds


def ball(radius: float) -> np.ndarray:
    """Spherical structuring element (skimage.morphology.ball): a boolean
    [2r+1]³ grid (r = int(radius)) of the points within `radius` of its
    centre."""
    r = int(radius)
    z, y, x = np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1]
    return (z * z + y * y + x * x) <= radius * radius


_BINARY_OPS = ("dilation", "erosion", "closing", "opening")
_OP_FNS = {
    "dilation": ndimage.binary_dilation,
    "erosion": ndimage.binary_erosion,
    "closing": ndimage.binary_closing,
    "opening": ndimage.binary_opening,
}


def seg_to_onehot(seg: np.ndarray, labels) -> np.ndarray:
    """[D, H, W] int -> [len(labels), D, H, W] float32 one-hot of `labels`
    (one channel a listed label; the cascade lists foreground labels
    1..K-1)."""
    seg = np.asarray(seg)
    return np.stack([(seg == l) for l in labels]).astype(np.float32)


def apply_random_binary_operator(onehot: np.ndarray, rng: np.random.Generator,
                                 p_per_sample: float = 0.4, strel_size=(1, 8),
                                 p_per_label: float = 1.0) -> np.ndarray:
    """nnU-Net's ApplyRandomBinaryOperatorTransform on one sample's one-hot
    channels [K, D, H, W]: with p_per_sample, visit the channels in random
    order and (with p_per_label) apply a random morphology op with a ball of
    random radius; voxels a channel gains are cleared from the others, so
    the channels stay one-hot."""
    onehot = np.asarray(onehot)
    if rng.uniform() >= p_per_sample:
        return onehot
    out = onehot.copy()
    order = rng.permutation(out.shape[0])
    for c in order:
        if rng.uniform() >= p_per_label:
            continue
        op = _OP_FNS[_BINARY_OPS[rng.integers(len(_BINARY_OPS))]]
        selem = ball(rng.uniform(*strel_size))
        workon = out[c].astype(bool)
        res = op(workon, structure=selem)
        out[c] = res.astype(out.dtype)
        added = res & ~workon
        for oc in order:
            if oc != c:
                out[oc][added] = 0
    return out


def remove_random_connected_component(onehot: np.ndarray, rng: np.random.Generator,
                                      p_per_sample: float = 0.2,
                                      fill_with_other_class_p: float = 0.0,
                                      dont_do_if_covers_more_than: float = 0.15,
                                      p_per_label: float = 1.0,
                                      faithful_moreda_swap: bool = False) -> np.ndarray:
    """nnU-Net's RemoveRandomConnectedComponentFromOneHotEncodingTransform:
    with p_per_sample, for each channel (with p_per_label) zero a random
    connected component that covers less than `dont_do_if_covers_more_than`
    of the volume, and with `fill_with_other_class_p` set it in another
    random channel. `faithful_moreda_swap=True` swaps the two
    probabilities as nnU-Net's moreDA wiring does."""
    if faithful_moreda_swap:
        fill_with_other_class_p, dont_do_if_covers_more_than = (
            dont_do_if_covers_more_than, fill_with_other_class_p)
    onehot = np.asarray(onehot)
    if rng.uniform() >= p_per_sample:
        return onehot
    out = onehot.copy()
    num_voxels = np.prod(out.shape[1:], dtype=np.uint64)
    channels = list(range(out.shape[0]))
    for c in channels:
        if rng.uniform() >= p_per_label:
            continue
        lab, num_comp = ndimage.label(out[c].astype(bool))
        if num_comp == 0:
            continue
        sizes = ndimage.sum_labels(np.ones_like(lab), lab, index=range(1, num_comp + 1))
        ids = [i + 1 for i, s in enumerate(sizes)
               if s < num_voxels * dont_do_if_covers_more_than]
        if not ids:
            continue
        comp = ids[rng.integers(len(ids))]
        mask = lab == comp
        out[c][mask] = 0
        if rng.uniform() < fill_with_other_class_p:
            other = [i for i in channels if i != c]
            if other:
                out[other[rng.integers(len(other))]][mask] = 1
    return out


def cascade_augment_onehot(onehot: np.ndarray, rng: np.random.Generator,
                           binary_op_p: float = 0.4, strel_size=(1, 8),
                           remove_cc_p: float = 0.2, remove_cc_max_cover: float = 0.15,
                           remove_cc_fill_other_p: float = 0.0) -> np.ndarray:
    """The V2 cascade's train-time augmentation of the previous stage's
    channels, in moreDA's order (binary operator, then remove a component),
    with its trainer's defaults."""
    onehot = apply_random_binary_operator(onehot, rng, p_per_sample=binary_op_p,
                                          strel_size=strel_size)
    return remove_random_connected_component(
        onehot, rng, p_per_sample=remove_cc_p, fill_with_other_class_p=remove_cc_fill_other_p,
        dont_do_if_covers_more_than=remove_cc_max_cover)


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


class CascadeDataset:
    """A sample-dict dataset whose `image` [C, D, H, W] gains num_classes - 1
    channels: the previous stage's segmentation
    `<seg_dir>/<patient_id>_segFromPrevStage.npy`, resized nearest to the
    image grid, one-hot over labels 1..num_classes-1 and, with `augment`,
    pyramid-augmented. Item i's draws are per visit (`VisitSeeds`)."""

    def __init__(self, base, seg_dir: str, num_classes: int,
                 augment: bool = True, seed: int = 0):
        self.base = base
        self.seg_dir = seg_dir
        self.labels = list(range(1, num_classes))
        self.augment = augment
        self._rng_for = VisitSeeds(seed)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        s = dict(self.base[i])
        img = np.asarray(s["image"])
        pid = s["patient_id"]
        seg = np.load(os.path.join(self.seg_dir, f"{pid}_segFromPrevStage.npy"))
        seg = resize_seg_nearest(seg, img.shape[1:])
        onehot = seg_to_onehot(seg, self.labels)
        if self.augment:
            onehot = cascade_augment_onehot(onehot, self._rng_for(i))
        s["image"] = np.concatenate([img, onehot.astype(img.dtype)], axis=0)
        return s
