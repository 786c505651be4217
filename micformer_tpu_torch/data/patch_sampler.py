"""nnU-Net's foreground-oversampled random patches.

The port's own copy of `micformer_tpu/data/patch_sampler.py` (host numpy, so
the same seed draws bitwise the same patches): each batch draws random
patches, and the batch positions at or above round(batch·(1 - p)) are
forced to contain foreground by centring the crop on a random voxel of a
random present class (nnU-Net's DataLoader3D, p = 0.33 by default). The
class locations are subsampled and cached per case, as nnU-Net's unpacking
step does.
"""

from __future__ import annotations

import numpy as np

from micformer_tpu_torch.data.loader import VisitSeeds


def compute_class_locations(label: np.ndarray, classes, max_per_class: int = 10000,
                            seed: int = 0):
    """{class: [n, 3] int32 voxel coordinates}, at most max_per_class a class
    (a seeded subsample without replacement); classes absent from the label
    are left out. label: [D, H, W] integer map, or [C, D, H, W] one-hot
    (argmaxed)."""
    if label.ndim == 4:
        label = np.argmax(label, axis=0)
    rng = np.random.RandomState(seed)
    out = {}
    for c in classes:
        coords = np.argwhere(label == c)
        if len(coords) > max_per_class:
            coords = coords[rng.choice(len(coords), max_per_class, replace=False)]
        if len(coords):
            out[int(c)] = coords.astype(np.int32)
    return out


def sample_patch(image: np.ndarray, label: np.ndarray, patch_size,
                 force_fg: bool, class_locations: dict | None,
                 rng: np.random.Generator):
    """One random patch of image [C, *patch] and label [Cl, *patch]. A
    volume smaller than the patch is zero-padded (centred) first. With
    force_fg the crop is centred (then clipped into the volume) on a random
    voxel of a random present class, so that class lies inside the patch."""
    spatial = np.asarray(image.shape[1:])
    ps = np.asarray(patch_size)
    pad = np.maximum(ps - spatial, 0)
    if pad.any():
        cfg = [(0, 0)] + [(p // 2, p - p // 2) for p in pad]
        image = np.pad(image, cfg)
        label = np.pad(label, cfg)
        spatial = np.asarray(image.shape[1:])

    lo = np.zeros(3, int)
    hi = spatial - ps  # the largest start, inclusive
    if force_fg and class_locations:
        cls = list(class_locations.keys())
        c = cls[int(rng.integers(len(cls)))]
        vox = class_locations[c][int(rng.integers(len(class_locations[c])))]
        start = np.clip(vox - ps // 2, lo, hi)
    else:
        start = np.array([int(rng.integers(l, h + 1)) for l, h in zip(lo, hi)])
    sl = tuple([slice(None)] + [slice(int(s), int(s + p)) for s, p in zip(start, ps)])
    return image[sl], label[sl]


class OversampledPatchDataset:
    """A case-level dataset of sample dicts turned into a patch sampler of
    as many items: item i draws a random case and a patch of it,
    foreground-forced when its batch position i % batch_size is at or above
    round(batch_size·(1 - p)). Item i's draws are per visit (`VisitSeeds`)."""

    def __init__(self, base_dataset, patch_size=(128, 128, 128), batch_size=2,
                 oversample_foreground_percent: float = 0.33, num_classes: int = 8,
                 seed: int = 0):
        self.base = base_dataset
        self.patch_size = tuple(patch_size)
        self.batch_size = batch_size
        self.oversample = oversample_foreground_percent
        self.num_classes = num_classes
        self._loc_cache = {}
        self._rng_for = VisitSeeds(seed)

    def __len__(self):
        return len(self.base)

    def _force_fg(self, position_in_batch: int) -> bool:
        return position_in_batch >= round(self.batch_size * (1 - self.oversample))

    def _locations(self, idx, label):
        if idx not in self._loc_cache:
            self._loc_cache[idx] = compute_class_locations(
                label, range(1, self.num_classes), seed=idx)
        return self._loc_cache[idx]

    def __getitem__(self, i):
        rng = self._rng_for(i)
        idx = int(rng.integers(len(self.base)))
        s = self.base[idx]
        image = np.asarray(s["image"], np.float32)
        label = np.asarray(s["label"], np.float32)
        force = self._force_fg(i % self.batch_size)
        locs = self._locations(idx, label) if force else None
        img_p, lab_p = sample_patch(image, label, self.patch_size, force, locs, rng)
        return dict(s, image=img_p, label=lab_p)
