"""MM-WHS paired CT+MR dataset: split, preprocessing, cache, sample dicts.

The port's own copy of `micformer_tpu/data/mmwhs.py`. A case is four NIfTI
files (ct/mr image and label); preprocessing min-max normalises each image
over the whole volume, resizes it trilinearly to the target shape, one-hots
the labels (background + 7 structures) and resizes them nearest. The
deterministic part is computed once and cached as .npy, so later epochs
read memory maps.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob
from pathlib import Path

import numpy as np

from micformer_tpu_torch.data import image_utils as iu
from micformer_tpu_torch.data.nifti import read_nifti


def kfold_split(n_items: int, n_splits: int = 5, seed: int = 1234, fold: int = 0):
    """(train_idx, val_idx, test_idx): scikit-learn's KFold(n_splits,
    shuffle=True, random_state=seed) written out (a RandomState permutation
    cut into contiguous folds, the first n % n_splits one longer), with the
    held-out fold halved into validation and test."""
    rng = np.random.RandomState(seed)
    perm = np.arange(n_items)
    rng.shuffle(perm)
    fold_sizes = np.full(n_splits, n_items // n_splits, dtype=int)
    fold_sizes[: n_items % n_splits] += 1
    starts = np.concatenate([[0], np.cumsum(fold_sizes)])
    held = np.sort(perm[starts[fold]: starts[fold + 1]])
    mask = np.ones(n_items, bool)
    mask[held] = False
    train_idx = np.arange(n_items)[mask]
    half = len(held) // 2
    return train_idx, held[:half], held[half:]


@dataclass
class CasePaths:
    patient_id: str
    ct: str
    ct_label: str
    mr: str
    mr_label: str

    @classmethod
    def from_ct_image(cls, ct_path: str) -> "CasePaths":
        """The case of `ct_<id>_image.nii.gz`: its partners differ in the file
        name only (the JAX package rewrites the whole path, so a directory
        named with "ct" or "image" breaks it)."""
        root, name = os.path.split(str(ct_path))
        mr = name.replace("ct", "mr")
        return cls(
            patient_id=name.split("_")[-2],
            ct=os.path.join(root, name),
            ct_label=os.path.join(root, name.replace("image", "label")),
            mr=os.path.join(root, mr),
            mr_label=os.path.join(root, mr.replace("image", "label")),
        )


def discover_cases(data_root: str, pattern: str = "ct_*_image.nii.gz"):
    """The cases under data_root, sorted by CT image path."""
    paths = sorted(glob(os.path.join(str(data_root), pattern)))
    return [CasePaths.from_ct_image(p) for p in paths]


def preprocess_case(case: CasePaths, target_shape=(128, 128, 128), normalisation="minmax"):
    """(image [2, *target] float32 in [0, 1] with channels CT, MR;
    label [16, *target] uint8, the CT one-hot (8) then the MR one-hot (8))."""
    norm = iu.NORMALIZERS[normalisation]
    ct = norm(read_nifti(case.ct, dtype=np.float32))
    mr = norm(read_nifti(case.mr, dtype=np.float32))
    image = np.stack(
        [iu.resize_trilinear(ct, target_shape), iu.resize_trilinear(mr, target_shape)]
    ).astype(np.float32)
    ct_lab = iu.label_to_one_hot(read_nifti(case.ct_label))
    mr_lab = iu.label_to_one_hot(read_nifti(case.mr_label))
    label = np.concatenate(
        [iu.resize_nearest(ct_lab, target_shape), iu.resize_nearest(mr_lab, target_shape)]
    ).astype(np.uint8)
    return image, label


class MMWHSDataset:
    """Cached MM-WHS dataset of sample dicts: patient_id, image [2, D, H, W]
    float32 (with `single_modal`, the CT channel alone, [1, D, H, W]), label
    [8, D, H, W] uint8 (the CT one-hot), seg_path, crop_indexes,
    et_present=0, supervised=True. In training the random pad-or-crop
    jitter to `patch_size` (default the target shape) applies: the identity
    when the two are equal, as the preprocessed volume has the target
    shape."""

    def __init__(self, cases, training=True, target_shape=(128, 128, 128),
                 normalisation="minmax", cache_dir=None, seed=1234, patch_size=None,
                 single_modal=False):
        self.cases = list(cases)
        self.training = training
        self.target_shape = tuple(target_shape)
        self.normalisation = normalisation
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.patch_size = tuple(patch_size) if patch_size else self.target_shape
        self.single_modal = single_modal
        self._rng = np.random.default_rng(seed)
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def __len__(self):
        return len(self.cases)

    def _load(self, case: CasePaths):
        if self.cache_dir is None:
            return preprocess_case(case, self.target_shape, self.normalisation)
        tag = f"{case.patient_id}_{'x'.join(map(str, self.target_shape))}_{self.normalisation}"
        img_p = self.cache_dir / f"{tag}_img.npy"
        lab_p = self.cache_dir / f"{tag}_lab.npy"
        if img_p.exists() and lab_p.exists():
            return np.load(img_p, mmap_mode="r"), np.load(lab_p, mmap_mode="r")
        image, label = preprocess_case(case, self.target_shape, self.normalisation)
        np.save(img_p, image)
        np.save(lab_p, label)
        return image, label

    def __getitem__(self, idx):
        case = self.cases[idx]
        image, label = self._load(case)
        image = np.asarray(image, dtype=np.float32)
        if self.single_modal:
            image = image[:1]
        label_ct = np.asarray(label[:8], dtype=np.uint8)
        nz = np.sum(image, axis=0)
        crop_indexes = iu.nonzero_bbox(nz) if nz.any() else ((0, 0), (0, 0), (0, 0))
        if self.training:
            image, label_ct = iu.pad_or_crop_image(
                image, label_ct, target_size=self.patch_size, rng=self._rng)
        return dict(patient_id=case.patient_id, image=image, label=label_ct,
                    seg_path=str(case.ct_label), crop_indexes=crop_indexes,
                    et_present=0, supervised=True)


def get_datasets(data_root, seed: int = 1234, fold: int = 0,
                 normalisation: str = "minmax", cache_dir=None,
                 target_shape=(128, 128, 128), single_modal=False):
    """(train, val, test) datasets from the 5-fold split of the cases under
    data_root; `single_modal` keeps the CT channel alone."""
    cases = discover_cases(data_root)
    if not cases:
        raise FileNotFoundError(f"no ct_*_image.nii.gz under {data_root}")
    tr, va, te = kfold_split(len(cases), 5, seed, fold)

    def make(idx, training):
        return MMWHSDataset([cases[i] for i in idx], training=training,
                            target_shape=target_shape, normalisation=normalisation,
                            cache_dir=cache_dir, seed=seed, single_modal=single_modal)

    return make(tr, True), make(va, False), make(te, False)
