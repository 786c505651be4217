"""The BraTS-2021 dataset.

Counterpart of `micformer_tpu/data/brats.py` (reference dataset/brats.py,
which the MM-WHS path does not use). Per patient directory: the four
modalities (t1, t1ce, t2, flair), each min-max (or z-score) normalised, the
nested BraTS regions ET, TC and WT from the label values (ET = 4; TC = 1 or
4; WT = 1, 2 or 4), the train-time pad-or-crop to the target, and the
MM-WHS dataset's sample-dict schema.
"""

from __future__ import annotations

import os
from glob import glob
from pathlib import Path

import numpy as np

from micformer_tpu_torch.data import image_utils as iu
from micformer_tpu_torch.data.nifti import read_nifti

MODALITIES = ("t1", "t1ce", "t2", "flair")


class BratsDataset:
    def __init__(self, patient_dirs, training=True, target_size=(128, 128, 128),
                 normalisation="minmax", seed=1234):
        self.patient_dirs = [Path(p) for p in patient_dirs]
        self.training = training
        self.target_size = tuple(target_size)
        self.normalisation = normalisation
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.patient_dirs)

    def _load_patient(self, pdir: Path):
        pid = pdir.name
        imgs = []
        for mod in MODALITIES:
            path = pdir / f"{pid}_{mod}.nii.gz"
            vol = np.asarray(read_nifti(str(path)), dtype=np.float32)
            if self.normalisation == "minmax":
                vol = iu.minmax_normalize(vol)
            else:
                vol = iu.zscore_normalize(vol)
            imgs.append(vol)
        seg_path = pdir / f"{pid}_seg.nii.gz"
        seg = np.asarray(read_nifti(str(seg_path)), dtype=np.int16) if seg_path.exists() else None
        return np.stack(imgs), seg, str(seg_path)

    @staticmethod
    def regions_from_label(seg: np.ndarray) -> np.ndarray:
        """[3, ...] bool: ET (4), TC (1|4), WT (1|2|4) — nested BraTS regions."""
        et = seg == 4
        tc = np.logical_or(seg == 1, et)
        wt = np.logical_or(tc, seg == 2)
        return np.stack([et, tc, wt])

    def __getitem__(self, idx):
        pdir = self.patient_dirs[idx]
        image, seg, seg_path = self._load_patient(pdir)
        label = (self.regions_from_label(seg).astype(np.uint8)
                 if seg is not None else np.zeros((3,) + image.shape[1:], np.uint8))
        et_present = int(label[0].any())
        if self.training:
            image, label = iu.pad_or_crop_image(image, label,
                                                target_size=self.target_size,
                                                rng=self._rng)
        return dict(patient_id=pdir.name, image=image.astype(np.float32),
                    label=label, seg_path=seg_path, crop_indexes=None,
                    et_present=et_present, supervised=True)


def get_brats_datasets(data_root, seed=1234, fold=0, n_splits=5,
                       target_size=(128, 128, 128), normalisation="minmax"):
    """(train, val, bench) with the same KFold split machinery as MM-WHS."""
    from micformer_tpu_torch.data.mmwhs import kfold_split

    dirs = sorted(d for d in glob(os.path.join(data_root, "*")) if os.path.isdir(d))
    if not dirs:
        raise FileNotFoundError(f"no patient dirs under {data_root}")
    tr, va, te = kfold_split(len(dirs), n_splits, seed, fold)

    def make(idx, training):
        return BratsDataset([dirs[i] for i in idx], training, target_size, normalisation,
                            seed)

    return make(tr, True), make(va, False), make(te, False)
