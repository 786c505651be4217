"""Synthetic MM-WHS-like data for tests and on-card runs.

The port's own copy of `micformer_tpu/data/synthetic.py`: paired CT/MR
volumes and label maps with the real MM-WHS label values, written as
.nii.gz under the file names the dataset globs (ct_10XX_image.nii.gz, ...),
so the whole pipeline (NIfTI I/O, split, preprocessing, cache) runs without
the MM-WHS download. The same seed gives the same arrays as the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from micformer_tpu_torch.data.image_utils import MMWHS_LABEL_VALUES
from micformer_tpu_torch.data.nifti import write_nifti


def make_case(rng: np.random.Generator, shape=(64, 64, 64), n_blobs=7):
    """One case: (ct, ct_label, mr, mr_label) arrays in (z, y, x) order.

    The labels are ellipsoid structures with MM-WHS label values; CT and MR
    are smooth fields correlated with them, plus noise, with a zero margin."""
    z, y, x = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, z), np.linspace(-1, 1, y), np.linspace(-1, 1, x), indexing="ij"
    )
    label = np.zeros(shape, dtype=np.int16)
    intensity = np.zeros(shape, dtype=np.float32)
    for value in MMWHS_LABEL_VALUES[:n_blobs]:
        c = rng.uniform(-0.45, 0.45, size=3)
        r = rng.uniform(0.12, 0.3, size=3)
        d = ((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2 + ((xx - c[2]) / r[2]) ** 2
        mask = d < 1.0
        label[mask] = value
        intensity += np.exp(-2.0 * d).astype(np.float32) * float(value) / 850.0

    base = np.exp(-(zz**2 + yy**2 + xx**2)).astype(np.float32)
    ct = 400.0 * (base + intensity) + 20.0 * rng.standard_normal(shape).astype(np.float32)
    mr = 300.0 * (base + 0.7 * intensity**1.3) + 15.0 * rng.standard_normal(shape).astype(
        np.float32
    )
    margin = max(2, z // 16)
    for arr in (ct, mr):
        arr[:margin] = 0
        arr[-margin:] = 0
        arr[:, :margin] = 0
        arr[:, -margin:] = 0
        arr[:, :, :margin] = 0
        arr[:, :, -margin:] = 0
    # the MR label: the same anatomy with a few voxels dropped
    mr_label = label.copy()
    mr_label[rng.random(shape) < 0.02] = 0
    return ct, label, mr, mr_label


def write_synthetic_dataset(root, n_cases=4, shape=(64, 64, 64), seed=0, affine=None):
    """Write n_cases paired .nii.gz cases under `root`; returns the CT image
    paths. `affine` (4x4) goes into every file's sform."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_cases):
        pid = 1001 + i
        ct, ct_lab, mr, mr_lab = make_case(rng, shape)
        for name, arr in [
            (f"ct_{pid}_image.nii.gz", ct),
            (f"ct_{pid}_label.nii.gz", ct_lab),
            (f"mr_{pid}_image.nii.gz", mr),
            (f"mr_{pid}_label.nii.gz", mr_lab),
        ]:
            write_nifti(os.path.join(root, name), arr, affine=affine)
        paths.append(os.path.join(root, f"ct_{pid}_image.nii.gz"))
    return paths


def synthetic_batch(rng_or_seed=0, batch=1, shape=(32, 32, 32), channels=2, num_classes=8):
    """In-memory batch: image [B, C, *shape] f32 uniform, label
    [B, num_classes, *shape] f32 one-hot; no I/O."""
    rng = (
        rng_or_seed
        if isinstance(rng_or_seed, np.random.Generator)
        else np.random.default_rng(rng_or_seed)
    )
    image = rng.uniform(0, 1, size=(batch, channels, *shape)).astype(np.float32)
    idx = rng.integers(0, num_classes, size=(batch, *shape))
    label = np.eye(num_classes, dtype=np.float32)[idx]
    return image, np.moveaxis(label, -1, 1)
