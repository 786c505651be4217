"""Plan-driven preprocessing: a slimmed nnU-Net GenericPreprocessor.

Counterpart of `micformer_tpu/pipeline/preprocessing.py` (reference
MedNeXt/nnunet_mednext/preprocessing/preprocessing.py): crop to the nonzero
box, resample to the plan's target spacing (trilinear images, nearest label
maps), normalise per the plan's scheme (CT: clip to the foreground
percentiles and z-score with the plan's global statistics; otherwise a
per-image z-score), on top of the fingerprint and plan of
`pipeline/planner.py`.
"""

from __future__ import annotations

import numpy as np

from micformer_tpu_torch.data import image_utils as iu


def resample_to_spacing(volume: np.ndarray, in_spacing, out_spacing,
                        is_label: bool = False) -> np.ndarray:
    """Resample (z,y,x) volume (or [C,z,y,x]) from in_spacing to out_spacing.

    new_shape = round(shape * in/out) per axis (nnU-Net's rule); trilinear for
    images, nearest for label maps.
    """
    vol = np.asarray(volume)
    spatial = vol.shape[-3:]
    new_shape = tuple(
        max(1, int(round(s * float(i) / float(o))))
        for s, i, o in zip(spatial, in_spacing, out_spacing)
    )
    if new_shape == tuple(spatial):
        return vol
    if is_label:
        return iu.resize_nearest(vol, new_shape)
    return iu.resize_trilinear(vol, new_shape)


def crop_to_nonzero(image: np.ndarray, label: np.ndarray | None = None):
    """nnU-Net cropping.py behavior: crop image (+label) to the nonzero bbox
    of the image (any channel). Returns (image, label, bbox)."""
    img = np.asarray(image)
    nz = np.abs(img).sum(axis=0) if img.ndim == 4 else np.abs(img)
    if not nz.any():
        bbox = tuple((0, s) for s in nz.shape)
        return img, label, bbox
    bbox = iu.nonzero_bbox(nz)
    sl = tuple(slice(a, b) for a, b in bbox)
    full = (slice(None),) + sl if img.ndim == 4 else sl
    out_img = img[full]
    out_lab = None
    if label is not None:
        lab = np.asarray(label)
        out_lab = lab[(slice(None),) + sl if lab.ndim == 4 else sl]
    return out_img, out_lab, bbox


def normalize_with_plan(image: np.ndarray, plan: dict,
                        ct_like: bool = True) -> np.ndarray:
    """Plan normalization: CT-like -> clip to [p0.5, p99.5] of foreground and
    z-score with the GLOBAL plan mean/std (nnU-Net CT scheme); otherwise
    per-image nonzero z-score."""
    img = np.asarray(image, np.float32)
    if ct_like and all(k in plan for k in ("clip", "mean", "std")):
        lo, hi = plan["clip"]
        img = np.clip(img, lo, hi)
        return (img - plan["mean"]) / max(plan["std"], 1e-8)
    return iu.zscore_normalize(img)


def preprocess_with_plan(image: np.ndarray, label: np.ndarray | None,
                         plan: dict, in_spacing=(1, 1, 1),
                         target_spacing=(1, 1, 1)):
    """Full chain: crop-to-nonzero -> resample -> normalize. image [C,z,y,x];
    label int map [z,y,x] or one-hot [K,z,y,x]."""
    image, label, bbox = crop_to_nonzero(image, label)
    image = np.stack([
        resample_to_spacing(c, in_spacing, target_spacing) for c in image])
    if label is not None:
        label = resample_to_spacing(label, in_spacing, target_spacing, is_label=True)
    image = np.stack([normalize_with_plan(c, plan) for c in image])
    return image, label, bbox
