"""Dataset integrity verification: `verify_dataset_integrity`.

Counterpart of `micformer_tpu/pipeline/sanity_checks.py` (reference
MedNeXt/nnunet_mednext/preprocessing/sanity_checks.py:25-235) over the
MM-WHS layout (data/mmwhs.py names: ct_<id>_image / ct_<id>_label /
mr_<id>_image / mr_<id>_label .nii.gz), on the port's `NiftiHeader`:

  - every case has all four files;
  - image and label geometry match per modality (shape and affine: the
    reference's spacing, origin and direction check);
  - labels hold only the expected values (the raw MM-WHS codes or mapped
    class indices);
  - no image holds a NaN;
  - all cases share one orientation (the sign pattern of the affine's
    rotation).

Returns a report; `strict=True` raises on the errors, as the reference's
asserts do.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from micformer_tpu_torch.data.image_utils import MMWHS_LABEL_VALUES
from micformer_tpu_torch.data.nifti import read_nifti


def _orientation_signature(affine: np.ndarray):
    """Axis-permutation/sign signature of the rotation part (the nearest-axes
    analog of nibabel's io_orientation used by verify_all_same_orientation)."""
    rot = np.asarray(affine)[:3, :3]
    sig = []
    for i in range(3):
        j = int(np.argmax(np.abs(rot[:, i])))
        sig.append((j, 1 if rot[j, i] >= 0 else -1))
    return tuple(sig)


def verify_same_geometry(hdr_a, hdr_b, atol: float = 1e-3) -> bool:
    """Shape + affine agreement (sanity_checks.py:45-76 checks size, spacing,
    origin and direction — all encoded in shape+affine here)."""
    if tuple(hdr_a.shape[:3]) != tuple(hdr_b.shape[:3]):
        return False
    return bool(np.allclose(np.asarray(hdr_a.affine), np.asarray(hdr_b.affine),
                            atol=atol))


def verify_contains_only_expected_labels(label_arr, valid_labels) -> tuple:
    """(ok, unexpected_values) — sanity_checks.py:79-87."""
    found = np.unique(np.asarray(label_arr))
    valid = set(int(v) for v in valid_labels)
    unexpected = [float(v) for v in found if int(v) != v or int(v) not in valid]
    return (not unexpected, unexpected)


def verify_dataset_integrity(folder: str, expected_labels=None,
                             strict: bool = False) -> dict:
    """Check an MM-WHS-layout folder; returns {cases, errors, warnings}.

    expected_labels defaults to the raw MM-WHS codes plus the mapped class
    indices 0..7 (both layouts appear depending on pipeline stage)."""
    if expected_labels is None:
        expected_labels = {0, *range(8), *MMWHS_LABEL_VALUES}
    errors, warnings = [], []

    ids = sorted({os.path.basename(p)[3:-len("_image.nii.gz")]
                  for p in glob.glob(os.path.join(folder, "ct_*_image.nii.gz"))})
    if not ids:
        errors.append(f"no ct_*_image.nii.gz cases under {folder}")
    orientations = set()
    for pid in ids:
        files = {kind: os.path.join(folder, f"{mod}_{pid}_{kind2}.nii.gz")
                 for kind, (mod, kind2) in {
                     "ct_image": ("ct", "image"), "ct_label": ("ct", "label"),
                     "mr_image": ("mr", "image"), "mr_label": ("mr", "label"),
                 }.items()}
        missing = [k for k, p in files.items() if not os.path.exists(p)]
        if missing:
            errors.append(f"case {pid}: missing {missing}")
            continue
        hdrs, arrs = {}, {}
        for k, p in files.items():
            arr, hdr = read_nifti(p, with_header=True)
            hdrs[k], arrs[k] = hdr, np.asarray(arr)
        for mod in ("ct", "mr"):
            if not verify_same_geometry(hdrs[f"{mod}_image"], hdrs[f"{mod}_label"]):
                errors.append(f"case {pid}: {mod} image/label geometry mismatch")
        for k in ("ct_image", "mr_image"):
            if np.isnan(arrs[k]).any():
                errors.append(f"case {pid}: NaN values in {k}")
        for k in ("ct_label", "mr_label"):
            ok, bad = verify_contains_only_expected_labels(arrs[k], expected_labels)
            if not ok:
                errors.append(f"case {pid}: unexpected label values {bad} in {k}")
        orientations.add(_orientation_signature(hdrs["ct_image"].affine))
    if len(orientations) > 1:
        warnings.append(
            f"not all cases share one orientation ({len(orientations)} found) "
            "— resample/reorient before training (sanity_checks.py:230)")
    report = {"cases": ids, "errors": errors, "warnings": warnings}
    if strict and errors:
        raise AssertionError("; ".join(errors))
    return report
