"""Postprocessing: largest-connected-component suppression.

The port's own copy of `micformer_tpu/pipeline/postprocess.py` (nnU-Net's
`remove_all_but_the_largest_connected_component` and the
`determine_postprocessing` decision): per class, keep only the largest 26-
connected component, and decide per class from validation data whether that
improves Dice. Host code on numpy label maps, with scipy.ndimage.
"""

from __future__ import annotations

import numpy as np


def largest_cc_mask(binary: np.ndarray) -> np.ndarray:
    """Boolean mask of the largest 26-connected component (empty-safe)."""
    from scipy import ndimage

    lab, n = ndimage.label(binary, structure=np.ones((3, 3, 3), np.int8))
    if n == 0:
        return np.zeros_like(binary, bool)
    sizes = ndimage.sum(binary, lab, index=np.arange(1, n + 1))
    return lab == (1 + int(np.argmax(sizes)))


def remove_all_but_largest_cc(seg: np.ndarray, labels=None, background: int = 0) -> np.ndarray:
    """Per-class largest-CC suppression on an integer label map; the voxels
    removed become `background`. labels: default every label present."""
    out = seg.copy()
    labels = labels if labels is not None else [l for l in np.unique(seg) if l != background]
    for l in labels:
        mask = seg == l
        if not mask.any():
            continue
        keep = largest_cc_mask(mask)
        out[mask & ~keep] = background
    return out


def _dice(a, b):
    a, b = a.astype(bool), b.astype(bool)
    denom = a.sum() + b.sum()
    return 1.0 if denom == 0 else 2.0 * np.logical_and(a, b).sum() / denom


def determine_postprocessing(val_preds, val_gts, labels, min_gain: float = 0.0):
    """{label: bool}: whether largest-CC suppression of that label raises the
    mean validation Dice by more than min_gain (nnU-Net's decision rule,
    without its union-of-classes stage)."""
    decisions = {}
    for l in labels:
        base, post = [], []
        for pred, gt in zip(val_preds, val_gts):
            pm, gm = pred == l, gt == l
            base.append(_dice(pm, gm))
            post.append(_dice(pm & largest_cc_mask(pm) if pm.any() else pm, gm))
        decisions[int(l)] = float(np.mean(post)) > float(np.mean(base)) + min_gain
    return decisions


def apply_postprocessing(seg: np.ndarray, decisions: dict, background: int = 0) -> np.ndarray:
    """Largest-CC suppression of the labels `decisions` turns on."""
    labels = [l for l, on in decisions.items() if on]
    return remove_all_but_largest_cc(seg, labels, background) if labels else seg
