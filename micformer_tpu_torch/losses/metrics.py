"""Evaluation metrics: foreground mean Dice, mean IoU, HD95 and the
per-mask confusion tuple.

Counterpart of `micformer_tpu/losses/metrics.py`. `meandice` and `mean_iou`
run on torch tensors; the surface metrics are host code on numpy masks with
scipy's Euclidean distance transform, as in the JAX package (the reference
took mean IoU and HD95 from MONAI: include_background=False, percentile 95,
undirected).
"""

from __future__ import annotations

import numpy as np
import torch


def meandice(pred, label, num_class: int = 8):
    """Foreground mean Dice over integer class maps [B, ...]: per class c in
    1..num_class-1, (2·|pred==c ∧ label==c| + 1e-6) / (|pred==c| +
    |label==c| + 1e-6) with sums over the whole batch, then the mean over
    classes. Returns a float32 scalar tensor."""
    smooth = 1e-6
    classes = torch.arange(1, num_class, device=pred.device).view(-1, *([1] * pred.dim()))
    p = (pred.unsqueeze(0) == classes).float()
    lab = (label.unsqueeze(0) == classes).float()
    axes = tuple(range(1, p.dim()))
    inter = (p * lab).sum(axes)
    return ((2.0 * inter + smooth) / (p.sum(axes) + lab.sum(axes) + smooth)).mean()


def mean_iou(pred_onehot, label_onehot, include_background: bool = False,
             ignore_empty: bool = True):
    """MONAI's MeanIoU over binary one-hot maps [B, C, ...], a float32 scalar
    tensor. ignore_empty: (batch, class) cells with an empty ground truth are
    nan and left out of the mean; else a cell whose union is empty scores 1."""
    p = pred_onehot.float()
    lab = label_onehot.float()
    if not include_background:
        p, lab = p[:, 1:], lab[:, 1:]
    axes = tuple(range(2, p.dim()))
    inter = (p * lab).sum(axes)
    y_sum = lab.sum(axes)
    union = p.sum(axes) + y_sum - inter
    iou = inter / union.clamp_min(1e-38)
    if ignore_empty:
        return torch.where(y_sum > 0, iou, torch.nan).nanmean()
    return torch.where(union > 0, iou, 1.0).mean()


def _surface_distances(a: np.ndarray, b: np.ndarray, spacing=None) -> np.ndarray:
    """Distances from the surface voxels of mask `a` to the surface of mask
    `b`; [inf] when either is empty."""
    from scipy import ndimage

    a = a.astype(bool)
    b = b.astype(bool)
    if not a.any() or not b.any():
        return np.array([np.inf])
    # both surfaces lie in the bounding box of a | b, and every voxel outside
    # it is background: erosions and distances there equal the whole volume's
    box = tuple(slice(int(i.min()), int(i.max()) + 1) for i in np.nonzero(a | b))
    a, b = a[box], b[box]
    surf_a = a ^ ndimage.binary_erosion(a)
    surf_b = b ^ ndimage.binary_erosion(b)
    dist_to_b = ndimage.distance_transform_edt(~surf_b, sampling=spacing)
    return dist_to_b[surf_a]


def hd95(pred: np.ndarray, target: np.ndarray, spacing=None) -> float:
    """95th-percentile Hausdorff distance between two binary masks: the
    larger of the two directed 95th-percentile surface distances; nan when
    either mask is empty (MONAI's convention)."""
    pred = np.asarray(pred).astype(bool)
    target = np.asarray(target).astype(bool)
    if not pred.any() or not target.any():
        return float("nan")
    return _hd95_of(_surface_distances(pred, target, spacing),
                    _surface_distances(target, pred, spacing))


def _hd95_of(d_pt: np.ndarray, d_tp: np.ndarray) -> float:
    """HD95 of the two directed surface-distance sets."""
    return float(max(np.percentile(d_pt, 95), np.percentile(d_tp, 95)))


def hd95_multiclass(pred_labels: np.ndarray, target_labels: np.ndarray,
                    num_classes: int = 8, spacing=None):
    """HD95 of each foreground class 1..num_classes-1 of two label maps."""
    return [hd95(pred_labels == c, target_labels == c, spacing)
            for c in range(1, num_classes)]


def calculate_dice_tp_fp_fn(pred: np.ndarray, target: np.ndarray):
    """dict(dice, tp, fp, fn, sens, spec) of one binary mask pair."""
    pred = np.asarray(pred).astype(bool)
    target = np.asarray(target).astype(bool)
    tp = float(np.sum(pred & target))
    fp = float(np.sum(pred & ~target))
    fn = float(np.sum(~pred & target))
    tn = float(np.sum(~pred & ~target))
    dice = 2 * tp / max(2 * tp + fp + fn, 1e-8)
    sens = tp / max(tp + fn, 1e-8)
    spec = tn / max(tn + fp, 1e-8)
    return dict(dice=dice, tp=tp, fp=fp, fn=fn, sens=sens, spec=spec)
