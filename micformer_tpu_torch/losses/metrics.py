"""Evaluation metrics: the reference's foreground mean Dice.

Counterpart of `meandice` in `micformer_tpu/losses/metrics.py`.
"""

from __future__ import annotations

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
