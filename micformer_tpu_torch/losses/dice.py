"""The Dice losses and the hard Dice metric.

Counterpart of the `mdice` and `dice_ce` subset of
`micformer_tpu/losses/dice.py`: the reference's MDiceLoss (per-channel
sigmoid soft Dice with squared denominators, smooth 1, plus per-channel BCE,
(0.7·dice + 0.3·bce)/C), its validation variant (Dice only) and its
`.metric` (hard Dice at 0.5 per patient and channel); nnU-Net's softmax Dice
plus cross-entropy and its deep-supervision wrapper (MedNeXt's native
preset). Everything accumulates in float32 whatever the input dtype, so bf16
logits under autocast are fine.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reduce_axes(x: torch.Tensor) -> tuple:
    """Batch and spatial axes: every axis but the channel axis 1."""
    return (0,) + tuple(range(2, x.dim()))


def soft_dice_per_channel(logits, targets, smooth: float = 1.0):
    """1 - soft Dice per channel, reduced over batch and space jointly.
    logits, targets: [B, C, ...]. Returns [C]."""
    probs = torch.sigmoid(logits.float())
    t = targets.float()
    axes = _reduce_axes(logits)
    inter = (probs * t).sum(axes)
    denom = (probs * probs).sum(axes) + (t * t).sum(axes)
    return 1.0 - (2.0 * inter + smooth) / (denom + smooth)


def bce_per_channel(logits, targets):
    """Mean binary cross-entropy per channel on sigmoid probabilities,
    computed stably from the logits: softplus(x) - x·t. Returns [C]."""
    x = logits.float()
    t = targets.float()
    bce = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return bce.mean(_reduce_axes(logits))


def mdice_loss(logits, targets):
    """Train loss: (0.7·Σ_c softDice_c + 0.3·Σ_c BCE_c) / C."""
    dice = soft_dice_per_channel(logits, targets).sum()
    ce = bce_per_channel(logits, targets).sum()
    return (0.7 * dice + 0.3 * ce) / logits.shape[1]


def mdice_val_loss(logits, targets):
    """Validation loss: mean over channels of the soft Dice loss."""
    return soft_dice_per_channel(logits, targets).mean()


def hard_dice_metric(logits, targets):
    """Hard Dice at 0.5 per (patient, channel), [B, C]; an empty target
    scores 1 if the prediction is empty too, else 0. No smoothing."""
    pred = (torch.sigmoid(logits.float()) > 0.5).float()
    t = targets.float()
    axes = tuple(range(2, logits.dim()))
    inter = (pred * t).sum(axes)
    psum = pred.sum(axes)
    tsum = t.sum(axes)
    dice = 2.0 * inter / (psum + tsum).clamp_min(1e-38)
    empty = torch.where(psum == 0, torch.ones_like(dice), torch.zeros_like(dice))
    return torch.where(tsum == 0, empty, dice)


def softmax_dice_ce_loss(logits, target):
    """nnU-Net's DC_and_CE_loss: 1 - mean over every class (background
    included) of the softmax soft Dice (reduced over batch and space
    jointly, linear denominators, smooth 1e-5), plus the voxel-mean
    cross-entropy against the (possibly soft) target, weighted 1 : 1.
    logits, target: [B, C, ...]. Returns a scalar."""
    smooth = 1e-5
    x = logits.float()
    t = target.float()
    probs = torch.softmax(x, dim=1)
    axes = _reduce_axes(x)
    inter = (probs * t).sum(axes)
    denom = probs.sum(axes) + t.sum(axes)
    dice = (2.0 * inter + smooth) / (denom + smooth)
    ce = -(t * torch.log_softmax(x, dim=1)).sum(1).mean()
    return (1.0 - dice.mean()) + ce


def deep_supervision_loss(logits_pyramid, target, loss_fn=softmax_dice_ce_loss):
    """nnU-Net's MultipleOutputLoss2: output i weighted 2^-i, the weights
    normalised to sum 1 (in f32), each against the target taken at its
    resolution by strided slicing (nearest, [::f] per axis)."""
    n = len(logits_pyramid)
    w = torch.tensor([2.0 ** (-i) for i in range(n)], dtype=torch.float32,
                     device=target.device)
    w = w / w.sum()
    total = 0.0
    for i, lg in enumerate(logits_pyramid):
        t = target
        if lg.shape[2:] != target.shape[2:]:
            factors = [ts // ls for ts, ls in zip(target.shape[2:], lg.shape[2:])]
            t = target[(slice(None), slice(None)) + tuple(slice(None, None, f)
                                                          for f in factors)]
        total = total + w[i] * loss_fn(lg, t)
    return total


def one_hot(labels, num_classes: int):
    """uint8/int class maps [B, D, H, W] -> float32 one-hot [B, K, D, H, W]."""
    return F.one_hot(labels.long(), num_classes).movedim(-1, 1).float()
