"""The Dice losses, nnU-Net's loss zoo and the hard Dice metric.

Counterpart of `micformer_tpu/losses/dice.py`: the reference's MDiceLoss
(per-channel sigmoid soft Dice with squared denominators, smooth 1, plus
per-channel BCE, (0.7·dice + 0.3·bce)/C), its validation variant (Dice
only) and its `.metric` (hard Dice at 0.5 per patient and channel);
nnU-Net's softmax Dice plus cross-entropy and its deep-supervision wrapper
(MedNeXt's native preset); and the rest of nnU-Net's zoo: generalized Dice,
top-k cross-entropy, focal, MCC, Dice + top-k, Dice + BCE and the BraTS
region loss. Every loss upcasts its inputs to float32 and runs only
element-wise ops, reductions, softmax and top-k, none of which autocast
lowers, so under bf16 autocast it still computes in float32.

Dice-style losses reduce over batch and space jointly, and top-k takes its
k % over the whole flattened batch. Inside `global_batch(group)` (the
data-parallel trainer's step, each rank holding equal rows of the batch)
every such sum is all-reduced over the group's ranks before any ratio, the
voxel counts of the means are the global ones, and top-k gathers each
rank's local top-k_global and keeps the top k_global of those: every rank
then computes the loss of the global batch, as the JAX step does under
GSPMD. The all-reduces are differentiable, and their backward sums the
gradient over the ranks, so each rank's gradient is W times its share of
the global loss's; DistributedDataParallel's mean over the ranks then
gives the global loss's gradient.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from micformer_tpu_torch.parallel.mesh import all_gather, all_reduce_sum

# the process group whose ranks hold the global batch, inside global_batch
_GROUP = contextvars.ContextVar("global_batch_group", default=None)


@contextlib.contextmanager
def global_batch(group=None):
    """Losses computed inside reduce over the global batch of `group`'s
    ranks (default: the whole process group); see the module docstring."""
    import torch.distributed as dist

    token = _GROUP.set(group or dist.group.WORLD)
    try:
        yield
    finally:
        _GROUP.reset(token)


def _reduce_axes(x: torch.Tensor) -> tuple:
    """Batch and spatial axes: every axis but the channel axis 1."""
    return (0,) + tuple(range(2, x.dim()))


def _sum(x: torch.Tensor, axes) -> torch.Tensor:
    """x summed over `axes`, and over the ranks inside global_batch."""
    s = x.sum(axes)
    group = _GROUP.get()
    return s if group is None else all_reduce_sum(s, group)


def _world() -> int:
    import torch.distributed as dist

    group = _GROUP.get()
    return 1 if group is None else dist.get_world_size(group)


def _voxels(x: torch.Tensor) -> int:
    """The voxel count of the (global) batch of x [B, C, ...]: every rank
    holds as many rows."""
    return x.numel() // x.shape[1] * _world()


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over every axis of x [B, ...] of the (global) batch."""
    return _sum(x, tuple(range(x.dim()))) / (x.numel() * _world())


def soft_dice_per_channel(logits, targets, smooth: float = 1.0):
    """1 - soft Dice per channel, reduced over batch and space jointly.
    logits, targets: [B, C, ...]. Returns [C]."""
    probs = torch.sigmoid(logits.float())
    t = targets.float()
    axes = _reduce_axes(logits)
    inter = _sum(probs * t, axes)
    denom = _sum(probs * probs, axes) + _sum(t * t, axes)
    return 1.0 - (2.0 * inter + smooth) / (denom + smooth)


def bce_per_channel(logits, targets):
    """Mean binary cross-entropy per channel on sigmoid probabilities,
    computed stably from the logits: softplus(x) - x·t. Returns [C]."""
    x = logits.float()
    t = targets.float()
    bce = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return _sum(bce, _reduce_axes(logits)) / _voxels(logits)


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


def softmax_dice_ce_loss(logits, target, ce_weight=1.0, dice_weight=1.0, smooth=1e-5,
                         include_background=True):
    """nnU-Net's DC_and_CE_loss: 1 - mean over the classes (background
    included unless `include_background` is false) of the softmax soft Dice
    (reduced over batch and space jointly, linear denominators), weighted
    `dice_weight`, plus the voxel-mean cross-entropy against the (possibly
    soft) target, weighted `ce_weight`. logits, target: [B, C, ...].
    Returns a scalar."""
    x = logits.float()
    t = target.float()
    probs = torch.softmax(x, dim=1)
    axes = _reduce_axes(x)
    inter = _sum(probs * t, axes)
    denom = _sum(probs, axes) + _sum(t, axes)
    dice = (2.0 * inter + smooth) / (denom + smooth)
    if not include_background:
        dice = dice[1:]
    ce = _mean(-(t * torch.log_softmax(x, dim=1)).sum(1))
    return dice_weight * (1.0 - dice.mean()) + ce_weight * ce


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


def generalized_dice_loss(logits, target, smooth=1e-5, square_volumes=False):
    """nnU-Net's GDL: softmax soft Dice with class weights 1 / volume²
    (volumes floored at 1e-3), reduced over batch and space jointly."""
    x = torch.softmax(logits.float(), dim=1)
    t = target.float()
    axes = _reduce_axes(logits)
    vol = _sum(t, axes)
    w = 1.0 / (vol * vol).clamp_min(1e-6)
    inter = _sum(x * t, axes)
    if square_volumes:
        denom = _sum(x * x, axes) + _sum(t * t, axes)
    else:
        denom = _sum(x, axes) + _sum(t, axes)
    return 1.0 - (2.0 * (w * inter).sum() + smooth) / ((w * denom).sum() + smooth)


def topk_ce_loss(logits, target, k_percent: float = 10.0):
    """nnU-Net's TopKLoss: the mean of the k % largest per-voxel
    cross-entropies of the whole batch, k = max(1, int(N·k%/100)) of its N
    voxels. Inside global_batch N is the global count, and the top k of the
    ranks' local top-k values are taken."""
    ce = -(target.float() * torch.log_softmax(logits.float(), dim=1)).sum(1).reshape(-1)
    k = max(1, int(ce.shape[0] * _world() * k_percent / 100.0))
    top = torch.topk(ce, min(k, ce.shape[0]), sorted=False).values
    group = _GROUP.get()
    if group is not None:
        top = torch.topk(all_gather(top, group).reshape(-1), k, sorted=False).values
    return top.mean()


def focal_loss(logits, target, gamma: float = 2.0, alpha: float = 0.25):
    """Focal loss on softmax probabilities: the voxel mean of
    Σ_c t_c · -alpha (1 - p_c)^gamma log p_c."""
    logp = torch.log_softmax(logits.float(), dim=1)
    focal = -alpha * (1 - logp.exp()) ** gamma * logp
    return _mean((target.float() * focal).sum(1))


def mcc_loss(logits, target, smooth: float = 1.0):
    """nnU-Net's MCCLoss: 1 - the mean over classes of the soft Matthews
    correlation, its confusion sums divided by the voxel count (batch and
    space) and the root's argument clamped at 1e-12."""
    x = torch.softmax(logits.float(), dim=1)
    t = target.float()
    axes = _reduce_axes(logits)
    n_vox = float(_voxels(logits))
    tp = _sum(x * t, axes) / n_vox
    fp = _sum(x * (1 - t), axes) / n_vox
    fn = _sum((1 - x) * t, axes) / n_vox
    tn = _sum((1 - x) * (1 - t), axes) / n_vox
    num = tp * tn - fp * fn
    den = torch.sqrt(((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)).clamp_min(1e-12))
    return 1.0 - ((num + smooth) / (den + smooth)).mean()


def dice_topk_loss(logits, target, k_percent: float = 10.0):
    """nnU-Net's DC_and_topk_loss: the softmax soft Dice loss plus top-k
    cross-entropy."""
    return (softmax_dice_ce_loss(logits, target, ce_weight=0.0)
            + topk_ce_loss(logits, target, k_percent))


def dice_bce_loss(logits, target):
    """nnU-Net's DC_and_BCE_loss (region mode): the mean over channels of
    the sigmoid soft Dice loss plus the mean of the per-channel BCE."""
    return soft_dice_per_channel(logits, target).mean() + bce_per_channel(logits, target).mean()


def edice_loss(logits, region_targets):
    """The reference's EDiceLoss (BraTS ET/TC/WT regions): the mean over
    regions of the sigmoid soft Dice loss."""
    return soft_dice_per_channel(logits, region_targets).mean()


def one_hot(labels, num_classes: int):
    """uint8/int class maps [B, D, H, W] -> float32 one-hot [B, K, D, H, W]."""
    return F.one_hot(labels.long(), num_classes).movedim(-1, 1).float()
