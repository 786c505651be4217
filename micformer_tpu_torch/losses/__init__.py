"""Losses and metrics of the training path."""

from micformer_tpu_torch.losses.dice import (  # noqa: F401
    hard_dice_metric, mdice_loss, mdice_val_loss, soft_dice_per_channel,
)
from micformer_tpu_torch.losses.metrics import hd95, mean_iou, meandice  # noqa: F401
