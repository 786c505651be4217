"""Learning-rate schedules as plain functions of the step.

Counterpart of `micformer_tpu/train/schedules.py`. The trainer drives them
through `torch.optim.lr_scheduler.LambdaLR`, stepped once per batch: the
first update uses lr·schedule(0), as optax's `scale_by_schedule` does.
  - cosine_annealing: torch's CosineAnnealingLR closed form, eta_min +
    (base - eta_min)·(1 + cos(π t / t_max)) / 2, periodic past t_max. With
    per_batch=True, t is the step count over t_max = epochs (the reference's
    quirk: it steps the scheduler per batch); per_batch=False steps it per
    epoch.
  - poly_lr: nnU-Net's polynomial decay, initial·(1 - step/max_steps)^0.9.
"""

from __future__ import annotations

import math


def cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0,
                     steps_per_epoch: int = 1, per_batch: bool = True):
    """A function of the global step count."""

    def schedule(step):
        t = step if per_batch else step // max(steps_per_epoch, 1)
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t / t_max)) / 2

    return schedule


def poly_lr(initial_lr: float, max_steps: int, exponent: float = 0.9):
    def schedule(step):
        frac = min(max(step / max_steps, 0.0), 1.0)
        return initial_lr * (1 - frac) ** exponent

    return schedule
