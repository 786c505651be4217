"""The training and validation harness.

Counterpart of `micformer_tpu/train/trainer.py`, restricted to what the
MicFormer and MedNeXt training slices run:
  - Adam (AdamW when weight decay is set), AdamW or SGD with Nesterov
    momentum 0.99, each followed by the schedule (cosine stepped per batch
    with T_max = epochs, the reference's quirk, or per epoch; poly;
    constant) as a LambdaLR multiplier, and optional clipping by global norm
    before the optimizer;
  - the mdice or dice_ce (softmax Dice + CE) train loss, through the
    deep-supervision wrapper when it is set and the model returns its
    pyramid (else the pyramid's full-resolution output); in validation
    mdice_val_loss, meandice and the per-class hard Dice of the
    full-resolution output, through a direct forward when the volume equals
    the roi and sliding-window inference otherwise;
  - the `monai`, `nnunet` or no train-time augmentation;
  - the NaN guard: a non-finite loss skips the update, so parameters,
    optimizer state and the step count stay as they were, and
    max_consecutive_nan skips in a row halt the run;
  - `latest`, `best_dice` and `best_loss` checkpoints, resume, patience;
  - bf16 as the JAX package's dtype=bf16, param_dtype=f32: the parameters
    stay f32 and `torch.autocast` runs the forward and the loss in bf16.
Configuration fields of the JAX trainer that this slice does not run raise
when they are set.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from micformer_tpu_torch.kernels import LAUNCHES
from micformer_tpu_torch.losses.dice import (
    deep_supervision_loss, hard_dice_metric, mdice_loss, mdice_val_loss, one_hot,
    softmax_dice_ce_loss,
)
from micformer_tpu_torch.losses.metrics import meandice
from micformer_tpu_torch.train.checkpoint import CheckpointManager
from micformer_tpu_torch.train.logging import MetricsWriter, save_metrics
from micformer_tpu_torch.train.meters import AverageMeter, ProgressMeter, Timer
from micformer_tpu_torch.train.schedules import cosine_annealing, poly_lr


LOSSES = {"mdice": mdice_loss, "dice_ce": softmax_dice_ce_loss}


def full_resolution(out):
    """The full-resolution logits of a model's output: the first of a
    deep-supervision pyramid, or the output itself."""
    return out[0] if isinstance(out, (list, tuple)) else out


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 300
    lr: float = 1e-4
    weight_decay: float = 0.0
    num_classes: int = 8
    val_every: int = 10
    seed: int = 1234
    scheduler: str = "cosine"           # cosine | poly | constant
    scheduler_per_batch: bool = True    # the reference's quirk
    steps_per_epoch: int = 16
    optimizer: str = "adam"             # adam | adamw | sgd_nesterov
    loss: str = "mdice"                 # mdice | dice_ce (nnU-Net preset)
    deep_supervision: bool = False
    grad_clip_norm: float | None = None
    nan_guard: bool = True
    max_consecutive_nan: int = 50
    run_dir: str = "runs/default"
    augment: str = "monai"              # monai | nnunet | none
    # intensity transforms touch only the first num_modalities channels
    num_modalities: int | None = None
    # validation tiles a volume whose shape differs from roi
    roi: tuple | None = None
    sw_overlap: float = 0.5
    sw_batch_size: int = 1
    latest_every: int = 1
    keep_best_k: int | None = None
    patience: int | None = None
    patience_min_delta: float = 5e-4
    val_metric_alpha: float = 0.9
    bf16: bool = False
    # fields of the JAX trainer that are not ported yet: setting one raises
    pretrained: str | None = None
    zero1: bool = False
    mesh: str | None = None

    def __post_init__(self):
        for name in ("pretrained", "zero1", "mesh"):
            if getattr(self, name):
                raise NotImplementedError(f"TrainConfig.{name} is not ported yet")
        if self.loss not in LOSSES:
            raise NotImplementedError(
                f"loss {self.loss!r} is not ported yet: {sorted(LOSSES)} are; the rest "
                "of the JAX loss zoo (gdl, topk, focal, mcc, dice_topk, dice_bce) is not")
        if self.augment not in ("monai", "nnunet", "none"):
            raise ValueError(f"unknown augment {self.augment!r}")
        if self.optimizer not in ("adam", "adamw", "sgd_nesterov"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.scheduler not in ("cosine", "poly", "constant"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")


def unit_schedule(cfg: TrainConfig):
    """The schedule multiplier (base 1) as a function of the step."""
    if cfg.scheduler == "cosine":
        return cosine_annealing(1.0, cfg.epochs, steps_per_epoch=cfg.steps_per_epoch,
                                per_batch=cfg.scheduler_per_batch)
    if cfg.scheduler == "poly":
        return poly_lr(1.0, cfg.epochs * cfg.steps_per_epoch)
    return lambda step: 1.0


def make_optimizer(params, cfg: TrainConfig):
    """The optimizer of cfg at base learning rate cfg.lr."""
    params = list(params)
    if cfg.optimizer == "sgd_nesterov":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.99, nesterov=True)
    if cfg.optimizer == "adam" and cfg.weight_decay == 0:
        return torch.optim.Adam(params, lr=cfg.lr)
    return torch.optim.AdamW(params, lr=cfg.lr, weight_decay=cfg.weight_decay)


def clip_by_global_norm(params, max_norm: float):
    """optax.clip_by_global_norm: every gradient times max_norm / norm when
    the global norm is at least max_norm, in place."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


class Trainer:
    """Trains `model` (already on its device, f32 parameters) under cfg.

    `history` keeps one record per train step: loss, skipped, seconds (host
    clock, which the loss read synchronises) and the kernel launches the
    step made."""

    def __init__(self, model, cfg: TrainConfig):
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.schedule = unit_schedule(cfg)
        self.optimizer = make_optimizer(self.params, cfg)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, self.schedule)
        self.step = 0
        self.nan_streak = 0
        # drop-path masks and augmentation draws
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.ckpt = CheckpointManager(cfg.run_dir, keep_best_k=cfg.keep_best_k)
        os.makedirs(cfg.run_dir, exist_ok=True)
        self._log_path = os.path.join(cfg.run_dir, "log.jsonl")
        self.writer = MetricsWriter(cfg.run_dir)
        self.history: list[dict] = []

    def _log(self, record: dict):
        with open(self._log_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.cfg.bf16)

    def prep_batch(self, images, labels):
        """Loader batches to the device: f16 images to f32, uint8 class maps
        to f32 one-hot [B, K, D, H, W]."""
        images = images.to(self.device, non_blocking=True).float()
        labels = labels.to(self.device, non_blocking=True)
        if labels.dim() == images.dim() - 1:
            labels = one_hot(labels, self.cfg.num_classes)
        return images, labels.float()

    def _augment(self, images, labels):
        if self.cfg.augment == "monai":
            from micformer_tpu_torch.data.transforms import batched_train_augment

            return batched_train_augment(self.generator, images, labels,
                                         self.cfg.num_modalities)
        if self.cfg.augment == "nnunet":
            from micformer_tpu_torch.data.transforms import batched_nnunet_train_augment

            return batched_nnunet_train_augment(self.generator, images, labels,
                                                self.cfg.num_modalities)
        return images, labels

    def loss(self, out, labels):
        """The train loss of a model output: with deep supervision set and a
        pyramid given, the weighted sum over it; otherwise the loss of the
        full-resolution logits."""
        fn = LOSSES[self.cfg.loss]
        if self.cfg.deep_supervision and isinstance(out, (list, tuple)):
            return deep_supervision_loss(list(out), labels, loss_fn=fn)
        return fn(full_resolution(out), labels)

    def _val_transform(self, images):
        if self.cfg.augment == "monai":
            from micformer_tpu_torch.data.transforms import val_normalize

            return val_normalize(images, self.cfg.num_modalities)
        return images

    def train_step(self, images, labels) -> dict:
        """One step on a loader batch. The gradients stay in the parameters'
        .grad until the next step."""
        cfg = self.cfg
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        self.model.train()
        images, labels = self.prep_batch(images, labels)
        images, labels = self._augment(images, labels)
        self.optimizer.zero_grad(set_to_none=True)
        with self._autocast():
            loss = self.loss(self.model(images, generator=self.generator), labels)
        loss.backward()
        value = loss.item()
        skipped = cfg.nan_guard and not math.isfinite(value)
        if not skipped:
            if cfg.grad_clip_norm:
                clip_by_global_norm(self.params, cfg.grad_clip_norm)
            self.optimizer.step()
            self.scheduler.step()
            self.step += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rec = {"step": self.step, "loss": value, "skipped": skipped,
               "seconds": time.perf_counter() - t0,
               "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES}}
        self.history.append(rec)
        return rec

    def lr_now(self) -> float:
        return self.cfg.lr * float(self.schedule(self.step))

    def _payload(self, epoch, best_dice, best_loss):
        return {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step,
                "epoch": epoch, "best_dice": best_dice, "best_loss": best_loss}

    def restore(self, tag: str) -> dict:
        """Load a checkpoint's params, optimizer and schedule state and step;
        returns the payload."""
        payload = self.ckpt.restore(tag, map_location=self.device)
        self.model.load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.scheduler.load_state_dict(payload["scheduler"])
        self.step = int(payload["step"])
        return payload

    def fit(self, train_loader, val_loader=None, resume: bool = False, log_every: int = 10):
        cfg = self.cfg
        n_params = sum(p.numel() for p in self.params)
        print(f"model parameters: {n_params:,}", flush=True)
        self._log({"n_parameters": n_params})

        start_epoch = 0
        best_dice, best_loss = -1.0, float("inf")
        tag = next((t for t in ("latest", "best_dice") if self.ckpt.exists(t)),
                   None) if resume else None
        if tag:
            payload = self.restore(tag)
            start_epoch = int(payload["epoch"]) + 1
            best_dice = float(payload.get("best_dice", -1.0))
            best_loss = float(payload.get("best_loss", float("inf")))
            print(f"resumed from epoch {start_epoch} ({tag}, step {self.step})", flush=True)

        ema, best_ema, since_best = None, -float("inf"), 0
        for epoch in range(start_epoch, cfg.epochs):
            tmeter = AverageMeter("Time", ":4.3f")
            dmeter = AverageMeter("Data", ":4.3f")
            lmeter = AverageMeter("Loss", ":.4e")
            progress = ProgressMeter(len(train_loader), [tmeter, dmeter, lmeter],
                                     prefix=f"Epoch: [{epoch}]")
            timer = Timer()
            for i, (images, labels, _) in enumerate(train_loader):
                dmeter.update(timer.lap())
                rec = self.train_step(images, labels)
                lmeter.update(rec["loss"])
                if rec["skipped"]:
                    self.nan_streak += 1
                    if self.nan_streak >= cfg.max_consecutive_nan:
                        raise FloatingPointError(
                            f"{self.nan_streak} consecutive non-finite losses: halting")
                else:
                    self.nan_streak = 0
                tmeter.update(timer.lap())
                if i % log_every == 0:
                    progress.display(i)
            lr = self.lr_now()
            self._log({"epoch": epoch, "train_loss": lmeter.avg, "lr": lr})
            self.writer.scalar("train/loss", lmeter.avg, epoch)
            self.writer.scalar("train/lr", lr, epoch)
            if cfg.latest_every and (epoch + 1) % cfg.latest_every == 0:
                self.ckpt.save("latest", self._payload(epoch, best_dice, best_loss))

            if val_loader is None or (epoch + 1) % cfg.val_every != 0:
                continue
            vm = self.validate(val_loader)
            self._log({"epoch": epoch, **{k: v for k, v in vm.items()
                                          if not isinstance(v, np.ndarray)}})
            self.writer.scalar("val/loss", vm["val_loss"], epoch)
            self.writer.scalar("val/meandice", vm["meandice"], epoch)
            save_metrics(self.writer, vm["per_class_dice"],
                         [f"c{i}" for i in range(cfg.num_classes)], epoch, cfg.run_dir)
            if vm["meandice"] > best_dice:
                best_dice = vm["meandice"]
                self.ckpt.save("best_dice", self._payload(epoch, best_dice, best_loss),
                               metric=float(vm["meandice"]))
            if vm["val_loss"] < best_loss:
                best_loss = vm["val_loss"]
                self.ckpt.save("best_loss", self._payload(epoch, best_dice, best_loss),
                               metric=-float(vm["val_loss"]))
            if cfg.patience is not None and np.isfinite(vm["meandice"]):
                a = cfg.val_metric_alpha
                ema = vm["meandice"] if ema is None else a * ema + (1 - a) * vm["meandice"]
                if ema > best_ema + cfg.patience_min_delta:
                    best_ema, since_best = ema, 0
                else:
                    since_best += 1
                if since_best >= cfg.patience:
                    print(f"early stop at epoch {epoch}: no validation improvement in "
                          f"{cfg.patience} validations", flush=True)
                    return

    def eval_metrics(self, logits, labels) -> dict:
        """mdice_val_loss, meandice of the argmax maps and the per-class hard
        Dice [B, C] of one validation batch."""
        logits = logits.float()
        pred = torch.softmax(logits, dim=1).argmax(dim=1)
        return {"val_loss": float(mdice_val_loss(logits, labels)),
                "meandice": float(meandice(pred, labels.argmax(dim=1), self.cfg.num_classes)),
                "per_class_dice": hard_dice_metric(logits, labels).cpu().numpy()}

    @torch.no_grad()
    def validate(self, val_loader) -> dict:
        from micformer_tpu_torch.infer.sliding_window import sliding_window_inference

        cfg = self.cfg
        self.model.eval()
        losses, dices, per_class = [], [], []
        for images, labels, _ in val_loader:
            images, labels = self.prep_batch(images, labels)
            images = self._val_transform(images)
            with self._autocast():
                if cfg.roi is not None and tuple(images.shape[2:]) != tuple(cfg.roi):
                    logits = sliding_window_inference(
                        images, cfg.roi, lambda x: full_resolution(self.model(x)),
                        num_classes=cfg.num_classes, overlap=cfg.sw_overlap,
                        sw_batch_size=cfg.sw_batch_size)
                else:
                    logits = full_resolution(self.model(images))
            m = self.eval_metrics(logits, labels)
            losses.append(m["val_loss"])
            dices.append(m["meandice"])
            per_class.append(m["per_class_dice"])
        pc = (np.concatenate(per_class, axis=0) if per_class
              else np.zeros((0, cfg.num_classes)))
        return {"val_loss": float(np.mean(losses)) if losses else float("nan"),
                "meandice": float(np.mean(dices)) if dices else float("nan"),
                "per_class_dice_mean": pc.mean(0).tolist() if len(pc) else [],
                "per_class_dice": pc}
