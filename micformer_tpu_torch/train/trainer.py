"""The training and validation harness.

Counterpart of `micformer_tpu/train/trainer.py`, restricted to what the
MicFormer and MedNeXt training slices run:
  - Adam (AdamW when weight decay is set), AdamW or SGD with Nesterov
    momentum 0.99, each followed by the schedule (cosine stepped per batch
    with T_max = epochs, the reference's quirk, or per epoch; poly;
    constant) as a LambdaLR multiplier, and optional clipping by global norm
    before the optimizer;
  - the eight train losses of the JAX trainer (mdice, dice_ce, gdl, topk,
    focal, mcc, dice_topk, dice_bce), through the deep-supervision wrapper
    when it is set and the model returns its pyramid (else the pyramid's
    full-resolution output); in validation
    mdice_val_loss, meandice and the per-class hard Dice of the
    full-resolution output, through a direct forward when the volume equals
    the roi and sliding-window inference otherwise;
  - the `monai`, `nnunet` or no train-time augmentation;
  - the NaN guard: a non-finite loss skips the update, so parameters,
    optimizer state and the step count stay as they were, and
    max_consecutive_nan skips in a row halt the run;
  - `latest`, `best_dice` and `best_loss` checkpoints, resume, patience;
  - `pretrained`: weights seeded from another port run's checkpoint
    (`convert/pretrained.py`), after init and before a resume, which wins;
  - `find_lr`, the LR range test;
  - bf16 as the JAX package's dtype=bf16, param_dtype=f32: the parameters
    stay f32 and `torch.autocast` runs the forward in bf16 (the losses
    compute in f32);
  - data parallelism, `mesh` ("data=N", over a process group of N ranks,
    `parallel/distributed.py`): the model runs under
    DistributedDataParallel and each rank trains on its rows of the global
    batch (the loader's rank rows). Augmentation and DropPath draw for the
    global batch and keep the rank's rows, and the losses reduce over the
    global batch (`losses.dice.global_batch`), so every rank reports the
    loss of the global batch, which the NaN guard reads, and DDP's mean of
    the gradients is its gradient, which clipping sees. `zero1` splits the
    optimizer state over the ranks (ZeroRedundancyOptimizer; a no-op below
    data = 2, as in JAX); its checkpoints hold the consolidated state in the
    plain optimizer's format. Validation runs case-parallel (cases
    round-robin by rank, metrics gathered in case order). Only the primary
    rank writes checkpoints, log.jsonl and metrics; checkpoints hold the
    unwrapped model's state_dict, so any run resumes at any world size,
    with or without zero1.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from micformer_tpu_torch.kernels import LAUNCHES
from micformer_tpu_torch.losses.dice import (
    deep_supervision_loss, dice_bce_loss, dice_topk_loss, focal_loss, generalized_dice_loss,
    global_batch, hard_dice_metric, mcc_loss, mdice_loss, mdice_val_loss, one_hot,
    softmax_dice_ce_loss, topk_ce_loss,
)
from micformer_tpu_torch.losses.metrics import meandice
from micformer_tpu_torch.models.layers import batch_rows
from micformer_tpu_torch.parallel.mesh import is_primary, make_mesh, zero1
from micformer_tpu_torch.train.checkpoint import CheckpointManager
from micformer_tpu_torch.train.logging import MetricsWriter, save_metrics
from micformer_tpu_torch.train.meters import AverageMeter, ProgressMeter, Timer
from micformer_tpu_torch.tracing import span
from micformer_tpu_torch.train.schedules import cosine_annealing, poly_lr
from micformer_tpu_torch.utils import count_parameters


LOSSES = {"mdice": mdice_loss, "dice_ce": softmax_dice_ce_loss, "gdl": generalized_dice_loss,
          "topk": topk_ce_loss, "focal": focal_loss, "mcc": mcc_loss,
          "dice_topk": dice_topk_loss, "dice_bce": dice_bce_loss}


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
    loss: str = "mdice"                 # one of LOSSES
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
    # "run_dir" or "run_dir:tag" (default best_dice): seed the weights from
    # another port run's checkpoint, heads excluded; a live resume wins
    pretrained: str | None = None
    # ZeRO-1 optimizer-state sharding over the mesh's data axis; a no-op
    # below data = 2
    zero1: bool = False
    # "data=N": data parallelism over a process group of N ranks
    mesh: str | None = None

    def __post_init__(self):
        if self.loss not in LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; one of {sorted(LOSSES)}")
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


def make_optimizer(params, cfg: TrainConfig, sharded: bool = False):
    """The optimizer of cfg at base learning rate cfg.lr; `sharded`: its
    state split over the ranks (ZeRO-1)."""
    if cfg.optimizer == "sgd_nesterov":
        cls, kw = torch.optim.SGD, dict(lr=cfg.lr, momentum=0.99, nesterov=True)
    elif cfg.optimizer == "adam" and cfg.weight_decay == 0:
        cls, kw = torch.optim.Adam, dict(lr=cfg.lr)
    else:
        cls, kw = torch.optim.AdamW, dict(lr=cfg.lr, weight_decay=cfg.weight_decay)
    return zero1(params, cls, **kw) if sharded else cls(list(params), **kw)


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
    step made. Under a mesh, `net` is the DDP-wrapped model that trains and
    `model` the module it wraps."""

    def __init__(self, model, cfg: TrainConfig):
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.rank, self.world = 0, 1
        self.net = model
        if cfg.mesh:
            mesh = make_mesh(cfg.mesh)
            if mesh.space != 1:
                raise ValueError(f"mesh {cfg.mesh!r}: the trainer shards the batch over "
                                 "'data' only; give data=N")
            self.rank, self.world = mesh.data_index, mesh.data
            if dist.is_initialized():
                self.net = self._wrap(model)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.schedule = unit_schedule(cfg)
        self.zero1 = bool(cfg.zero1) and self.world > 1
        self.optimizer = make_optimizer(self.params, cfg, sharded=self.zero1)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, self.schedule)
        self.step = 0
        self.nan_streak = 0
        # drop-path masks and augmentation draws
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.ckpt = CheckpointManager(cfg.run_dir, keep_best_k=cfg.keep_best_k)
        os.makedirs(cfg.run_dir, exist_ok=True)
        self._log_path = os.path.join(cfg.run_dir, "log.jsonl")
        self.writer = MetricsWriter(cfg.run_dir, tensorboard=False)   # JSONL only
        self.history: list[dict] = []

    def _wrap(self, model):
        """model under DistributedDataParallel on this rank's device; a model
        that returns a pyramid trained on its full-resolution output alone
        leaves its other heads without gradients, which DDP must be told."""
        from torch.nn.parallel import DistributedDataParallel

        unused = bool(getattr(model, "deep_supervision", False)) and not self.cfg.deep_supervision
        ids = [self.device.index] if self.device.type == "cuda" else None
        return DistributedDataParallel(model, device_ids=ids, find_unused_parameters=unused)

    def _log(self, record: dict):
        if not is_primary():
            return
        with open(self._log_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _rows(self, batch: int):
        """(first row, global batch) of this rank's `batch` rows; None in a
        single process."""
        return (self.rank * batch, batch * self.world) if self.world > 1 else None

    def _global(self, batch: int):
        """The context of a rank's forward and loss on `batch` rows: DropPath
        draws for the global batch and the losses reduce over it."""
        stack = contextlib.ExitStack()
        rows = self._rows(batch)
        if rows is not None:
            stack.enter_context(batch_rows(*rows))
            stack.enter_context(global_batch())
        return stack

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

    def _augment(self, images, labels, generator=None):
        generator = self.generator if generator is None else generator
        rows = self._rows(images.shape[0])
        if self.cfg.augment == "monai":
            from micformer_tpu_torch.data.transforms import batched_train_augment

            return batched_train_augment(generator, images, labels, self.cfg.num_modalities,
                                         rows=rows)
        if self.cfg.augment == "nnunet":
            from micformer_tpu_torch.data.transforms import batched_nnunet_train_augment

            return batched_nnunet_train_augment(generator, images, labels,
                                                self.cfg.num_modalities, rows=rows)
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
        """One step on a loader batch (this rank's rows of the global batch
        under a mesh). The gradients stay in the parameters' .grad until the
        next step. The step is the span `train.step`, its phases the spans
        `train.prep` (train mode, the batch to the device), `train.augment`,
        `train.zero_grad`, `train.forward`, `train.loss`, `train.backward`,
        `train.readback`, `train.optimizer`, `train.schedule`, `train.wait`
        and `train.release` (the step's autograd graph and batch freed)
        (`tracing.span`)."""
        with span("train.step"):
            cfg = self.cfg
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            with span("train.prep"):
                self.net.train()
                images, labels = self.prep_batch(images, labels)
            with span("train.augment"):
                images, labels = self._augment(images, labels)
            with span("train.zero_grad"):
                self.optimizer.zero_grad(set_to_none=True)
            with self._autocast(), self._global(images.shape[0]):
                with span("train.forward"):
                    out = self.net(images, generator=self.generator)
                with span("train.loss"):
                    loss = self.loss(out, labels)
            del out
            with span("train.backward"):
                loss.backward()
            with span("train.readback"):
                value = loss.item()
            skipped = cfg.nan_guard and not math.isfinite(value)
            if not skipped:
                with span("train.optimizer"):
                    if cfg.grad_clip_norm:
                        clip_by_global_norm(self.params, cfg.grad_clip_norm)
                    self.optimizer.step()
                with span("train.schedule"):
                    self.scheduler.step()
                self.step += 1
            if self.device.type == "cuda":
                with span("train.wait"):
                    torch.cuda.synchronize(self.device)
            rec = {"step": self.step, "loss": value, "skipped": skipped,
                   "seconds": time.perf_counter() - t0,
                   "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES}}
            with span("train.release"):
                del loss, images, labels
            self.history.append(rec)
            return rec

    def lr_now(self) -> float:
        return self.cfg.lr * float(self.schedule(self.step))

    def optimizer_state(self):
        """The optimizer's state_dict in the plain optimizer's format. Under
        ZeRO-1 every rank must call it: the state is consolidated on rank 0,
        which gets it (the others get None)."""
        if not self.zero1:
            return self.optimizer.state_dict()
        self.optimizer.consolidate_state_dict(to=0)
        if not is_primary():
            return None
        sd = self.optimizer.state_dict()
        # the local optimizer's group holds every hyperparameter of the plain
        # one; the wrapper's, the schedule's lr and initial_lr
        inner = {k: v for k, v in self.optimizer.optim.param_groups[0].items() if k != "params"}
        return {"state": sd["state"],
                "param_groups": [{**inner, **g} for g in sd["param_groups"]]}

    def _payload(self, epoch, best_dice, best_loss):
        return {"params": self.model.state_dict(), "opt_state": self.optimizer_state(),
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

    def load_pretrained(self, spec: str) -> dict:
        """Seed the model from `spec`, "run_dir" or "run_dir:tag" (default
        best_dice), a port run's `ckpt_<tag>.pt`; prints and logs the counts
        and returns the report."""
        from micformer_tpu_torch.convert.pretrained import load_pretrained_state

        src_dir, _, tag = str(spec).partition(":")
        src = CheckpointManager(src_dir).restore_params_only(tag or "best_dice")
        state, report = load_pretrained_state(self.model.state_dict(), src)
        self.model.load_state_dict(state)
        print(f"pretrained from {src_dir}: {len(report['loaded'])} tensors loaded, "
              f"{len(report['skipped'])} skipped, {len(report['missing'])} missing", flush=True)
        self._log({"pretrained": {k: len(v) for k, v in report.items()}})
        return report

    def find_lr(self, train_loader, num_iters: int = 100, init_lr: float = 1e-6,
                final_lr: float = 1.0):
        """The LR range test (nnU-Net's find_lr): `num_iters` SGD steps
        (momentum 0.9, no Nesterov) at lr init_lr·mult^it rising to final_lr,
        on a copy of the model with a fresh optimizer, so the trainer's own
        weights and state stay as they are; no NaN guard, no clipping, no
        schedule. Records the bias-corrected smoothed losses (beta 0.98),
        writes {"find_lr": {"lrs", "losses"}} to log.jsonl and returns
        (lrs, losses). Under a mesh each iteration is the trainer's global
        step."""
        mult = (final_lr / init_lr) ** (1 / max(num_iters - 1, 1))
        model = copy.deepcopy(self.model).train()
        params = [p for p in model.parameters() if p.requires_grad]
        net = self._wrap(model) if self.net is not self.model else model
        opt = torch.optim.SGD(params, lr=init_lr, momentum=0.9)
        generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        lrs, losses, avg, it = [], [], 0.0, 0
        while it < num_iters:
            for images, labels, _ in train_loader:
                if it >= num_iters:
                    break
                lr = init_lr * mult ** it
                for group in opt.param_groups:
                    group["lr"] = lr
                images, labels = self.prep_batch(images, labels)
                images, labels = self._augment(images, labels, generator)
                opt.zero_grad(set_to_none=True)
                with self._autocast(), self._global(images.shape[0]):
                    loss = self.loss(net(images, generator=generator), labels)
                loss.backward()
                opt.step()
                value = loss.item()
                avg = 0.98 * avg + 0.02 * value if it else value
                lrs.append(lr)
                losses.append(avg / (1 - 0.98 ** (it + 1)))
                it += 1
        self._log({"find_lr": {"lrs": lrs, "losses": losses}})
        return lrs, losses

    def fit(self, train_loader, val_loader=None, resume: bool = False, log_every: int = 10):
        cfg = self.cfg
        n_params = count_parameters(self.params)
        print(f"model parameters: {n_params:,}", flush=True)
        self._log({"n_parameters": n_params})
        if cfg.pretrained:
            self.load_pretrained(cfg.pretrained)

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
        """mdice_val_loss, meandice and per-class hard Dice over the
        validation batches, through the unwrapped model. Under a mesh the
        batches go round-robin by rank (as `shard_cases` deals them: rank r
        evaluates batches r, r + W, ...), each rank runs the serial loop's program on
        its own, and the metrics are gathered in batch order, so they equal
        the serial loop's; no rank runs a padding batch."""
        from micformer_tpu_torch.infer.sliding_window import sliding_window_inference

        cfg = self.cfg
        self.model.eval()
        mine = {}
        for i, (images, labels, _) in enumerate(val_loader):
            if i % self.world != self.rank:        # shard_cases(batches, rank, world)
                continue
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
            mine[i] = (m["val_loss"], m["meandice"], m["per_class_dice"])
        per_batch = mine
        if self.world > 1 and dist.is_initialized():
            parts = [None] * self.world
            dist.all_gather_object(parts, mine)
            per_batch = {i: v for part in parts for i, v in part.items()}
        order = sorted(per_batch)
        losses = [per_batch[i][0] for i in order]
        dices = [per_batch[i][1] for i in order]
        pc = (np.concatenate([per_batch[i][2] for i in order], axis=0) if order
              else np.zeros((0, cfg.num_classes)))
        return {"val_loss": float(np.mean(losses)) if losses else float("nan"),
                "meandice": float(np.mean(dices)) if dices else float("nan"),
                "per_class_dice_mean": pc.mean(0).tolist() if len(pc) else [],
                "per_class_dice": pc}
