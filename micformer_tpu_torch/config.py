"""Config: one dataclass tree, YAML loading and command-line overrides.

Counterpart of `micformer_tpu/config.py`: every flag of the JAX training
CLI, plus `--fused-attention` (the JAX package's
MICFORMER_FUSED_ATTENTION=1), `--device` and `--model-kwargs`. `--mesh` and
`--zero1` (data parallelism) parse but are not ported yet: the trainer
raises on them. Every flag defaults to None, so only a flag that is given
overrides the YAML preset.
YAML needs PyYAML, imported only when a --cfg file is given; the resolved
config is saved as JSON, and `run_model` rebuilds a run's model from it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    name: str = "micformer"
    num_classes: int = 8
    in_channels: int = 2          # 1 single-modal; + num_classes - 1 under the cascade
    embed_dim: int = 48
    extra: dict = field(default_factory=dict)
    fused_attention: bool = False


@dataclass
class DataConfig:
    data_root: str = ""
    cache_dir: str = ""
    target_shape: tuple = (128, 128, 128)
    fold: int = 0
    normalisation: str = "minmax"
    workers: int = 2
    worker_mode: str = "thread"         # thread | process (spawned)
    single_modal: bool = False          # the CT channel alone


@dataclass
class TrainerConfig:
    epochs: int = 300
    batch_size: int = 1
    lr: float = 1e-4
    weight_decay: float = 0.0
    val_every: int = 10
    seed: int = 1234
    resume: bool = False
    optimizer: str = "adam"
    scheduler: str = "cosine"
    scheduler_per_batch: bool = True
    grad_clip_norm: float | None = None
    run_dir: str = "runs/run"
    bf16: bool = False
    patience: int | None = None
    augment: str = "monai"
    extra_loss: str = "mdice"           # the train loss, as the JAX config names it
    deep_supervision: bool = False
    # data parallelism, not ported yet: the trainer raises on either
    mesh: str | None = None
    zero1: bool = False
    # nnU-Net's foreground-oversampled patches: the forced fraction of a batch
    oversample_fg: float | None = None
    # the cascade's full-resolution stage: <pid>_segFromPrevStage.npy files
    cascade_prev_seg_dir: str | None = None
    # "run_dir" or "run_dir:tag": seed the weights from another port run
    pretrained: str | None = None


@dataclass
class InferenceConfig:
    roi: tuple = (128, 128, 128)
    overlap: float = 0.5
    sw_batch_size: int = 1
    blend: str = "gaussian"
    step_mode: str = "monai"
    mirror_tta: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainerConfig = field(default_factory=TrainerConfig)
    infer: InferenceConfig = field(default_factory=InferenceConfig)


def _apply_dict(cfg, d: dict):
    for k, v in d.items():
        if not hasattr(cfg, k):
            raise KeyError(f"unknown config key: {k}")
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply_dict(cur, v)
        else:
            if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                v = tuple(v)
            setattr(cfg, k, v)


def load_config(path: str | None = None, overrides: dict | None = None) -> Config:
    cfg = Config()
    if path:
        import yaml

        with open(path) as f:
            _apply_dict(cfg, yaml.safe_load(f) or {})
    if overrides:
        _apply_dict(cfg, overrides)
    return cfg


def save_config(cfg: Config, path: str):
    """The resolved config as JSON."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


def run_model(run_dir: str, model: str | None = None, num_classes: int = 8):
    """(model name, registry kwargs) of a training run: the model recorded in
    `<run_dir>/config.json` unless `model` names another family, with the
    run's num_classes, `extra` (JSON lists back to tuples) and, for
    MicFormer, its embed_dim and fused_attention. Without a config, or for
    another family, only `num_classes` is set; the family defaults to
    micformer."""
    kwargs = {"num_classes": num_classes}
    path = os.path.join(run_dir, "config.json")
    if os.path.exists(path):
        with open(path) as f:
            run = load_config(overrides=json.load(f)).model
        model = model or run.name
        if model == run.name:
            kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in run.extra.items()}
            kwargs["num_classes"] = run.num_classes
            if model == "micformer":
                kwargs.setdefault("embed_dim", run.embed_dim)
                kwargs["fused_attention"] = run.fused_attention
    return model or "micformer", kwargs


def build_argparser(defaults: Config | None = None) -> argparse.ArgumentParser:
    d = defaults or Config()
    p = argparse.ArgumentParser("micformer_tpu_torch.train")
    p.add_argument("--data", default=None, help="MM-WHS root (ct_*_image.nii.gz, ...)")
    p.add_argument("--cache", default=None, help="preprocessed-volume cache directory")
    p.add_argument("--model", default=None, help=f"model family (default {d.model.name})")
    p.add_argument("--model-kwargs", default=None,
                   help="JSON object of model constructor arguments (over model.extra)")
    p.add_argument("--fused-attention", action="store_true", default=None,
                   help="run attention through the fused kernel K2 (the JAX "
                        "package's MICFORMER_FUSED_ATTENTION=1)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--epochs", type=int, default=None, help=f"default {d.train.epochs}")
    p.add_argument("--batch-size", type=int, default=None,
                   help=f"default {d.train.batch_size}")
    p.add_argument("--lr", type=float, default=None, help=f"default {d.train.lr}")
    p.add_argument("--wd", type=float, default=None,
                   help=f"weight decay (default {d.train.weight_decay})")
    p.add_argument("--val", type=int, default=None,
                   help=f"validate every N epochs (default {d.train.val_every})")
    p.add_argument("--fold", type=int, default=None, help=f"default {d.data.fold}")
    p.add_argument("--num_classes", type=int, default=None,
                   help=f"default {d.model.num_classes}")
    p.add_argument("--seed", type=int, default=None, help=f"default {d.train.seed}")
    p.add_argument("--cfg", default=None, help="yaml config file")
    p.add_argument("--resume", action="store_true", default=None)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--worker-mode", default=None, choices=["thread", "process"],
                   help="fetch samples in threads (default) or in spawned processes")
    p.add_argument("--run-dir", default=None, help=f"default {d.train.run_dir}")
    p.add_argument("--target-shape", type=int, default=None,
                   help="cubic target shape (and validation roi), e.g. 32 for smoke runs")
    p.add_argument("--bf16", action="store_true", default=None)
    p.add_argument("--optimizer", default=None, choices=["adam", "adamw", "sgd_nesterov"])
    p.add_argument("--scheduler", default=None, choices=["cosine", "poly", "constant"])
    p.add_argument("--scheduler-per-batch", default=None, choices=["true", "false"],
                   help="step the schedule per batch (the reference's quirk, the "
                        "default) or per epoch")
    p.add_argument("--augment", default=None, choices=["monai", "nnunet", "none"],
                   help="train-time transform stack (default monai; nnunet is "
                        "MedNeXt's native moreDA-style stack)")
    p.add_argument("--loss", default=None,
                   choices=["mdice", "dice_ce", "gdl", "topk", "focal", "mcc", "dice_topk",
                            "dice_bce"],
                   help="train loss (default mdice; dice_ce is nnU-Net's softmax "
                        "Dice + cross-entropy, the rest its loss zoo)")
    p.add_argument("--deep-supervision", action="store_true", default=None,
                   help="train on the model's output pyramid (the model must "
                        "return one: --model-kwargs '{\"deep_supervision\": true}')")
    p.add_argument("--patience", type=int, default=None,
                   help="stop after N validations without improvement")
    p.add_argument("--grad-clip", type=float, default=None)
    p.add_argument("--single-modal", action="store_true", default=None,
                   help="train on the CT channel alone (the single-modal ablation)")
    p.add_argument("--mesh", default=None,
                   help="device mesh, e.g. 'data=4': not ported yet, raises")
    p.add_argument("--zero1", action="store_true", default=None,
                   help="ZeRO-1 optimizer-state sharding: not ported yet, raises")
    p.add_argument("--oversample-fg", type=float, default=None,
                   help="nnU-Net patch training: the fraction of a batch's patches "
                        "forced to hold foreground (nnU-Net's default 0.33)")
    p.add_argument("--pretrained", default=None,
                   help="run dir (or run_dir:tag, default tag best_dice) of a port run "
                        "whose checkpoint seeds the model: tensors of matching name and "
                        "shape transfer, the segmentation heads do not")
    p.add_argument("--cascade-prev-seg-dir", default=None,
                   help="the cascade's full-resolution stage: directory of the low "
                        "stage's <pid>_segFromPrevStage.npy, appended as one-hot input "
                        "channels (pyramid-augmented in training)")
    p.add_argument("--find-lr", action="store_true", default=None,
                   help="run the LR range test instead of training: an exponential "
                        "sweep whose smoothed losses go to log.jsonl")
    p.add_argument("--throughput", action="store_true", default=None,
                   help="time training steps (volumes/s) instead of training")
    return p


# (args attribute) -> (config section, field), applied when the flag is given
_ARG_MAP = {
    "data": ("data", "data_root"),
    "cache": ("data", "cache_dir"),
    "fold": ("data", "fold"),
    "workers": ("data", "workers"),
    "worker_mode": ("data", "worker_mode"),
    "single_modal": ("data", "single_modal"),
    "model": ("model", "name"),
    "num_classes": ("model", "num_classes"),
    "fused_attention": ("model", "fused_attention"),
    "epochs": ("train", "epochs"),
    "batch_size": ("train", "batch_size"),
    "lr": ("train", "lr"),
    "wd": ("train", "weight_decay"),
    "val": ("train", "val_every"),
    "seed": ("train", "seed"),
    "resume": ("train", "resume"),
    "run_dir": ("train", "run_dir"),
    "bf16": ("train", "bf16"),
    "optimizer": ("train", "optimizer"),
    "scheduler": ("train", "scheduler"),
    "augment": ("train", "augment"),
    "loss": ("train", "extra_loss"),
    "deep_supervision": ("train", "deep_supervision"),
    "grad_clip": ("train", "grad_clip_norm"),
    "patience": ("train", "patience"),
    "mesh": ("train", "mesh"),
    "zero1": ("train", "zero1"),
    "oversample_fg": ("train", "oversample_fg"),
    "cascade_prev_seg_dir": ("train", "cascade_prev_seg_dir"),
    "pretrained": ("train", "pretrained"),
}


def config_from_args(args) -> Config:
    cfg = load_config(args.cfg)
    for attr, (section, field_name) in _ARG_MAP.items():
        v = getattr(args, attr, None)
        if v is not None:
            setattr(getattr(cfg, section), field_name, v)
    if getattr(args, "model_kwargs", None):
        cfg.model.extra = {**cfg.model.extra, **json.loads(args.model_kwargs)}
    spb = getattr(args, "scheduler_per_batch", None)
    if spb is not None:
        cfg.train.scheduler_per_batch = spb == "true"
    if getattr(args, "target_shape", None):
        cfg.data.target_shape = (args.target_shape,) * 3
        cfg.infer.roi = cfg.data.target_shape
    return cfg
