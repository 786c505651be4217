"""Training CLI.

    python -m micformer_tpu_torch.cli.train --data <root> --model micformer \
        --target-shape 128 --bf16 [--fused-attention] [--device cpu]
    python -m micformer_tpu_torch.cli.train --data <root> \
        --cfg configs/mednext_s_mmwhs.yaml --target-shape 128 --bf16
    python -m micformer_tpu_torch.cli.train --data <root> --model mednext \
        --model-kwargs '{"deep_supervision": true}' --deep-supervision \
        --loss dice_ce --augment nnunet --optimizer sgd_nesterov --grad-clip 12

Counterpart of `micformer_tpu/cli/train.py` for the MicFormer and MedNeXt
training slices (the last line above is MedNeXt's nnU-Net preset): the
5-fold MM-WHS split under --data (preprocessed to --target-shape and cached
under --cache), batches from the thread-worker loader, the
`Trainer` with latest / best checkpoints in --run-dir, and `--resume`.
Runs on the card unless --device cpu is given, and raises when CUDA is
asked for and missing. `--throughput` times training steps instead (two
warm-up epochs, then three timed ones) and saves nothing. Prints the
parameter count, every step's loss, and `training done`; returns the
Trainer, whose `history` holds each step's loss, time and kernel launches.
"""

from __future__ import annotations

import os
import time

import torch


def main(argv=None):
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.config import build_argparser, config_from_args, save_config
    from micformer_tpu_torch.data.loader import DataLoader
    from micformer_tpu_torch.data.mmwhs import get_datasets
    from micformer_tpu_torch.train.trainer import TrainConfig, Trainer

    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.data.data_root:
        raise SystemExit("--data is required")
    device = registry.resolve_device(args.device)

    os.makedirs(cfg.train.run_dir, exist_ok=True)
    save_config(cfg, os.path.join(cfg.train.run_dir, "config.json"))
    train_ds, val_ds, _ = get_datasets(
        cfg.data.data_root, seed=cfg.train.seed, fold=cfg.data.fold,
        cache_dir=cfg.data.cache_dir or None, target_shape=tuple(cfg.data.target_shape),
        normalisation=cfg.data.normalisation)
    train_loader = DataLoader(train_ds, batch_size=cfg.train.batch_size, shuffle=True,
                              seed=cfg.train.seed, workers=cfg.data.workers)
    val_loader = DataLoader(val_ds, batch_size=1, workers=cfg.data.workers)

    kwargs = dict(cfg.model.extra, num_classes=cfg.model.num_classes)
    if cfg.model.name == "micformer":
        kwargs.setdefault("embed_dim", cfg.model.embed_dim)
        kwargs["fused_attention"] = cfg.model.fused_attention
    elif cfg.model.fused_attention:
        raise SystemExit("--fused-attention applies to --model micformer only")
    model = registry.build(cfg.model.name, device=device,
                           generator=torch.Generator().manual_seed(cfg.train.seed), **kwargs)
    tcfg = TrainConfig(
        epochs=cfg.train.epochs, lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
        num_classes=cfg.model.num_classes, val_every=cfg.train.val_every,
        seed=cfg.train.seed, scheduler=cfg.train.scheduler,
        scheduler_per_batch=cfg.train.scheduler_per_batch,
        steps_per_epoch=len(train_loader), optimizer=cfg.train.optimizer,
        loss=cfg.train.extra_loss, deep_supervision=bool(cfg.train.deep_supervision),
        grad_clip_norm=cfg.train.grad_clip_norm, patience=cfg.train.patience,
        run_dir=cfg.train.run_dir, augment=cfg.train.augment,
        roi=tuple(cfg.infer.roi), sw_overlap=cfg.infer.overlap,
        sw_batch_size=cfg.infer.sw_batch_size, bf16=bool(cfg.train.bf16))
    trainer = Trainer(model, tcfg)
    print(f"train: {cfg.model.name} on {device}, {len(train_ds)} training and "
          f"{len(val_ds)} validation cases at {tuple(cfg.data.target_shape)}, batch "
          f"{cfg.train.batch_size}, {'bf16' if tcfg.bf16 else 'f32'}, {tcfg.loss} loss"
          f"{' on the deep-supervision pyramid' if tcfg.deep_supervision else ''}, "
          f"{tcfg.augment} augmentation, {tcfg.optimizer}, fused attention "
          f"{cfg.model.fused_attention}", flush=True)

    if args.throughput:
        _throughput(trainer, train_loader)
        return trainer
    t0 = time.perf_counter()
    trainer.fit(train_loader, val_loader, resume=bool(cfg.train.resume), log_every=1)
    print(f"training done in {time.perf_counter() - t0:.1f}s "
          f"({cfg.train.epochs} epochs, step {trainer.step})", flush=True)
    return trainer


def _throughput(trainer, loader, warmup=2, epochs=3):
    """Volumes per second over `epochs` epochs after `warmup` epochs."""
    n, t0 = 0, None
    for e in range(warmup + epochs):
        if e == warmup:
            t0, n = time.perf_counter(), 0
        for images, labels, _ in loader:
            trainer.train_step(images, labels)
            n += images.shape[0]
    dt = time.perf_counter() - t0
    print(f"throughput: {n / dt:.3f} volumes/s ({dt / max(n, 1) * 1000:.1f} ms/volume)",
          flush=True)


if __name__ == "__main__":
    main()
