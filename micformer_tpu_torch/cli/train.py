"""Training CLI.

    python -m micformer_tpu_torch.cli.train --data <root> --model micformer \
        --target-shape 128 --bf16 [--fused-attention] [--device cpu]
    python -m micformer_tpu_torch.cli.train --data <root> \
        --cfg configs/mednext_s_mmwhs.yaml --target-shape 128 --bf16
    python -m micformer_tpu_torch.cli.train --data <root> --model mednext \
        --model-kwargs '{"deep_supervision": true}' --deep-supervision \
        --loss dice_ce --augment nnunet --optimizer sgd_nesterov --grad-clip 12
    python -m micformer_tpu_torch.cli.train --data <root> --model mednext \
        --cascade-prev-seg-dir <low-stage dir> [--single-modal] [--oversample-fg 0.33] \
        [--pretrained <run>[:tag]] [--loss gdl|topk|focal|mcc|dice_topk|dice_bce] \
        [--worker-mode process] [--find-lr]
    torchrun --nproc-per-node 2 -m micformer_tpu_torch.cli.train --data <root> \
        --mesh data=2 --batch-size 2 [--zero1] [--device cpu]

Counterpart of `micformer_tpu/cli/train.py` (the third line above is
MedNeXt's nnU-Net preset): the 5-fold MM-WHS split under --data
(preprocessed to --target-shape and cached under --cache; the CT channel
alone with --single-modal), wrapped as JAX wraps it: first the cascade's
previous-stage channels (`--cascade-prev-seg-dir`), then nnU-Net's
foreground-oversampled patches (`--oversample-fg`); batches from thread or
spawned process workers; the `Trainer` with latest / best checkpoints in
--run-dir, `--pretrained` seeding and `--resume`. Every model but MicFormer
(MedNeXt, GenericUNet, UNet3D, nnFormer, SwinUnet3D) takes the input's
channels (1 or 2 modalities, plus num_classes - 1 under the cascade) unless
--model-kwargs sets `in_channels`; the count is recorded in config.json's
`model.extra`, so `config.run_model` rebuilds the model for cli/predict.
A model registered with an `input_size` (nnFormer: it fixes the shapes of
its bias tables) is built for the patch (--target-shape), recorded likewise.
MicFormer reads CT and MR (channels
0 and 1), so it refuses --single-modal.

Data parallelism: `--mesh data=N` trains on N ranks of a process group
(`parallel/distributed.py`: torchrun's variables, or the JAX package's
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID), each on its rows of the
global batch --batch-size, which N must divide; N must equal the world
size. `--zero1` splits the optimizer state over the ranks (a no-op without
a mesh of data >= 2, as in JAX). config.json records the mesh; the primary
rank writes it, the checkpoints and the logs, and a run resumes at any
world size, with or without --zero1.

Runs on the card unless --device cpu is given, and raises when CUDA is
asked for and missing. `--throughput` times training steps instead (two
warm-up epochs, then three timed ones) and saves nothing; `--find-lr` runs
the LR range test instead and prints where the smoothed loss is least.
Prints the parameter count, every step's loss, and `training done`; returns
the Trainer, whose `history` holds each step's loss, time and kernel
launches.
"""

from __future__ import annotations

import os
import time

import torch


def main(argv=None):
    from micformer_tpu_torch import native
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.config import build_argparser, config_from_args
    from micformer_tpu_torch.parallel import distributed
    from micformer_tpu_torch.parallel.mesh import parse_mesh

    args = build_argparser().parse_args(argv)
    native.available()      # the volume reader: built now, not in a data worker
    cfg = config_from_args(args)
    if cfg.train.mesh:
        data = parse_mesh(cfg.train.mesh).get("data")
        if data and cfg.train.batch_size % data:
            raise SystemExit(f"--batch-size {cfg.train.batch_size} not divisible by mesh "
                             f"data={data}")
    if not cfg.data.data_root:
        raise SystemExit("--data is required")
    # a group that main joins (torchrun's ranks) it leaves when it ends
    with distributed.joined(registry.resolve_device(args.device)) as device:
        return _train(args, cfg, device)


def _train(args, cfg, device):
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.config import save_config
    from micformer_tpu_torch.data.loader import DataLoader
    from micformer_tpu_torch.data.mmwhs import get_datasets
    from micformer_tpu_torch.parallel.mesh import is_primary, make_mesh
    from micformer_tpu_torch.train.trainer import TrainConfig, Trainer

    rank, world = 0, 1
    if cfg.train.mesh:
        try:
            mesh = make_mesh(cfg.train.mesh)
        except ValueError as e:
            raise SystemExit(f"--mesh {cfg.train.mesh}: {e}") from None
        rank, world = mesh.data_index, mesh.data
    cascade = cfg.train.cascade_prev_seg_dir
    n_mod = 1 if cfg.data.single_modal else 2

    kwargs = dict(cfg.model.extra, num_classes=cfg.model.num_classes)
    if cfg.model.name == "micformer":
        if cfg.data.single_modal:
            raise SystemExit("--single-modal: MicFormer reads CT and MR (input channels 0 "
                             "and 1); train a one-channel model such as --model mednext")
        kwargs.setdefault("embed_dim", cfg.model.embed_dim)
        kwargs["fused_attention"] = cfg.model.fused_attention
    elif cfg.model.fused_attention:
        raise SystemExit("--fused-attention applies to --model micformer only")
    cfg.model.in_channels = n_mod + (cfg.model.num_classes - 1 if cascade else 0)
    if cfg.model.name != "micformer":
        kwargs.setdefault("in_channels", cfg.model.in_channels)
        cfg.model.in_channels = kwargs["in_channels"]
        cfg.model.extra = {**cfg.model.extra, "in_channels": kwargs["in_channels"]}
    if "input_size" in registry.defaults(cfg.model.name):
        # the model's parameter shapes follow the input it is built for
        kwargs.setdefault("input_size", list(cfg.data.target_shape))
        cfg.model.extra = {**cfg.model.extra, "input_size": kwargs["input_size"]}

    os.makedirs(cfg.train.run_dir, exist_ok=True)
    if is_primary():
        save_config(cfg, os.path.join(cfg.train.run_dir, "config.json"))
    train_ds, val_ds, _ = get_datasets(
        cfg.data.data_root, seed=cfg.train.seed, fold=cfg.data.fold,
        cache_dir=cfg.data.cache_dir or None, target_shape=tuple(cfg.data.target_shape),
        normalisation=cfg.data.normalisation, single_modal=bool(cfg.data.single_modal))
    if cascade:
        from micformer_tpu_torch.data.cascade import CascadeDataset

        train_ds = CascadeDataset(train_ds, cascade, cfg.model.num_classes, augment=True,
                                  seed=cfg.train.seed)
        val_ds = CascadeDataset(val_ds, cascade, cfg.model.num_classes, augment=False)
    if cfg.train.oversample_fg:
        from micformer_tpu_torch.data.patch_sampler import OversampledPatchDataset

        train_ds = OversampledPatchDataset(
            train_ds, patch_size=tuple(cfg.data.target_shape),
            batch_size=cfg.train.batch_size,
            oversample_foreground_percent=float(cfg.train.oversample_fg),
            num_classes=cfg.model.num_classes, seed=cfg.train.seed)
    train_loader = DataLoader(train_ds, batch_size=cfg.train.batch_size, shuffle=True,
                              seed=cfg.train.seed, workers=cfg.data.workers,
                              worker_mode=cfg.data.worker_mode, rank=rank, world=world)
    val_loader = DataLoader(val_ds, batch_size=1, workers=cfg.data.workers,
                            worker_mode=cfg.data.worker_mode)
    try:
        model = registry.build(cfg.model.name, device=device,
                               generator=torch.Generator().manual_seed(cfg.train.seed),
                               **kwargs)
        tcfg = TrainConfig(
            epochs=cfg.train.epochs, lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
            num_classes=cfg.model.num_classes, val_every=cfg.train.val_every,
            seed=cfg.train.seed, scheduler=cfg.train.scheduler,
            scheduler_per_batch=cfg.train.scheduler_per_batch,
            steps_per_epoch=len(train_loader), optimizer=cfg.train.optimizer,
            loss=cfg.train.extra_loss, deep_supervision=bool(cfg.train.deep_supervision),
            grad_clip_norm=cfg.train.grad_clip_norm, patience=cfg.train.patience,
            run_dir=cfg.train.run_dir, augment=cfg.train.augment,
            num_modalities=n_mod if cascade else None, pretrained=cfg.train.pretrained,
            roi=tuple(cfg.infer.roi), sw_overlap=cfg.infer.overlap,
            sw_batch_size=cfg.infer.sw_batch_size, bf16=bool(cfg.train.bf16),
            mesh=cfg.train.mesh, zero1=bool(cfg.train.zero1))
        trainer = Trainer(model, tcfg)
        print(f"train: {cfg.model.name} on {device} (rank {rank} of data={world}"
              f"{', ZeRO-1' if trainer.zero1 else ''}), {len(train_ds)} training and "
              f"{len(val_ds)} validation samples at {tuple(cfg.data.target_shape)}, "
              f"{cfg.model.in_channels} input channels, batch {cfg.train.batch_size}, "
              f"{'bf16' if tcfg.bf16 else 'f32'}, {tcfg.loss} loss"
              f"{' on the deep-supervision pyramid' if tcfg.deep_supervision else ''}, "
              f"{tcfg.augment} augmentation, {tcfg.optimizer}, fused attention "
              f"{cfg.model.fused_attention}, {cfg.data.worker_mode} workers", flush=True)

        if args.throughput:
            _throughput(trainer, train_loader)
            return trainer
        if args.find_lr:
            lrs, losses = trainer.find_lr(train_loader)
            best = lrs[min(range(len(losses)), key=lambda i: losses[i])]
            print(f"find_lr: {len(lrs)} points swept; min smoothed loss at lr={best:.2e} "
                  f"(full curve in {cfg.train.run_dir}/log.jsonl)", flush=True)
            return trainer
        t0 = time.perf_counter()
        trainer.fit(train_loader, val_loader, resume=bool(cfg.train.resume), log_every=1)
        print(f"training done in {time.perf_counter() - t0:.1f}s "
              f"({cfg.train.epochs} epochs, step {trainer.step})", flush=True)
        return trainer
    finally:
        train_loader.close()
        val_loader.close()


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
