"""Export CLI: a trained run's inference pipeline as a serving artifact.

Counterpart of `micformer_tpu/cli/export.py`.

    python -m micformer_tpu_torch.cli.export --run-dir runs/micformer_f0 --out art/ \
        --bf16 --target-shape 160 --roi 128

writes `module.<platform>.pt2` (the `torch.export` program of the whole
sliding-window pipeline, weights held as constants, K1, K2 and K3 as
custom-op nodes) and `meta.json`, which `cli.serve --exported art/` runs
without the model zoo or the checkpoint. The model is rebuilt from the run
by serve's rule (`cli.serve.build_model`). The artifact holds a program for
each of `--platforms` (cuda, cpu; default: --device, itself cuda by
default), and serve runs the one of its --device; a platform this host
cannot run (cuda without a card) raises before anything is written. See
`convert/aot_export.py` for the format.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    import torch

    from micformer_tpu_torch.cli.serve import build_model
    from micformer_tpu_torch.convert.aot_export import PLATFORMS, check_platforms, export_artifact

    p = argparse.ArgumentParser("micformer_tpu_torch.export")
    p.add_argument("--run-dir", required=True,
                   help="training run dir (config.json and checkpoints)")
    p.add_argument("--out", default=None,
                   help="artifact dir (default <run-dir>/exported)")
    p.add_argument("--ckpt-tag", default="best_dice",
                   choices=["best_dice", "best_loss", "latest"])
    p.add_argument("--model", default=None,
                   help="model family override (default: the run's)")
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--target-shape", type=int, default=128)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--roi", type=int, default=128)
    p.add_argument("--overlap", type=float, default=0.5)
    p.add_argument("--sw-batch-size", type=int, default=4)
    p.add_argument("--step-mode", default="monai", choices=["monai", "nnunet"])
    p.add_argument("--mirror-tta", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--logits", action="store_true",
                   help="export float logits instead of uint8 argmax")
    p.add_argument("--fused-attention", action="store_true",
                   help="MicFormer: attention through the fused kernel K2 (the JAX "
                        "package's MICFORMER_FUSED_ATTENTION=1)")
    p.add_argument("--device", default="cuda",
                   help="the device the model is built on and, without --platforms, the "
                        "artifact runs on: cuda (default) or cpu")
    p.add_argument("--platforms", nargs="+", default=None, choices=PLATFORMS,
                   help="the devices the artifact holds a program for, e.g. cuda cpu "
                        "(default: --device)")
    args = p.parse_args(argv)

    here = torch.device(args.device).type
    platforms = check_platforms(args.platforms or [here])
    model_name, model = build_model(
        run_dir=args.run_dir, model=args.model, num_classes=args.num_classes,
        ckpt_tag=args.ckpt_tag, fused_attention=args.fused_attention, bf16=args.bf16,
        device=args.device if here in platforms else platforms[0])
    out_dir = args.out or os.path.join(args.run_dir, "exported")
    t0 = time.perf_counter()
    meta = export_artifact(
        out_dir, model, target_shape=(args.target_shape,) * 3, roi=(args.roi,) * 3,
        num_classes=args.num_classes, overlap=args.overlap,
        sw_batch_size=args.sw_batch_size, step_mode=args.step_mode,
        mirror_tta=args.mirror_tta, argmax=not args.logits, batch=args.batch,
        platforms=platforms, model_name=model_name)
    seconds = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(out_dir, f)) for f in meta["programs"].values())
    print(f"exported {model_name} -> {out_dir} ({size / 1e6:.1f} MB in {seconds:.2f} s, "
          f"platforms {meta['platforms']}, input {meta['input_shape']}, "
          f"output {meta['output']})")
    return meta


if __name__ == "__main__":
    main()
