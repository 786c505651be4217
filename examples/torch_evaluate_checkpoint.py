"""Scripted test.ipynb equivalent on the PyTorch port (the reference's
MicFormer/test.ipynb, SURVEY §2.10): rebuild the validation split, restore a
port run's checkpoint, run direct (non-tiled) inference, report mean Dice,
per-class HD95 and mIoU, and optionally dump NIfTI volumes.

The counterpart of examples/evaluate_checkpoint.py, which drives the JAX
package. The model is rebuilt from the run's config.json, as cli/predict
and cli/serve rebuild it, unless --model names another family.

Usage:
  python examples/torch_evaluate_checkpoint.py --data <root> --run-dir runs/f0 \
      [--model micformer] [--dump ./output] [--target-shape 128] [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Prints each case's metrics and their means; returns {"cases": {pid:
    {"meandice", "miou", "hd95"}}, "meandice", "miou"} (the means over the
    cases, absent without any)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from micformer_tpu_torch.cli.serve import build_model
    from micformer_tpu_torch.data.mmwhs import get_datasets
    from micformer_tpu_torch.data.nifti import write_nifti
    from micformer_tpu_torch.losses.metrics import hd95_multiclass, mean_iou, meandice
    from micformer_tpu_torch.registry import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--cache", default=None)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--model", default=None, help="default: the run's, from its config.json")
    p.add_argument("--ckpt-tag", default="best_loss",
                   help="the notebook loads model_lower_loss.pth.tar")
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--target-shape", type=int, default=128)
    p.add_argument("--dump", default=None, help="dir for ct/mr/pred/gt NIfTIs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    ts = (args.target_shape,) * 3
    _, val_ds, _ = get_datasets(args.data, cache_dir=args.cache, target_shape=ts)
    _, model = build_model(run_dir=args.run_dir, model=args.model, num_classes=args.num_classes,
                           ckpt_tag=args.ckpt_tag, device=device)

    cases = {}
    for i in range(len(val_ds)):
        s = val_ds[i]
        x = torch.tensor(np.asarray(s["image"], np.float32))[None].to(device)
        with torch.no_grad():
            logits = model(x)
        pred = torch.softmax(logits, dim=1).argmax(dim=1).cpu()
        gt_onehot = torch.tensor(np.asarray(s["label"], np.float32))[None]
        gt = gt_onehot.argmax(dim=1)
        d = float(meandice(pred, gt, args.num_classes))
        pred_oh = F.one_hot(pred, args.num_classes).permute(0, 4, 1, 2, 3)
        iou = float(mean_iou(pred_oh, gt_onehot))
        hd = hd95_multiclass(pred[0].numpy(), gt[0].numpy(), args.num_classes)
        pid = s["patient_id"]
        cases[pid] = {"meandice": d, "miou": iou, "hd95": hd}
        print(f"{pid}: meandice={d:.4f} mIoU={iou:.4f} "
              f"HD95={['%.1f' % h if np.isfinite(h) else 'nan' for h in hd]}")
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            img = np.asarray(s["image"])
            write_nifti(os.path.join(args.dump, f"{pid}_ct.nii.gz"), img[0])
            if img.shape[0] > 1:
                write_nifti(os.path.join(args.dump, f"{pid}_mr.nii.gz"), img[1])
            write_nifti(os.path.join(args.dump, f"{pid}_pred.nii.gz"),
                        pred[0].numpy().astype(np.uint8))
            write_nifti(os.path.join(args.dump, f"{pid}_gt.nii.gz"),
                        gt[0].numpy().astype(np.uint8))
    result = {"cases": cases}
    if cases:
        result["meandice"] = float(np.mean([c["meandice"] for c in cases.values()]))
        result["miou"] = float(np.mean([c["miou"] for c in cases.values()]))
        print(f"mean over {len(cases)} cases: meandice={result['meandice']:.4f} "
              f"mIoU={result['miou']:.4f}")
    return result


if __name__ == "__main__":
    main()
