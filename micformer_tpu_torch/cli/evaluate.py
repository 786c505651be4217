"""Evaluation CLI: Dice, HD95 and the rest of the evaluator's metrics over
predicted against ground-truth label maps.

Counterpart of `micformer_tpu/cli/evaluate.py`: for each `<pid>_pred.nii.gz`
in --pred, the first file of --gt whose name starts with `<pid>` is its
ground truth; per-class metrics (`pipeline/evaluator.py`) are aggregated
into nnU-Net's JSON layout (--json). --regions adds the per-structure and
whole-heart region Dice and normalized surface Dice, written as
summary_dc.csv and summary_surface_dc.csv into --pred and under "regions" in
the JSON. Host code: numpy and scipy, no device.

    python -m micformer_tpu_torch.cli.evaluate --pred preds --gt gts \
        --json preds/summary.json --regions
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def main(argv=None):
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.pipeline.evaluator import (
        aggregate_scores, evaluate_case, evaluate_regions, get_mmwhs_regions,
    )

    p = argparse.ArgumentParser("micformer_tpu_torch.evaluate")
    p.add_argument("--pred", required=True, help="dir of *_pred.nii.gz")
    p.add_argument("--gt", required=True, help="dir of matching *_gt.nii.gz (or label maps)")
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--json", default=None)
    p.add_argument("--regions", action="store_true",
                   help="also run region-based evaluation (per-structure and "
                        "whole-heart Dice and normalized surface Dice), writing "
                        "summary_dc.csv and summary_surface_dc.csv into --pred")
    p.add_argument("--nsd-tolerance", type=float, default=1.0,
                   help="normalized-surface-Dice tolerance in mm")
    args = p.parse_args(argv)

    labels = list(range(1, args.num_classes))
    results = []
    region_pairs = []
    for pp in sorted(glob.glob(os.path.join(args.pred, "*_pred.nii.gz"))):
        pid = os.path.basename(pp).replace("_pred.nii.gz", "")
        gts = glob.glob(os.path.join(args.gt, f"{pid}*"))
        if not gts:
            print(f"warning: no GT for {pid}, skipping")
            continue
        pred = np.asarray(read_nifti(pp)).astype(np.int32)
        gt = np.asarray(read_nifti(gts[0])).astype(np.int32)
        results.append(evaluate_case(pred, gt, labels, nsd_tolerance_mm=args.nsd_tolerance))
        if args.regions:
            region_pairs.append((pid, pred, gt))
        dice = np.mean([results[-1][str(l)]["Dice"] for l in labels])
        print(f"{pid}: mean foreground Dice {dice:.4f}")

    agg = aggregate_scores(results, json_output_file=args.json, json_task="MM-WHS")
    if args.regions and region_pairs:
        region_summary = evaluate_regions(region_pairs, get_mmwhs_regions(),
                                          out_dir=args.pred,
                                          nsd_tolerance_mm=args.nsd_tolerance)
        agg["regions"] = region_summary
        if args.json:
            with open(args.json) as f:
                payload = json.load(f)
            payload["regions"] = region_summary
            with open(args.json, "w") as f:
                json.dump(payload, f, indent=2, default=str)
        wh = region_summary["dc"]["whole heart"]["mean"]
        print(f"whole-heart region Dice: {wh:.4f}")
    if results:
        md = np.mean([agg["mean"][str(l)]["Dice"] for l in labels])
        print(f"overall mean foreground Dice: {md:.4f}")
    return agg


if __name__ == "__main__":
    main()
