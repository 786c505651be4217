"""Cross-model ensembling CLI: average saved softmax probabilities.

Counterpart of `micformer_tpu/cli/ensemble.py` (nnU-Net's
`ensemble_predictions.py` merge): for each case present in every input
directory, load each model's `<pid>_softmax.npz` (written by `cli.predict
--save-softmax`), average, take the argmax, optionally keep each class's
largest connected component, and write `<pid>_pred.nii.gz`. Any set of
models or configurations can be ensembled this way; folds of one model are
already averaged inside predict. Host code, no device.

    python -m micformer_tpu_torch.cli.ensemble --inputs runA/preds runB/preds \
        --out ensembled [--largest-cc]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv=None):
    from micformer_tpu_torch.data.nifti import write_nifti
    from micformer_tpu_torch.pipeline.postprocess import remove_all_but_largest_cc

    p = argparse.ArgumentParser("micformer_tpu_torch.ensemble")
    p.add_argument("--inputs", nargs="+", required=True,
                   help="two or more predict output dirs holding <pid>_softmax.npz files")
    p.add_argument("--out", required=True)
    p.add_argument("--largest-cc", action="store_true")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    case_sets = []
    for d in args.inputs:
        pids = {os.path.basename(f)[: -len("_softmax.npz")]
                for f in glob.glob(os.path.join(d, "*_softmax.npz"))}
        if not pids:
            raise SystemExit(f"no *_softmax.npz under {d} (run predict with --save-softmax)")
        case_sets.append(pids)
    common = set.intersection(*case_sets)
    missing = set.union(*case_sets) - common
    if missing:
        print(f"warning: {len(missing)} cases not present in every input, "
              f"skipped: {sorted(missing)[:5]}...")

    for pid in sorted(common):
        probs = None
        for d in args.inputs:
            sm = np.load(os.path.join(d, f"{pid}_softmax.npz"))["softmax"].astype(np.float32)
            probs = sm if probs is None else probs + sm
        seg = np.argmax(probs / len(args.inputs), axis=0).astype(np.uint8)
        if args.largest_cc:
            seg = remove_all_but_largest_cc(seg)
        out_path = os.path.join(args.out, f"{pid}_pred.nii.gz")
        write_nifti(out_path, seg)
        print(f"{pid}: ensembled {len(args.inputs)} models -> {out_path}")


if __name__ == "__main__":
    main()
