"""Experiment-planning CLI: `python -m micformer_tpu_torch.cli.plan --data <root>`.

Counterpart of `micformer_tpu/cli/plan.py` (nnU-Net's
nnUNet_plan_and_preprocess entry, MedNeXt/nnunet_mednext/experiment_planning/
nnUNet_plan_and_preprocess.py): fingerprint the dataset (shapes, spacings,
foreground intensity statistics, class values), derive the 3D, 2D and 3D
low-resolution plans (patch, batch, normalisation and per-stage pool and
conv kernel schedules), and write fingerprint.json, plan_3d.json,
plan_2d.json and plan_3d_lowres.json. A plan builds its network with
`models.generic_unet.build_from_plan`.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    import numpy as np

    from micformer_tpu_torch import native
    from micformer_tpu_torch.data.mmwhs import discover_cases
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.pipeline.planner import (
        analyze_dataset,
        plan_experiment,
        plan_experiment_2d,
        plan_experiment_lowres,
    )

    p = argparse.ArgumentParser("micformer_tpu_torch.plan")
    p.add_argument("--data", required=True, help="MM-WHS crop root")
    p.add_argument("--out", default=None, help="output dir (default <data>/plans)")
    p.add_argument("--max-patch", type=int, default=128)
    args = p.parse_args(argv)
    native.available()      # the volume reader: built once, up front

    cases = discover_cases(args.data)
    if not cases:
        raise SystemExit(f"no cases under {args.data}")
    out = args.out or os.path.join(args.data, "plans")
    os.makedirs(out, exist_ok=True)

    volumes, labels, spacings = [], [], []
    for c in cases:
        img, hdr = read_nifti(c.ct, dtype=np.float32, with_header=True)
        lab = read_nifti(c.ct_label)
        volumes.append(img[None])
        labels.append(lab)
        pixdim = getattr(hdr, "pixdim", None)  # NiftiHeader.pixdim: (dx, dy, dz)
        if pixdim is not None and len(pixdim) >= 3:
            # NIfTI zooms are (x,y,z); arrays are (z,y,x)
            spacings.append([float(pixdim[2]), float(pixdim[1]), float(pixdim[0])])

    fp = analyze_dataset(volumes, labels, spacings=spacings or None)
    fp.to_json(os.path.join(out, "fingerprint.json"))

    plan3d = plan_experiment(fp, max_patch=(args.max_patch,) * 3)
    plan2d = plan_experiment_2d(fp)
    planlow = plan_experiment_lowres(fp, max_patch=(args.max_patch,) * 3)
    with open(os.path.join(out, "plan_3d.json"), "w") as f:
        json.dump(plan3d, f, indent=2)
    with open(os.path.join(out, "plan_2d.json"), "w") as f:
        json.dump(plan2d, f, indent=2)
    with open(os.path.join(out, "plan_3d_lowres.json"), "w") as f:
        json.dump(planlow, f, indent=2)

    print(f"fingerprint: {len(cases)} cases, classes {fp.class_values}")
    print(f"3D plan: patch {plan3d['patch_size']} batch {plan3d['batch_size']} "
          f"pools {plan3d['pool_op_kernel_sizes']}")
    print(f"2D plan: patch {plan2d['patch_size']} "
          f"pools {plan2d['pool_op_kernel_sizes']}")
    print(f"lowres plan: downsample x{planlow['downsample_factor']:.2f} "
          f"patch {planlow['patch_size']}")
    print(f"wrote {out}/fingerprint.json, plan_3d.json, plan_2d.json, "
          f"plan_3d_lowres.json")


if __name__ == "__main__":
    main()
