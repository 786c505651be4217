"""Runnable two-stage cascade walkthrough (nnU-Net lowres -> fullres) on the
PyTorch port, on synthetic data: the nnUNetTrainerV2CascadeFullRes workflow
end to end, as examples/cascade_two_stage.py runs it on the JAX package.

  1. plan (emits plan_3d_lowres.json with a downsample factor)
  2. stage 0: train at low resolution, predict the val and test cases,
     export <pid>_segFromPrevStage.npy
  3. stage 1: train at full resolution with the stage-0 segmentations as
     pyramid-augmented one-hot input channels
  4. predict the test split through the cascade

Tiny shapes; swap the data root and shapes for a real dataset. Usage:
  python examples/torch_cascade_two_stage.py [workdir] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    """Returns the directory of the cascade's test-split predictions."""
    import numpy as np

    from micformer_tpu_torch.cli.plan import main as plan
    from micformer_tpu_torch.cli.predict import main as predict
    from micformer_tpu_torch.cli.train import main as train
    from micformer_tpu_torch.data.mmwhs import get_datasets
    from micformer_tpu_torch.data.synthetic import write_synthetic_dataset

    p = argparse.ArgumentParser()
    p.add_argument("workdir", nargs="?",
                   default=os.path.join(tempfile.gettempdir(), "cascade_demo"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    workdir, dev = args.workdir, ["--device", args.device]

    data = os.path.join(workdir, "data")
    if not os.path.isdir(data):
        write_synthetic_dataset(data, n_cases=6, shape=(40, 44, 36), seed=7)
    cache = os.path.join(workdir, "cache")

    # 1. experiment planning (fingerprint + 3D/2D/lowres plans)
    plan(["--data", data, "--out", os.path.join(workdir, "plans")])

    # 2. stage 0 (3d_lowres): train small, then export segs for the next stage
    low_run = os.path.join(workdir, "run_lowres")
    train(["--data", data, "--cache", cache, "--model", "unet3d",
           "--epochs", "2", "--val", "1", "--target-shape", "16",
           "--run-dir", low_run] + dev)
    prev_dir = os.path.join(workdir, "segs_from_prev_stage")
    for split in ("val", "test"):
        predict(["--data", data, "--cache", cache, "--run-dirs", low_run,
                 "--out", prev_dir, "--roi", "16", "--target-shape", "16",
                 "--split", split, "--save-seg-for-next-stage"] + dev)
    # training cases also need prev-stage segs; in a real run stage 0 is
    # trained 5-fold so every train case has an out-of-fold prediction.
    # Here: the training cases' own labels stand in (demo shortcut).
    tr, _, _ = get_datasets(data, cache_dir=cache, target_shape=(16, 16, 16))
    for i in range(len(tr)):
        pid = tr[i]["patient_id"]
        path = os.path.join(prev_dir, f"{pid}_segFromPrevStage.npy")
        if not os.path.exists(path):
            lab = np.asarray(tr[i]["label"])
            seg = lab.argmax(0) if lab.ndim == 4 else lab
            np.save(path, seg.astype(np.uint8))

    # 3. stage 1 (fullres cascade): prev-stage one-hot channels, pyramid-
    #    augmented at train time
    full_run = os.path.join(workdir, "run_fullres")
    train(["--data", data, "--cache", cache, "--model", "unet3d",
           "--epochs", "2", "--val", "1", "--target-shape", "32",
           "--run-dir", full_run, "--cascade-prev-seg-dir", prev_dir] + dev)

    # 4. cascade inference on the test split
    out = os.path.join(workdir, "preds")
    predict(["--data", data, "--cache", cache, "--run-dirs", full_run,
             "--out", out, "--roi", "32", "--target-shape", "32",
             "--split", "test", "--cascade-prev-seg-dir", prev_dir] + dev)
    print(f"cascade predictions under {out}")
    return out


if __name__ == "__main__":
    main()
