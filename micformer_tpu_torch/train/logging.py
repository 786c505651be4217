"""Metric logging as JSON lines.

Counterpart of `MetricsWriter` and `save_metrics` in
`micformer_tpu/train/logging.py`, JSONL only: scalars go to
`<run_dir>/events.jsonl`, one {"tag", "value", "step"} object a line, and
per-class validation Dice is also appended to `<run_dir>/val.txt`.
"""

from __future__ import annotations

import json
import os

import numpy as np


class MetricsWriter:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._path = os.path.join(run_dir, "events.jsonl")

    def scalar(self, tag: str, value: float, step: int):
        """Append one scalar (the file is opened for each line: a few a
        epoch, and no handle is left open)."""
        with open(self._path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")


def save_metrics(writer: MetricsWriter, per_class_dice, class_names, epoch: int,
                 run_dir: str):
    """Per-class mean Dice as scalars, and one line appended to val.txt.
    per_class_dice: [n_patients, C]."""
    per_class_dice = np.asarray(per_class_dice)
    means = per_class_dice.mean(0) if len(per_class_dice) else np.zeros(len(class_names))
    for name, v in zip(class_names, means):
        writer.scalar(f"val/dice_{name}", float(v), epoch)
    with open(os.path.join(run_dir, "val.txt"), "a") as f:
        f.write(f"Epoch {epoch}: "
                + ", ".join(f"{n}={v:.4f}" for n, v in zip(class_names, means)) + "\n")
