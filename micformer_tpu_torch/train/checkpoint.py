"""Checkpoints: the dual best-Dice / best-loss policy, `latest` and resume.

Counterpart of `micformer_tpu/train/checkpoint.py` on `torch.save`: a
checkpoint `ckpt_<tag>.pt` holds one dict (the trainer's payload: params,
optimizer state, step, epoch, best_dice, best_loss, ...), beside a
`ckpt_<tag>.meta.json` sidecar with the schema version, tag, metric and time.
`keep_best_k` also archives every `best*` save as `ckpt_<tag>_k<step>` and
keeps the K best of them by metric.

Under data parallelism every rank calls `save` (the trainer's payload may
take a collective to build), the primary rank alone writes, and every rank
returns once the file is written, so a rank that reads it next finds it.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import torch

from micformer_tpu_torch.parallel.distributed import barrier
from micformer_tpu_torch.parallel.mesh import is_primary

# Schema version of the payload the trainer writes: 1 held params,
# opt_state and step; 2 adds epoch, best_dice and best_loss.
SCHEMA_VERSION = 2


class CheckpointManager:
    def __init__(self, run_dir: str, keep_best_k: int | None = None):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.keep_best_k = keep_best_k

    def _path(self, tag: str) -> str:
        return os.path.join(self.run_dir, f"ckpt_{tag}.pt")

    def _meta_path(self, tag: str) -> str:
        return os.path.join(self.run_dir, f"ckpt_{tag}.meta.json")

    def save(self, tag: str, state: Any, metric: float | None = None):
        """Write `state` under `tag` (atomically: a temporary file renamed)
        on the primary rank; every rank waits for the file."""
        if is_primary():
            self._write(tag, state, metric)
        barrier()

    def _write(self, tag: str, state: Any, metric: float | None):
        path = self._path(tag)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        with open(self._meta_path(tag), "w") as f:
            json.dump({"schema_version": SCHEMA_VERSION, "tag": tag,
                       "metric": metric, "time": time.time()}, f)
        if self.keep_best_k and tag.startswith("best") and metric is not None:
            step = int(state["step"]) if isinstance(state, dict) and "step" in state else 0
            self._archive_best(tag, path, metric, step)

    def _archive_best(self, tag: str, path: str, metric: float, step: int):
        arch = f"{tag}_k{step}"
        if not os.path.exists(self._path(arch)):
            shutil.copyfile(path, self._path(arch))
        with open(self._meta_path(arch), "w") as f:
            json.dump({"schema_version": SCHEMA_VERSION, "tag": tag,
                       "metric": metric, "step": step, "time": time.time()}, f)
        entries = []
        for m in os.listdir(self.run_dir):
            if m.startswith(f"ckpt_{tag}_k") and m.endswith(".meta.json"):
                with open(os.path.join(self.run_dir, m)) as f:
                    entries.append((json.load(f).get("metric", 0.0),
                                    m[len("ckpt_"): -len(".meta.json")]))
        entries.sort(reverse=True)
        for _, name in entries[self.keep_best_k:]:
            for p in (self._path(name), self._meta_path(name)):
                if os.path.exists(p):
                    os.remove(p)

    def meta(self, tag: str) -> dict:
        """The sidecar metadata, {} when there is none."""
        try:
            with open(self._meta_path(tag)) as f:
                return json.load(f)
        except OSError:
            return {}

    def restore(self, tag: str, map_location="cpu") -> Any:
        return torch.load(self._path(tag), map_location=map_location, weights_only=True)

    def restore_params_only(self, tag: str, map_location="cpu") -> Any:
        """The weights of `ckpt_<tag>.pt`: the trainer payload's "params", or
        the file's content as it is when it holds a bare state_dict."""
        full = self.restore(tag, map_location)
        return full["params"] if isinstance(full, dict) and "params" in full else full

    def exists(self, tag: str) -> bool:
        return os.path.exists(self._path(tag))
