"""Run history export: a run's JSONL sinks as series, many runs as one CSV.

The port's own copy of `micformer_tpu/train/run_export.py`, over the files
the port's trainer writes: `events.jsonl` ({tag, value, step} records of
`train/logging.py`) and `log.jsonl` (flat per-epoch dicts of
`train/trainer.py`).
  - get_run_data(run_dir): {metric: [(step, value), ...]};
  - get_run_dataframe(run_dir): the same as a pandas DataFrame, one row a
    step, or None without pandas;
  - export_runs_csv(run_dirs, out_csv): many runs in one long-format CSV;
  - to_wandb(run_dir): a run's history replayed into wandb when the package
    is importable, else None.
"""

from __future__ import annotations

import csv
import json
import os


def _records(path: str):
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def get_run_data(run_dir: str) -> dict:
    """{metric: [(step, value), ...]} from `events.jsonl` (by tag) and
    `log.jsonl` (every numeric field but step and epoch, at the record's
    step, else its epoch, else 0; booleans and nested records are left
    out)."""
    series: dict = {}
    for rec in _records(os.path.join(run_dir, "events.jsonl")):
        if "tag" in rec:
            series.setdefault(rec["tag"], []).append((rec.get("step", 0), float(rec["value"])))
    for rec in _records(os.path.join(run_dir, "log.jsonl")):
        step = rec.get("step", rec.get("epoch", 0))
        for k, v in rec.items():
            if k in ("step", "epoch") or isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            series.setdefault(k, []).append((step, float(v)))
    return series


def get_run_dataframe(run_dir: str):
    """The run history as a pandas DataFrame: a "step" column and one column
    a metric, one row a step in step order; None when pandas is not
    importable."""
    try:
        import pandas as pd
    except ImportError:
        return None
    rows: dict = {}
    for metric, pts in get_run_data(run_dir).items():
        for step, v in pts:
            rows.setdefault(step, {})[metric] = v
    return pd.DataFrame([{"step": s, **m} for s, m in sorted(rows.items())])


def export_runs_csv(run_dirs, out_csv: str) -> str:
    """Write the histories of `run_dirs` as one CSV with the columns run
    (the directory's name), metric, step, value; returns out_csv."""
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["run", "metric", "step", "value"])
        for rd in run_dirs:
            name = os.path.basename(os.path.normpath(rd))
            for metric, pts in sorted(get_run_data(rd).items()):
                for step, v in pts:
                    w.writerow([name, metric, step, v])
    return out_csv


def to_wandb(run_dir: str, project: str = "micformer_tpu", **init_kwargs):
    """Replay a run's history into a new wandb run, one log call a step, and
    return it; None when wandb is not installed."""
    try:
        import wandb
    except ImportError:
        return None
    run = wandb.init(project=project, name=os.path.basename(run_dir), **init_kwargs)
    steps: dict = {}
    for metric, pts in get_run_data(run_dir).items():
        for step, v in pts:
            steps.setdefault(step, {})[metric] = v
    for step in sorted(steps):
        run.log(steps[step], step=int(step))
    run.finish()
    return run
