"""The port's run export and profiling helpers on the CPU: run histories and
the merged CSV equal the JAX package's `train/run_export.py` on the same
run directories (one written by the port's trainer, one by hand with nested,
boolean and text fields); `to_wandb` returns None without wandb, as JAX's
does; `profiling.trace` writes a Chrome trace and exposes the profiler,
`Throughput` counts and `time_fn` times.
"""

import json
import sys

import numpy as np
import pytest
import torch

from micformer_tpu.train import run_export as jexport
from micformer_tpu_torch import registry as treg
from micformer_tpu_torch.train import profiling, run_export
from micformer_tpu_torch.train.trainer import TrainConfig, Trainer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two run directories: one epoch of a tiny trainer with validation, and
    hand-written sinks."""
    base = tmp_path_factory.mktemp("runs")
    model = treg.build("micformer", device="cpu", embed_dim=6, depths=(1, 1), num_heads=(3, 6))
    trainer = Trainer(model, TrainConfig(run_dir=str(base / "trained"), epochs=1, val_every=1,
                                         augment="none", steps_per_epoch=1))
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.uniform(0, 1, (1, 2, 16, 16, 16)).astype(np.float16)),
             torch.from_numpy(rng.integers(0, 8, (1, 16, 16, 16)).astype(np.uint8)), {})
    trainer.fit([batch], [batch])
    hand = base / "hand"
    hand.mkdir()
    (hand / "events.jsonl").write_text("\n".join(json.dumps(r) for r in [
        {"tag": "train/loss", "value": 0.5, "step": 0}, {"tag": "train/loss", "value": 0.25},
        {"note": "no tag"}]) + "\n\n")
    (hand / "log.jsonl").write_text("\n".join(json.dumps(r) for r in [
        {"n_parameters": 12}, {"epoch": 3, "train_loss": 0.1, "lr": 1e-4, "skipped": True},
        {"step": 7, "val_loss": 2, "name": "x"}, {"pretrained": {"loaded": 3}},
        {"find_lr": {"lrs": [1e-6], "losses": [1.0]}}]) + "\n")
    return [str(base / "trained"), str(hand)]


def test_run_data_and_csv_match_jax(runs, tmp_path):
    for rd in runs:
        assert run_export.get_run_data(rd) == jexport.get_run_data(rd)
    got = run_export.export_runs_csv(runs, str(tmp_path / "port.csv"))
    want = jexport.export_runs_csv(runs, str(tmp_path / "jax.csv"))
    assert open(got).read() == open(want).read()
    rows = open(got).read().splitlines()
    assert rows[0] == "run,metric,step,value"
    assert any(r.startswith("trained,train/loss,0,") for r in rows)
    assert any(r.startswith("trained,val/meandice,0,") for r in rows)


def test_to_wandb_without_wandb_returns_none(runs, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert run_export.to_wandb(runs[0]) is None and jexport.to_wandb(runs[0]) is None


def test_profiling_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any("mm" in e.key for e in prof.key_averages())
    meter = profiling.Throughput()
    for _ in range(3):
        meter.update(2)
    assert meter.steps == 3 and meter.items == 6 and meter.items_per_sec > 0
    mean, p50 = profiling.time_fn(lambda a: a @ a, x, warmup=1, reps=5)
    assert 0 < p50 and 0 < mean
