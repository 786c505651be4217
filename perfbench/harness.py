"""One run of one cell: find its configuration, traffic mix, limits and
per-layer readers by name, drive the program, judge what it produced, and
print the result line.

Everything a cell needs is found by the names in `BENCHMARK.json`: the
configuration's file, `traffic/<mix>.json`, `limits/<cell>.json` and
`metrics/<metric>.py` for each per-layer metric the cell reports.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import drive, judge, tracing, work

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names the run must not hold: the JAX package and JAX
FORBIDDEN = {"jax", "jaxlib", "flax", "micformer_tpu"}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among the loaded modules, each module
    name compared by its whole part before the first dot."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix, limits
    and the metrics it reports."""

    def __init__(self, bench: dict, name: str):
        work_ = {w["name"]: w for w in bench["workloads"]}
        if name not in work_:
            raise KeyError(f"unknown workload {name!r}; one of {sorted(work_)}")
        self.name = name
        self.spec = work_[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.config = load_json(os.path.join(ROOT, conf["file"]))
        self.mix = load_json(os.path.join(HERE, "traffic", f"{self.spec['traffic']}.json"))
        drive.check_mix(self.mix)
        self.limits = load_json(os.path.join(HERE, "limits", f"{name}.json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"] if name in m.get(
            "workloads", [name] if m["moves"] in moves else [])]


def trace_context(cell: Cell, res: dict, path: str) -> tuple[tracing.Context, dict, dict]:
    """(reader context, device fields, breakdown) of a traced run."""
    device, host, (lo, hi) = tracing.load_trace(path)
    stretch_s = (hi - lo) * 1e-6
    busy = tracing.busy_seconds(device, lo, hi)
    calls = res["trace_calls"]
    serve = cell.mix["kind"] == "serve"
    ctx = tracing.Context(
        events=device, busy_s=busy, stretch_s=stretch_s, stretch_calls=calls,
        stretch_volumes=calls * cell.mix.get("volumes_per_call", 0) if serve else 0,
        stretch_steps=0 if serve else calls, window_s=res["window_s"],
        window_calls=res["calls"], window_volumes=res.get("volumes", 0),
        window_steps=res.get("steps", 0), config=cell.config, mix=cell.mix, work=work,
        forwards_per_call=res.get("forwards_per_call", []), train_batch=res.get("trace_batch", 0))
    fields = {"busy_s": busy, "window_s": stretch_s}
    breakdown = {"device_ops": tracing.device_ops(device),
                 "idle_gaps": tracing.idle_gaps(device, host, lo, hi)}
    return ctx, fields, breakdown


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, mark_setup,
             fault=None) -> dict:
    """Drive the cell, then judge it. Returns the result line's fields
    (`correct`, `attempted`, `failed`, `metrics`, `device`, optional
    `breakdown`, `checks`). `fault` plants a fault in the program (tests)."""
    mix = cell.mix
    tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
    path = os.path.join(tmp, "trace.json")
    tr = drive.Trace(mix["trace_calls"], seconds / 3, path) if trace else None
    try:
        if mix["kind"] == "serve":
            rng = np.random.default_rng(seed)
            keep = sorted(int(i) for i in rng.choice(mix["judge_range"], mix["judge_calls"],
                                                     replace=False))
            res = drive.serve(cell.config, mix, seed, seconds, device, tr, keep, mark_setup,
                              fault=fault)
        else:
            res = drive.train(cell.config, mix, seed, seconds, device, tr, mix["follow_steps"],
                              mark_setup, fault=fault)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        metrics, dev = {}, {"memory_peak_bytes": res["memory_peak_bytes"]}
        breakdown = None
        if trace:
            if not tr.export():
                raise RuntimeError("the window closed before the traced stretch ended: "
                                   "give it more seconds")
            res["trace_calls"] = tr.calls
            ctx, fields, breakdown = trace_context(cell, res, path)
            dev.update(fields)
            for m in cell.per_layer:
                value = tracing.load_reader(os.path.join(HERE, "metrics"), m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            # an end-to-end metric reads the quantity its name starts with:
            # volumes_per_s.host_paced is the window's volumes_per_s
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": float(res[m["name"].split(".")[0]]),
                                      "unit": m["unit"]}
    finally:
        if os.path.exists(path):
            os.remove(path)
        os.rmdir(tmp)
    t0 = time.perf_counter()
    if mix["kind"] == "serve":
        numbers = judge.serve_numbers(cell.config, mix, seed, res["pool"], res["kept"], device)
    else:
        numbers = judge.train_check(cell.config, mix, seed, res, device)
    correct, checks = judge.verdict(numbers, cell.limits)
    print(f"perfbench: window {res['window_s']:.2f} s, {res['calls']} calls; reference "
          f"{time.perf_counter() - t0:.2f} s; readings {numbers}", file=sys.stderr)
    out = {"correct": correct and res["failed"] == 0, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return proc.stdout.strip() or proc.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def program_in_checkout() -> bool:
    """Whether the program under test is this checkout's package, not one
    installed elsewhere."""
    import micformer_tpu_torch

    where = os.path.realpath(os.path.dirname(micformer_tpu_torch.__file__))
    return where == os.path.join(os.path.realpath(ROOT), "micformer_tpu_torch")


def main(args, process_start: float) -> int:
    t0 = time.time()
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = Cell(bench, args.workload)
    if not program_in_checkout():
        print(f"perfbench: micformer_tpu_torch is not this checkout's ({ROOT})", file=sys.stderr)
        return 5
    print(f"perfbench: set-up interpreter and torch {t0 - process_start:.2f} s, the program's "
          f"import {time.time() - t0:.2f} s", file=sys.stderr)
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)

    def mark_setup():
        torch.cuda.synchronize(device)
        return time.time() - process_start

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, mark_setup)
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": chips, **result["device"]}
    print(f"perfbench: card {card_line()}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for c in result["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])      # JSON has no inf or nan
    for name, c in result["checks"].items():
        print(f"perfbench: check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
