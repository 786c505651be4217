"""Reduction of a `torch.profiler` Chrome trace of the traced stretch to what
the per-layer readers and the result's `device` and `breakdown` need.

The stretch is the host span `perfbench.stretch` around the traced calls.
Device operations are the trace's kernels, copies and sets; host operations
its CPU ops and annotations, and the CUDA runtime's calls.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import os
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}
RUNTIME_CATS = {"cuda_runtime"}
STRETCH = "perfbench.stretch"


@dataclasses.dataclass
class Event:
    name: str
    cat: str
    ts: float      # microseconds
    dur: float     # microseconds

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads.

    events: the stretch's device operations, in start order; busy_s: the
    seconds of the stretch in which one ran; stretch_s: its length;
    stretch_calls, stretch_volumes, stretch_steps: the calls, served volumes
    and training steps it holds; window_s, window_calls,
    window_volumes, window_steps: the same over the whole window; config,
    mix: the cell's; work: the `perfbench.work` module; forwards_per_call:
    the batch of each model forward of a serving call; train_batch: a
    training step's batch."""

    events: list
    busy_s: float
    stretch_s: float
    stretch_calls: int
    stretch_volumes: int
    stretch_steps: int
    window_s: float
    window_calls: int
    window_volumes: int
    window_steps: int
    config: dict
    mix: dict
    work: object
    forwards_per_call: list = dataclasses.field(default_factory=list)
    train_batch: int = 0

    def kernels(self, pattern=None) -> list:
        """The stretch's kernels, those whose name `pattern` (a compiled
        regex) finds if given."""
        return [e for e in self.events if e.cat == "kernel"
                and (pattern is None or pattern.search(e.name))]


def load_trace(path: str) -> tuple[list, list, tuple[float, float]]:
    """(device events, host events, (start, end) of the stretch in µs) of a
    Chrome trace; events outside the stretch are dropped."""
    with open(path) as f:
        raw = json.load(f)
    rows = raw["traceEvents"] if isinstance(raw, dict) else raw
    spans = [r for r in rows if r.get("ph") == "X" and r.get("name") == STRETCH
             and r.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"{path}: no {STRETCH} span")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    device, host = [], []
    for r in rows:
        if r.get("ph") != "X" or "dur" not in r:
            continue
        e = Event(str(r.get("name", "")), str(r.get("cat", "")), float(r["ts"]), float(r["dur"]))
        if e.end < lo or e.ts > hi:
            continue
        if e.cat in DEVICE_CATS:
            device.append(e)
        elif (e.cat in HOST_CATS or e.cat in RUNTIME_CATS) and e.name != STRETCH:
            host.append(e)
    device.sort(key=lambda e: e.ts)
    host.sort(key=lambda e: e.ts)
    return device, host, (lo, hi)


def busy_intervals(device: list, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the device operations' intervals, clipped to [lo, hi]."""
    out = []
    for e in device:
        a, b = max(e.ts, lo), min(e.end, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_seconds(device: list, lo: float, hi: float) -> float:
    return sum(b - a for a, b in busy_intervals(device, lo, hi)) * 1e-6


def idle_gaps(device: list, host: list, lo: float, hi: float, top: int = 10) -> list:
    """[[host op, seconds], ...]: the device's idle time in [lo, hi] summed
    by the innermost host op running at each gap's midpoint (a CPU op or an
    annotation, else a runtime call), the `top` largest."""
    busy = busy_intervals(device, lo, hi)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    named = {0: [e for e in host if e.cat in HOST_CATS],
             1: [e for e in host if e.cat in RUNTIME_CATS]}
    starts = {k: [e.ts for e in v] for k, v in named.items()}
    sums = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        sums[_innermost(named, starts, mid)] += (b - a) * 1e-6
    return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def _innermost(named: dict, starts: dict, t: float, reach: int = 256) -> str:
    """The name of the latest-starting event that holds time t (of those
    starting together, the shortest), among the CPU ops and annotations
    first and then the runtime calls."""
    for k in (0, 1):
        events, best, left = named[k], None, reach
        for j in range(bisect.bisect_right(starts[k], t) - 1, -1, -1):
            e = events[j]
            if best is not None and e.ts < best.ts:
                break
            if e.end >= t and (best is None or e.dur < best.dur):
                best = e
            left -= 1
            if left == 0 and best is None:
                break
        if best is not None:
            return best.name
    return "no host op"


def device_ops(device: list, top: int = 10) -> list:
    """[[name, seconds], ...]: device time summed by operation name, the
    `top` largest."""
    sums = defaultdict(float)
    for e in device:
        sums[e.name[:200]] += e.dur * 1e-6
    return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def load_reader(metrics_dir: str, name: str):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    path = os.path.join(metrics_dir, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
