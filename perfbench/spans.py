"""The program's spans in the traced stretch, for the per-layer readers that
read them.

The port marks its layers with `record_function` spans
(`micformer_tpu_torch/tracing.py`; PERF.md lists them), which the profiler
writes as host annotations on the clock of the device's operations. This
module reads the trace file again, with what `tracing.load_trace` leaves out:
each host row's thread, and each runtime call's and device operation's
`correlation`, which joins a launch to the operation it launched. It holds
the arithmetic the span readers share: the union of a name's spans, the
device operations launched under them, and the device's idle time outside
them.

The reader context (`tracing.Context`) does not name its trace file: the
file is the `path` of the `harness.run_cell` call that runs the reader with
that context (`trace_path`). A reader returns None where that call, its
trace or a span it needs is missing, as in a program that records no spans.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import sys

from perfbench.tracing import DEVICE_CATS, STRETCH

LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


@dataclasses.dataclass
class Row:
    name: str
    cat: str
    ts: float                  # microseconds
    dur: float                 # microseconds
    tid: object = None
    correlation: int | None = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


class Stretch:
    """The stretch [lo, hi] (µs) of a trace: its host annotations by name
    (`spans`), its launches by correlation and its device operations in
    start order, each kept where it overlaps the stretch."""

    def __init__(self, rows: list, lo: float, hi: float):
        self.lo, self.hi = lo, hi
        self.spans: dict[str, list[Row]] = {}
        self.launches: dict[int, Row] = {}
        self.device: list[Row] = []
        for r in rows:
            if r.end < lo or r.ts > hi:
                continue
            if r.cat in DEVICE_CATS:
                self.device.append(r)
            elif r.cat in LAUNCH_CATS and r.correlation is not None:
                self.launches[r.correlation] = r
            elif r.cat == "user_annotation" and r.name != STRETCH:
                self.spans.setdefault(r.name, []).append(r)
        self.device.sort(key=lambda r: r.ts)

    def named(self, match) -> list[Row]:
        """The spans whose name `match` takes: a name, a set of names or a
        compiled regex (searched)."""
        if isinstance(match, str):
            return list(self.spans.get(match, []))
        if isinstance(match, (set, frozenset, list, tuple)):
            return [r for n in match for r in self.spans.get(n, [])]
        return [r for n, rows in self.spans.items() if match.search(n) for r in rows]

    def launched_under(self, spans: list) -> list[Row]:
        """The device operations whose launch (joined by correlation) lies
        inside one of `spans`, on the span's thread."""
        by_thread = {}
        for r in spans:
            by_thread.setdefault(r.tid, []).append(r)
        inside = {tid: union(rows) for tid, rows in by_thread.items()}
        out = []
        for e in self.device:
            launch = self.launches.get(e.correlation)
            if launch is not None and _holds(inside.get(launch.tid, []), launch.ts):
                out.append(e)
        return out

    def idle_outside(self, spans: list) -> float:
        """Seconds of the stretch in which no device operation ran and no
        span of `spans` was open."""
        busy = union(self.device, self.lo, self.hi)
        covered = merge(busy + union(spans, self.lo, self.hi))
        return (self.hi - self.lo - sum(b - a for a, b in covered)) * 1e-6


def union(rows: list, lo: float = float("-inf"), hi: float = float("inf")) -> list:
    """The union of the rows' intervals, clipped to [lo, hi], as sorted
    disjoint (start, end) pairs in µs."""
    return merge([(max(r.ts, lo), min(r.end, hi)) for r in rows])


def merge(intervals: list) -> list:
    """Sorted disjoint (start, end) pairs covering the given ones; empty
    intervals dropped."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def seconds(rows: list) -> float:
    """The seconds covered by the union of the rows' intervals."""
    return sum(b - a for a, b in union(rows)) * 1e-6


def _holds(intervals: list, t: float) -> bool:
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def load(path: str) -> Stretch:
    """The stretch of a Chrome trace of `torch.profiler`, around its
    `perfbench.stretch` span; raises ValueError without one."""
    with open(path) as f:
        raw = json.load(f)
    rows = raw["traceEvents"] if isinstance(raw, dict) else raw
    marks = [r for r in rows if r.get("ph") == "X" and r.get("name") == STRETCH
             and r.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"{path}: no {STRETCH} span")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    out = []
    for r in rows:
        if r.get("ph") != "X" or "dur" not in r:
            continue
        corr = (r.get("args") or {}).get("correlation")
        out.append(Row(str(r.get("name", "")), str(r.get("cat", "")), float(r["ts"]),
                       float(r["dur"]), r.get("tid"), None if corr is None else int(corr)))
    return Stretch(out, lo, hi)


_CACHE: dict = {}


def trace_path(ctx) -> str | None:
    """The trace file of the `harness.run_cell` call that reads `ctx`: the
    `path` local of the innermost such call on this thread's stack whose
    `ctx` is this one; None outside such a call."""
    frame = sys._getframe(1)
    while frame is not None:
        if (frame.f_code.co_name == "run_cell"
                and frame.f_globals.get("__name__") == "perfbench.harness"
                and frame.f_locals.get("ctx") is ctx):
            path = frame.f_locals.get("path")
            return path if isinstance(path, str) else None
        frame = frame.f_back
    return None


def of(ctx) -> Stretch | None:
    """The stretch of the trace that `ctx` was read from (loaded once a
    file), or None where there is none."""
    path = trace_path(ctx)
    if path is None or not os.path.exists(path):
        return None
    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    if key not in _CACHE:
        _CACHE.clear()
        try:
            _CACHE[key] = load(path)
        except ValueError:
            _CACHE[key] = None
    return _CACHE[key]
