"""Named spans of the port's layers on the profiler's timeline.

`span(name)` marks the work it encloses as one span of a `torch.profiler`
trace: a `record_function` annotation, which the profiler times on the same
clock as the card's kernels, so a span's device work is found by the launch
correlation of the kernels inside it. Spans nest by time on their thread.

A span does nothing unless a profiler is recording and the code is not being
compiled or exported: the off path reads one flag and returns a shared no-op
context, with no dispatcher call and no allocation, so the spans stay in the
hot paths. There is no switch and no store of its own: the profiler records
the spans and `train.profiling.trace` writes them out. Names are
`<layer>.<part>` (`serve.infer`, `sw.forward`, `micformer.enc2.cross1_3`,
`train.step`, `k1.forward.mma`, ...); PERF.md lists each with the per-layer
metric that reads it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a span while a profiler records,
    else the shared no-op context."""
    if not _profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _OFF
    return _profiler.record_function(name)
