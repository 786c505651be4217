"""Tracing and timing on the card.

Counterpart of `micformer_tpu/train/profiling.py` on PyTorch:
  - trace(logdir): a `torch.profiler` context over the CPU and, when CUDA is
    initialised, the card's kernels; writes a Chrome trace to
    `<logdir>/trace.json` and yields the profiler (`key_averages()` sums
    time by kernel name). The trace holds the port's spans
    (`micformer_tpu_torch.tracing.span`: `serve.infer`, `sw.*`, the
    model's blocks, `train.*`, the kernel wrappers `k1.*`, `k2.*`, `k3.*`
    by route) as annotations on the kernels' clock; PERF.md's table of
    spans lists each with the per-layer metric that reads it;
  - Throughput: steps and items a second, the card synchronised before the
    clock is read;
  - time_fn: (mean, p50) seconds of fn(*args), on the card between CUDA
    events, else on the host clock;
  - enable_nan_debugging: every op whose floating output holds a NaN
    raises FloatingPointError naming the op, forward and backward (JAX's
    jax_debug_nans). For debugging runs: each op's output is read back.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def _on_card() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _sync():
    if _on_card():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed work; the trace goes to <logdir>/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if _on_card() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Throughput:
    """Steps and items a second since construction or reset()."""

    def __init__(self):
        self.reset()

    def reset(self):
        _sync()
        self._t0 = time.perf_counter()
        self.steps = 0
        self.items = 0

    def update(self, n_items: int = 1):
        self.steps += 1
        self.items += n_items

    def _elapsed(self) -> float:
        _sync()
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        dt = self._elapsed()
        return self.steps / dt if dt > 0 else 0.0

    @property
    def items_per_sec(self) -> float:
        dt = self._elapsed()
        return self.items / dt if dt > 0 else 0.0


def time_fn(fn, *args, warmup: int = 1, reps: int = 10):
    """(mean_s, p50_s) of fn(*args) over reps after warmup calls: on the
    card each call between two CUDA events, else on the host clock."""
    for _ in range(warmup):
        fn(*args)
    ts = []
    if _on_card():
        events = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn(*args)
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        ts = [s.elapsed_time(e) / 1e3 for s, e in events]
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return float(ts.mean()), float(np.percentile(ts, 50))


_NAN_MODE = None


def _nan_check_mode():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class NanCheck(TorchDispatchMode):
        """Runs each op, then raises if a floating output holds a NaN."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.device.type != "meta"
                        and (t.is_floating_point() or t.is_complex())
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN in the output of {func}")
            return out

    return NanCheck()


def enable_nan_debugging(enable: bool = True):
    """Raise FloatingPointError, naming the op, at the first op whose
    floating output holds a NaN (JAX's `jax_debug_nans`): a dispatch mode
    over every op of the calling thread and of the autograd engine's
    backward, which inherits it, so a NaN made in a backward is caught where
    it is made too (torch.autograd.set_detect_anomaly sees the backward
    only). enable=False restores normal dispatch. Expensive: each output is
    checked on the host."""
    global _NAN_MODE
    if enable and _NAN_MODE is None:
        _NAN_MODE = _nan_check_mode()
        _NAN_MODE.__enter__()
    elif not enable and _NAN_MODE is not None:
        mode, _NAN_MODE = _NAN_MODE, None
        mode.__exit__(None, None, None)
