"""The reader of dwt2_wgrad_roofline.train on a synthetic trace: its least
time comes from the reference MedNeXt-S's up blocks (their inputs' shapes),
and only kernels named dw_transpose2_wgrad count as its device time."""

import json
import os

import pytest
from conftest import ROOT

from perfbench import harness, tracing, work

NAME = "dwt2_wgrad_roofline.train"
DWT2 = "void (anonymous namespace)::dw_transpose2_wgrad_kernel<__nv_bfloat16, 3, true>(int)"
REDUCE = "(anonymous namespace)::dw_transpose2_wgrad_reduce(double const*, float*)"
OTHERS = ["void dw_conv3_wgrad_tile_kernel<__nv_bfloat16, 3, true>(CUtensorMap)",
          "void cudnn::cnn::convolveNd_wgrad_engine<__nv_bfloat16, 3, 128>(int)"]


def _trace(path, rows):
    """A stretch of 1000 µs holding `rows` (name, start, duration) kernels."""
    events = [{"ph": "X", "name": "perfbench.stretch", "cat": "user_annotation", "ts": 0,
               "dur": 1000, "pid": 0, "tid": 0}]
    events += [{"ph": "X", "name": n, "cat": "kernel", "ts": ts, "dur": dur, "pid": 0, "tid": 7}
               for n, ts, dur in rows]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def _ctx(path, steps):
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.Cell(bench, "mednext_s.train_b2")
    device, _, (lo, hi) = tracing.load_trace(path)
    return tracing.Context(
        events=device, busy_s=tracing.busy_seconds(device, lo, hi), stretch_s=(hi - lo) * 1e-6,
        stretch_calls=steps, stretch_volumes=0, stretch_steps=steps, window_s=40.0,
        window_calls=100, window_volumes=0, window_steps=100, config=cell.config, mix=cell.mix,
        work=work, train_batch=2)


def test_reads_the_up_blocks_over_the_named_kernels(tmp_path):
    path = str(tmp_path / "t.json")
    _trace(path, [(DWT2, 100, 300), (REDUCE, 400, 20), (OTHERS[0], 500, 100),
                  (OTHERS[1], 600, 200)])
    read = tracing.load_reader(os.path.join(ROOT, "perfbench", "metrics"), NAME)
    ctx = _ctx(path, steps=2)
    # MedNeXt-S (32 channels, k 3) at b2, roi 128: the four up blocks' inputs
    ups = [(2, 512, 8), (2, 256, 16), (2, 128, 32), (2, 64, 64)]
    least = sum(work.least_seconds((B * C * L ** 3 * 9) * 2 + C * 28 * 4,
                                   2 * 27 * B * C * L ** 3 + 8 * B * C * L ** 3,
                                   work.PEAK_F32_CUDA_CORE_FLOPS) for B, C, L in ups)
    # memory-bound: 802 MB at 3.35 TB/s
    assert least == pytest.approx(802.2e6 / 3.35e12, rel=1e-3)
    assert read(ctx) == pytest.approx(100 * 2 * least / 320e-6)

    _trace(path, [(n, 100 + 200 * i, 100) for i, n in enumerate(OTHERS)])
    assert read(_ctx(path, steps=2)) is None          # the parent: no such kernel
