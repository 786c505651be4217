"""The trace reduction and the per-layer readers on a synthetic profiler
trace whose answers are worked out by hand."""

import json
import os

import pytest
from conftest import ROOT

from perfbench import harness, tracing, work

K1 = "void window_attention_kernel<__nv_bfloat16>(__nv_bfloat16 const*)"
K2 = "void fused_window_attention_kernel<__nv_bfloat16>(__nv_bfloat16 const*)"
K3 = "void dw_conv3_tile_kernel<3, __nv_bfloat16>(CUtensorMap)"
WG = "void dw_conv3_wgrad_volume_kernel<3, __nv_bfloat16>(CUtensorMap)"


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


def synthetic(path):
    """A stretch of 1000 µs: device busy over [100, 400] (K1 and a
    concurrent K2 that overlaps it), [500, 600] (K3), [700, 750] (a copy)
    and [800, 850] (wgrad); host ops around the gaps."""
    rows = [
        _x("perfbench.stretch", "user_annotation", 0, 1000),
        _x("aten::layer_norm", "cpu_op", 0, 90),              # holds gap [0, 100]
        _x("aten::to", "cpu_op", 420, 60),                    # holds gap [400, 500]
        _x("cudaLaunchKernel", "cuda_runtime", 610, 80),      # holds gap [600, 700]
        _x("perfbench.call", "user_annotation", 0, 1000),
        _x(K1, "kernel", 100, 200),
        _x(K2, "kernel", 250, 150),
        _x(K3, "kernel", 500, 100),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 700, 50),
        _x(WG, "kernel", 800, 50),
        _x(K3, "kernel", 1200, 10),                           # after the stretch
        {"ph": "i", "name": "marker", "ts": 5},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": rows}, f)


def test_busy_idle_and_breakdown(tmp_path):
    path = str(tmp_path / "t.json")
    synthetic(path)
    device, host, (lo, hi) = tracing.load_trace(path)
    assert (lo, hi) == (0.0, 1000.0)
    assert len(device) == 5
    assert tracing.busy_seconds(device, lo, hi) == pytest.approx(500e-6)
    gaps = dict(tracing.idle_gaps(device, host, lo, hi))
    # [0, 100] aten::layer_norm; [400, 500] aten::to; [600, 700] the runtime
    # call's midpoint lies inside perfbench.call only; [750, 800] and
    # [850, 1000] too
    assert gaps["aten::layer_norm"] == pytest.approx(100e-6)
    assert gaps["aten::to"] == pytest.approx(100e-6)
    assert gaps["perfbench.call"] == pytest.approx(300e-6)
    ops = dict(tracing.device_ops(device))
    assert ops[K1] == pytest.approx(200e-6) and ops[K3] == pytest.approx(100e-6)


def _context(path, cell, calls, volumes, steps, forwards, batch):
    device, host, (lo, hi) = tracing.load_trace(path)
    return tracing.Context(
        events=device, busy_s=tracing.busy_seconds(device, lo, hi), stretch_s=(hi - lo) * 1e-6,
        stretch_calls=calls, stretch_volumes=volumes, stretch_steps=steps, window_s=40.0,
        window_calls=100, window_volumes=100 * max(volumes // max(calls, 1), 1),
        window_steps=100 if steps else 0, config=cell.config, mix=cell.mix, work=work,
        forwards_per_call=forwards, train_batch=batch)


def _read(name, ctx):
    return tracing.load_reader(os.path.join(ROOT, "perfbench", "metrics"), name)(ctx)


@pytest.mark.parametrize("serving", ["infer", "host_paced"])
def test_readers_on_a_synthetic_trace(tmp_path, monkeypatch, serving):
    # the serving readers of device-paced (.infer) and host-paced cells
    # read alike
    path = str(tmp_path / "t.json")
    synthetic(path)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    mic = harness.Cell(bench, "micformer.pair_sw8")
    ctx = _context(path, mic, calls=2, volumes=4, steps=0, forwards=[16], batch=0)
    assert _read(f"device_idle.{serving}", ctx) == pytest.approx(50.0)
    assert _read("device_idle.train", ctx) is None
    assert _read(f"kernels_per_volume.{serving}", ctx) == pytest.approx(4 / 4)
    assert _read("kernels_per_step.train", ctx) is None
    # K1's kernel alone (not K2's) is timed: 200 µs for two calls
    least = 2 * work.k1_least_seconds(mic.config, 16, 128)
    assert _read("k1_roofline.infer", ctx) == pytest.approx(100 * least / 200e-6)
    monkeypatch.setattr(work, "model_flops", lambda config, b, roi, train=False: 1e12 * b)
    assert _read(f"mfu.{serving}", ctx) == pytest.approx(100 * 100 * 16e12 / (40 * 989e12))
    assert _read("mfu.train", ctx) is None

    med = harness.Cell(bench, "mednext_s.train_b2")
    ctx = _context(path, med, calls=2, volumes=0, steps=2, forwards=[], batch=2)
    assert _read("device_idle.train", ctx) == pytest.approx(50.0)
    assert _read("kernels_per_step.train", ctx) == pytest.approx(4 / 2)
    least = 2 * work.k3_least_seconds(med.config, 2, 128, dx=True)
    assert _read("k3_roofline.train", ctx) == pytest.approx(100 * least / 100e-6)
    least = 2 * work.wgrad_least_seconds(med.config, 2, 128)
    assert _read("k3_wgrad_roofline.train", ctx) == pytest.approx(100 * least / 50e-6)
    assert _read("mfu.train", ctx) == pytest.approx(100 * 100 * 2e12 / (40 * 989e12))


def test_readers_find_nothing_in_an_empty_stretch(tmp_path):
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": [_x("perfbench.stretch", "user_annotation", 0, 100)]}, f)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.Cell(bench, "mednext_s.serve1")
    ctx = _context(path, cell, calls=1, volumes=1, steps=0, forwards=[4, 4], batch=0)
    for m in bench["per_layer"]:
        if m["name"].startswith("mfu"):
            continue
        assert _read(m["name"], ctx) is None, m["name"]
