"""The span readers (`perfbench/spans.py` and the metrics that read the
program's spans) on synthetic profiler traces whose answers are worked out
by hand; the existing readers and the breakdown read what they read before
the spans came; a traced run on the CPU finds its trace and its spans."""

import json
import os

import pytest
import torch
from conftest import ROOT
from test_perfbench_trace import _context, _read, synthetic

from perfbench import harness, spans, tracing, work

K1 = "void window_attention_kernel<__nv_bfloat16>(__nv_bfloat16 const*)"
NEW = ["dispatch_ms.host_paced", "k1_host_ms.host_paced", "window_device_ms.infer",
       "augment_ms.train", "loop_idle_ms.train"]


def _x(name, cat, ts, dur, tid=1, corr=None):
    row = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
    if corr is not None:
        row["args"] = {"correlation": corr}
    return row


def _launch(ts, corr, tid=1):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 3, tid, corr)


def _kernel(name, ts, dur, corr):
    return _x(name, "kernel", ts, dur, 7, corr)


def _write(path, rows):
    with open(path, "w") as f:
        json.dump({"traceEvents": rows}, f)


def serving(path):
    """One call in a stretch of 1000 µs. Device work launched under the
    window's spans: a pageable copy of 20 µs and a fill of 10 (sw.prepare),
    a cat of 20 (sw.gather), two blends of 40 and 10 (sw.blend), a divide of
    20 (sw.normalize), an argmax of 20 (serve.argmax): 140 µs. Not counted:
    the model's kernels (sw.forward), a copy launched in serve.infer alone,
    a launch of another thread inside sw.blend. sw.forward holds 600 µs of
    host time, K1's wrapper spans 60 + 30; a sw.forward after the stretch
    is outside it."""
    rows = [
        _x("perfbench.stretch", "user_annotation", 0, 1000),
        _x("perfbench.call", "user_annotation", 0, 1000),
        _x("serve.infer", "user_annotation", 10, 980),
        _x("sw.prepare", "user_annotation", 10, 50),
        _x("cudaMemcpyAsync", "cuda_runtime", 20, 30, 1, 1),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 25, 20, 7, 1),
        _launch(52, 2), _kernel("fill", 55, 10, 2),
        _x("sw.gather", "user_annotation", 60, 40),
        _launch(70, 3), _kernel("cat", 100, 20, 3),
        _x("sw.forward", "user_annotation", 100, 600),
        _launch(110, 4), _kernel("conv", 130, 200, 4),
        _x("micformer_tpu_torch::window_attention", "cpu_op", 360, 70),
        _x("k1.forward.mma", "user_annotation", 365, 60),
        _launch(400, 5), _kernel(K1, 420, 100, 5),
        _x("k1.forward.mma", "user_annotation", 600, 30),
        _launch(620, 6), _kernel(K1, 640, 10, 6),
        _x("sw.blend", "user_annotation", 700, 100),
        _launch(710, 7), _kernel("add", 720, 40, 7),
        _launch(715, 12, tid=2), _kernel("other thread", 940, 10, 12),
        _launch(750, 8), _kernel("add", 780, 10, 8),
        _x("sw.normalize", "user_annotation", 800, 50),
        _launch(810, 9), _kernel("div", 850, 20, 9),
        _x("serve.argmax", "user_annotation", 850, 50),
        _launch(860, 10), _kernel("argmax", 880, 20, 10),
        _x("cudaMemcpyAsync", "cuda_runtime", 905, 30, 1, 11),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 910, 20, 7, 11),
        _x("sw.forward", "user_annotation", 1100, 50),
    ]
    _write(path, rows)


def training(path):
    """Two steps in a stretch of 1000 µs. Forward spans [100, 300] and
    [600, 800], backward [300, 400] and [800, 900]; device busy over [20, 60]
    (prep), [70, 90] and [560, 590] (augmentation), [120, 380] and [620, 880]
    (the model), [410, 450] (Adam) and [910, 950]. Idle outside the forward
    and the backward: 310 µs idle less [100, 120], [380, 400], [600, 620]
    and [880, 900] = 230 µs, 115 a step. Augmentation: 20 + 30 µs, 25 a
    step; a kernel launched by another thread inside train.augment is not
    counted."""
    rows = [
        _x("perfbench.stretch", "user_annotation", 0, 1000),
        _x("train.step", "user_annotation", 0, 480),
        _x("train.prep", "user_annotation", 0, 60),
        _launch(10, 21), _x("copy", "gpu_memcpy", 20, 40, 7, 21),
        _x("train.augment", "user_annotation", 60, 35),
        _launch(62, 22), _kernel("affine", 70, 20, 22),
        _launch(64, 29, tid=2), _kernel("other thread", 910, 40, 29),
        _x("train.forward", "user_annotation", 100, 200),
        _launch(110, 24), _kernel("conv", 120, 260, 24),
        _x("train.backward", "user_annotation", 300, 100),
        _x("train.readback", "user_annotation", 400, 3),
        _x("aten::item", "cpu_op", 400.5, 2),
        _x("train.optimizer", "user_annotation", 403, 57),
        _launch(405, 27), _kernel("adam", 410, 40, 27),
        _x("train.step", "user_annotation", 500, 480),
        _x("train.augment", "user_annotation", 540, 55),
        _launch(545, 32), _kernel("affine", 560, 30, 32),
        _x("train.forward", "user_annotation", 600, 200),
        _launch(610, 34), _kernel("conv", 620, 260, 34),
        _x("train.backward", "user_annotation", 800, 100),
    ]
    _write(path, rows)


def _cells():
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    return bench, {n: harness.Cell(bench, n) for n in
                   ("micformer.pair_sw8", "mednext_s.serve1", "mednext_s.train_b2")}


def _reads(monkeypatch, path, cell, **kw):
    monkeypatch.setattr(spans, "trace_path", lambda ctx: path)
    ctx = _context(path, cell, **kw)
    return {name: _read(name, ctx) for name in NEW}


def test_span_readers_on_a_serving_trace(tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    serving(path)
    _, cells = _cells()
    got = _reads(monkeypatch, path, cells["micformer.pair_sw8"], calls=1, volumes=2, steps=0,
                 forwards=[16], batch=0)
    assert got["dispatch_ms.host_paced"] == pytest.approx(0.6)
    assert got["k1_host_ms.host_paced"] == pytest.approx(0.09)
    assert got["window_device_ms.infer"] == pytest.approx(0.14)
    assert got["augment_ms.train"] is None and got["loop_idle_ms.train"] is None
    # the breakdown names the gaps after the spans that hold them: [65, 100]
    # in sw.gather, [760, 780] in sw.blend, [330, 420] in K1's wrapper span
    # (inside its op), and none after no host op
    device, host, (lo, hi) = tracing.load_trace(path)
    gaps = dict(tracing.idle_gaps(device, host, lo, hi, top=20))
    assert gaps["sw.gather"] == pytest.approx(35e-6)
    assert gaps["sw.blend"] == pytest.approx(20e-6)
    assert gaps["k1.forward.mma"] == pytest.approx(90e-6)
    assert "no host op" not in gaps


def test_span_readers_on_a_training_trace(tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    training(path)
    _, cells = _cells()
    got = _reads(monkeypatch, path, cells["mednext_s.train_b2"], calls=2, volumes=0, steps=2,
                 forwards=[], batch=2)
    assert got["augment_ms.train"] == pytest.approx(0.025)
    assert got["loop_idle_ms.train"] == pytest.approx(0.115)
    for name in ("dispatch_ms.host_paced", "k1_host_ms.host_paced", "window_device_ms.infer"):
        assert got[name] is None, name
    st = spans.load(path)
    assert spans.seconds(st.named("train.forward")) == pytest.approx(400e-6)
    assert [(e.ts, e.end) for e in st.launched_under(st.named("train.augment"))] == [
        (70, 90), (560, 590)]
    # every gap is named after a span: [0, 20] prep, [60, 70] augment,
    # [90, 120] and [590, 620] forward, [380, 410] and [880, 910] backward,
    # [450, 560] and [950, 1000] the second step's
    device, host, (lo, hi) = tracing.load_trace(path)
    assert dict(tracing.idle_gaps(device, host, lo, hi, top=20)) == pytest.approx(
        {"train.step": 160e-6, "train.forward": 60e-6, "train.backward": 60e-6,
         "train.prep": 20e-6, "train.augment": 10e-6})


@pytest.mark.parametrize("make", [synthetic, None], ids=["no_spans", "empty"])
def test_span_readers_find_nothing_without_spans(tmp_path, monkeypatch, make):
    """A program that records no spans (the trace of the existing synthetic
    test), or an empty stretch: every span reader returns None, never 0."""
    path = str(tmp_path / "t.json")
    if make is None:
        _write(path, [_x("perfbench.stretch", "user_annotation", 0, 100)])
    else:
        make(path)
    _, cells = _cells()
    for name, cell, kw in (
            ("micformer.pair_sw8", cells["micformer.pair_sw8"],
             dict(calls=2, volumes=4, steps=0, forwards=[16], batch=0)),
            ("mednext_s.train_b2", cells["mednext_s.train_b2"],
             dict(calls=2, volumes=0, steps=2, forwards=[], batch=2))):
        assert _reads(monkeypatch, path, cell, **kw) == dict.fromkeys(NEW), name


def test_span_readers_outside_a_run_find_no_trace(tmp_path):
    """Called with a context that no `harness.run_cell` reads, a reader
    finds no trace file and returns None."""
    path = str(tmp_path / "t.json")
    serving(path)
    _, cells = _cells()
    ctx = _context(path, cells["micformer.pair_sw8"], calls=1, volumes=2, steps=0,
                   forwards=[16], batch=0)
    assert spans.trace_path(ctx) is None
    assert {name: _read(name, ctx) for name in NEW} == dict.fromkeys(NEW)


# what each existing reader and the breakdown read on the existing synthetic
# trace before the program's spans and their readers came
GOLDEN = {
    "micformer.pair_sw8": {"device_idle.host_paced": 50.0, "mfu.host_paced": 4.044489383215369,
                           "kernels_per_volume.host_paced": 1.0,
                           "k1_roofline.infer": 1397.2666459701493},
    "mednext_s.serve1": {"device_idle.infer": 50.0, "mfu.infer": 2.0222446916076846,
                         "kernels_per_volume.infer": 2.0, "k3_roofline.infer": 6821.261984477613},
    "mednext_s.train_b2": {"device_idle.train": 50.0, "mfu.train": 0.5055611729019212,
                           "kernels_per_step.train": 2.0, "k3_roofline.train": 3410.7259032835827,
                           "k3_wgrad_roofline.train": 3410.926271044776,
                           # no up-conv wgrad kernel in the synthetic trace
                           "dwt2_wgrad_roofline.train": None},
}
CONTEXTS = {"micformer.pair_sw8": dict(calls=2, volumes=4, steps=0, forwards=[16], batch=0),
            "mednext_s.serve1": dict(calls=2, volumes=2, steps=0, forwards=[4, 4], batch=0),
            "mednext_s.train_b2": dict(calls=2, volumes=0, steps=2, forwards=[], batch=2)}


def test_existing_readers_and_breakdown_read_as_before(tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    synthetic(path)
    monkeypatch.setattr(work, "model_flops", lambda config, b, roi, train=False: 1e12 * b)
    _, cells = _cells()
    for name, want in GOLDEN.items():
        ctx = _context(path, cells[name], **CONTEXTS[name])
        got = {m["name"]: _read(m["name"], ctx) for m in cells[name].per_layer
               if m["name"] not in NEW}
        assert got == pytest.approx(want, rel=1e-12), name
    device, host, (lo, hi) = tracing.load_trace(path)
    assert tracing.busy_seconds(device, lo, hi) == pytest.approx(5e-4, rel=1e-12)
    gaps = tracing.idle_gaps(device, host, lo, hi)
    assert [n for n, _ in gaps] == ["perfbench.call", "aten::layer_norm", "aten::to"]
    assert [s for _, s in gaps] == pytest.approx([3e-4, 1e-4, 1e-4], rel=1e-12)
    assert [n for n, _ in tracing.device_ops(device)] == [
        K1, "void fused_window_attention_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
        "void dw_conv3_tile_kernel<3, __nv_bfloat16>(CUtensorMap)",
        "Memcpy DtoH (Device -> Pageable)",
        "void dw_conv3_wgrad_volume_kernel<3, __nv_bfloat16>(CUtensorMap)"]
    assert [s for _, s in tracing.device_ops(device)] == pytest.approx(
        [2e-4, 1.5e-4, 1e-4, 5e-5, 5e-5], rel=1e-12)


def test_a_traced_run_on_the_cpu_reads_its_spans(tiny_cell, monkeypatch):
    """harness.run_cell with a trace on the CPU: the readers find the run's
    trace file and its spans. No device operation runs, so the device's
    metrics and the window's device time find nothing; the host's
    dispatch into sw.forward reads a number. (The profiler's warm start
    synchronises a card, so it is left out here; the trace takes the first
    call, so the run holds it however slow the host.)"""
    from perfbench import drive

    class FirstCall(drive.Trace):
        def __init__(self, calls, after, path):
            super().__init__(1, 0.0, path)

        warm = staticmethod(lambda device: None)

    monkeypatch.setattr(drive, "Trace", FirstCall)
    cell = tiny_cell("micformer.pair_sw8")
    out = harness.run_cell(cell, 2 ** 31 + 5, 0.5, True, torch.device("cpu"), lambda: 0.0)
    metrics = out["metrics"]
    assert metrics["dispatch_ms.host_paced"]["value"] > 0
    assert metrics["dispatch_ms.host_paced"]["unit"] == "ms"
    assert "k1_host_ms.host_paced" not in metrics          # the CPU runs K1's plain version
    assert "device_idle.host_paced" not in metrics
    assert out["correct"] is True
