"""The `swinunetr.serve1` cell's pieces: its two span readers on synthetic
profiler traces whose answers are worked out by hand, and a traced run of a
narrow version of the cell on the CPU, whose trace holds the program's
attention-core spans."""

import os
import re

import pytest
import torch
from conftest import ROOT
from test_perfbench_spans import _kernel, _launch, _write, _x
from test_perfbench_trace import _context, _read, synthetic

from perfbench import harness, spans, work
from perfbench.tracing import load_reader

NEW = ["swin_attn_ms.infer", "swin_attn_roofline.infer"]


def _cell():
    return harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                        "swinunetr.serve1")


def serving(path):
    """One call in a stretch of 1000 µs. Under two attention-core spans: a
    gather of 20 µs, a bmm of 60 and a softmax of 40 touching it (the first
    core), a bmm of 80 (the second): 200 µs. Not counted: the qkv GEMM in
    the block's `.attn` span outside the core, a launch of another thread
    inside the core, and a span that only looks like a core."""
    rows = [
        _x("perfbench.stretch", "user_annotation", 0, 1000),
        _x("perfbench.call", "user_annotation", 0, 1000),
        _x("swinunetr.swin0.b0", "user_annotation", 100, 400),
        _x("swinunetr.swin0.b0.attn", "user_annotation", 100, 300),
        _launch(110, 1), _kernel("qkv gemm", 120, 30, 1),
        _x("swinunetr.swin0.b0.attn.core", "user_annotation", 150, 100),
        _launch(155, 2), _kernel("index gather", 160, 20, 2),
        _launch(190, 3), _kernel("bmm", 200, 60, 3),
        _launch(230, 4), _kernel("softmax", 260, 40, 4),
        _launch(240, 9, tid=2), _kernel("other thread", 700, 10, 9),
        _x("swinunetr.swin3.b1.attn.core", "user_annotation", 500, 60),
        _launch(510, 5), _kernel("bmm", 520, 80, 5),
        _x("swinunetr.swin3.b1.attn.core.x", "user_annotation", 800, 60),
        _launch(810, 6), _kernel("copy", 820, 30, 6),
    ]
    _write(path, rows)


def _reads(monkeypatch, path):
    monkeypatch.setattr(spans, "trace_path", lambda ctx: path)
    ctx = _context(path, _cell(), calls=1, volumes=1, steps=0, forwards=[4, 4], batch=0)
    return {name: _read(name, ctx) for name in NEW}


def test_swin_readers_on_a_serving_trace(tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    serving(path)
    got = _reads(monkeypatch, path)
    assert got["swin_attn_ms.infer"] == pytest.approx(0.2)
    # every core call of a 4-tile forward at 128³ is bound by its
    # exponentials: 2·(4000·3 + 500·6 + 108·12 + 32·24)·343² of them
    exps = 2 * (4000 * 3 + 500 * 6 + 108 * 12 + 32 * 24) * 343 ** 2
    least = 2 * exps / 3.9e12
    assert got["swin_attn_roofline.infer"] == pytest.approx(100 * least / 200e-6, rel=1e-12)


@pytest.mark.parametrize("make", [synthetic, None], ids=["no_spans", "empty"])
def test_swin_readers_find_nothing_without_core_spans(tmp_path, monkeypatch, make):
    """A program that records no attention-core spans, as the parent of
    these spans, or an empty stretch: both readers return None, never 0."""
    path = str(tmp_path / "t.json")
    if make is None:
        _write(path, [_x("perfbench.stretch", "user_annotation", 0, 100)])
    else:
        make(path)
    assert _reads(monkeypatch, path) == dict.fromkeys(NEW)


def test_core_shapes_come_from_the_reference():
    cell = _cell()
    reader = load_reader(os.path.join(ROOT, "perfbench", "metrics"), "swin_attn_roofline.infer")
    calls = work._reference_calls(cell.config, 4, 128, reader.__globals__["_swin_cores"],
                                  reader.__globals__["_shape"])
    assert calls == [(4000, 3, 343, 16)] * 2 + [(500, 6, 343, 16)] * 2 + [
        (108, 12, 343, 16)] * 2 + [(32, 24, 343, 16)] * 2


def test_a_traced_run_on_the_cpu_holds_the_core_spans(monkeypatch):
    """harness.run_cell with a trace on the CPU at feature size 12, 32³
    tiles of 40³ volumes: the trace holds 8 attention-core spans a forward;
    no device operation runs, so both readers find nothing to read."""
    from perfbench import drive

    seen = {}

    class FirstCall(drive.Trace):
        def __init__(self, calls, after, path):
            super().__init__(1, 0.0, path)

        warm = staticmethod(lambda device: None)

        def export(self):
            ok = super().export()
            seen["cores"] = len(spans.load(self.path).named(re.compile(r"\.attn\.core$")))
            return ok

    monkeypatch.setattr(drive, "Trace", FirstCall)
    cell = _cell()
    cell.config["kwargs"].update(feature_size=12, input_size=32)
    from perfbench.reference import build_reference

    cell.config["parameters"] = sum(
        p.numel() for p in build_reference(cell.config, device="meta").parameters())
    cell.mix.update(side=40, roi=32, judge_range=2)
    out = harness.run_cell(cell, 2 ** 31 + 5, 0.5, True, torch.device("cpu"), lambda: 0.0)
    assert seen["cores"] == 8 * len(drive._chunks(cell.mix, 40, 1))
    assert not set(NEW) & set(out["metrics"])
    assert out["correct"] is True
