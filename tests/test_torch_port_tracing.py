"""The port's spans (`micformer_tpu_torch/tracing.py`) on the CPU: a tiny
MicFormer and MedNeXt-S served through `build_inference_fn` and one
`Trainer.train_step`, each under `torch.profiler`; the exported Chrome trace
holds the named spans, nested as PERF.md lists them, and one `sw.forward`
a model forward of the benchmark's mix. Without a profiler a span never
enters `record_function`; an export under a running profiler has the same
op nodes and no profiler node."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from micformer_tpu_torch import registry, tracing
from micformer_tpu_torch.convert import aot_export
from micformer_tpu_torch.train.trainer import TrainConfig, Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"micformer": dict(embed_dim=12, depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8]),
        "mednext": dict(n_channels=4)}
# the serving mixes of the benchmark's cells, cut to 40³ volumes and 32³ tiles
MIXES = {"micformer": "pair_sw8", "mednext": "serve1"}
SIDE, ROI = 40, 32
TRAIN_PHASES = ["train.prep", "train.augment", "train.zero_grad", "train.forward", "train.loss",
                "train.backward", "train.readback", "train.optimizer", "train.schedule",
                "train.release"]


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _model(name):
    return registry.build(name, device="cpu", num_classes=8,
                          generator=torch.Generator().manual_seed(0), **TINY[name])


def _mix(name):
    with open(os.path.join(REPO, "perfbench", "traffic", f"{MIXES[name]}.json")) as f:
        return dict(json.load(f), side=SIDE, roi=ROI)


def _traced(fn, path):
    """Run fn under the profiler (CPU); returns the trace's spans as
    (name, start, end) in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        rows = json.load(f)["traceEvents"]
    return sorted(((r["name"], r["ts"], r["ts"] + r["dur"]) for r in rows
                   if r.get("ph") == "X" and r.get("cat") == "user_annotation"),
                  key=lambda s: (s[1], -s[2]))


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _each_inside(spans, name, parent):
    found = _named(spans, name)
    assert found, name
    for s in found:
        assert any(_inside(s, p) for p in _named(spans, parent)), (name, parent)
    return found


def _model_spans(name):
    """(span, parent span) of one forward of the tiny model."""
    if name == "mednext":
        parts = ["mednext.stem", "mednext.bottleneck", "mednext.head"] + [
            f"mednext.{p}{s}" for s in range(4) for p in ("enc", "down", "up", "dec")]
        return [(p, "sw.forward") for p in parts]
    out = [(p, "sw.forward") for p in ("micformer.embed", "micformer.bottleneck",
                                       "micformer.head")]
    for stage in ("enc0", "enc1", "enc2", "enc3", "dec0", "dec1", "dec2", "dec3"):
        pre = f"micformer.{stage}"
        out += [(f"{pre}.self1_0", "sw.forward"), (f"{pre}.self2_0", "sw.forward")]
        for cross in ("cross1_0", "cross2_0"):
            out.append((f"{pre}.{cross}", "sw.forward"))
            out += [(f"{pre}.{cross}.{part}", f"{pre}.{cross}")
                    for part in ("offset", "warp", "attn", "mlp")]
        if stage != "enc3" and stage != "dec3":
            out.append((f"{pre}.resample", "sw.forward"))
        if stage != "dec0" and stage.startswith("dec"):
            out.append((f"{pre}.skip", "sw.forward"))
    return out


@pytest.mark.parametrize("name", ["micformer", "mednext"])
def test_serving_spans_nest_as_listed(tmp_path, name):
    sys.path.insert(0, REPO)
    from perfbench.drive import _chunks

    mix = _mix(name)
    B = mix["volumes_per_call"]
    infer = aot_export.build_inference_fn(
        _model(name).eval(), roi=(ROI,) * 3, num_classes=8, overlap=mix["overlap"],
        sw_batch_size=mix["sw_batch_size"], step_mode="monai", argmax=True)
    x = torch.from_numpy(np.random.default_rng(1).random((B, 2) + (SIDE,) * 3, np.float32))
    got = {}
    with torch.no_grad():
        want = infer(x)
        spans = _traced(lambda: got.setdefault("seg", infer(x)), tmp_path / "trace.json")
    assert torch.equal(got["seg"], want)

    call = _named(spans, "serve.infer")
    assert len(call) == 1
    for part in ("sw.prepare", "sw.gather", "sw.forward", "sw.blend", "sw.normalize",
                 "serve.argmax"):
        _each_inside(spans, part, "serve.infer")
    forwards = _named(spans, "sw.forward")
    assert len(forwards) == len(_chunks(mix, SIDE, B)) > 0
    assert len(_named(spans, "sw.gather")) == len(_named(spans, "sw.blend")) == len(forwards)
    order = [s[0] for s in spans if s[0].startswith(("sw.", "serve.argmax"))]
    assert order == (["sw.prepare"] + ["sw.gather", "sw.forward", "sw.blend"] * len(forwards)
                     + ["sw.normalize", "serve.argmax"])
    for part, parent in _model_spans(name):
        assert len(_each_inside(spans, part, parent)) == len(forwards), part
    # the CPU runs the kernels' plain versions, outside any kernel span
    assert not [s for s in spans if s[0].startswith(("k1.", "k2.", "k3."))]


def test_train_step_spans_nest_as_listed(tmp_path):
    model = _model("mednext")
    cfg = TrainConfig(lr=1e-4, loss="mdice", augment="monai", bf16=True, optimizer="adam",
                      scheduler="cosine", epochs=10, num_classes=8, seed=1,
                      run_dir=str(tmp_path / "run"))
    trainer = Trainer(model, cfg)
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.random((2, 2, 32, 32, 32), np.float32)).half()
    labels = torch.from_numpy(rng.integers(0, 8, (2, 32, 32, 32), np.uint8))
    trainer.train_step(images, labels)
    spans = _traced(lambda: trainer.train_step(images, labels), tmp_path / "trace.json")

    assert len(_named(spans, "train.step")) == 1
    for phase in TRAIN_PHASES:
        assert len(_each_inside(spans, phase, "train.step")) == 1, phase
    # the phases in order, one after the other; no wait on the CPU
    phases = [s for s in spans if s[0] in TRAIN_PHASES]
    assert [s[0] for s in phases] == TRAIN_PHASES
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    assert not _named(spans, "train.wait")
    for part, _ in _model_spans("mednext"):
        assert len(_each_inside(spans, part, "train.forward")) == 1, part


def test_a_span_without_a_profiler_never_enters_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("serve.infer") is tracing.span("train.step")
    with tracing.span("sw.forward"):
        pass
    infer = aot_export.build_inference_fn(_model("micformer").eval(), roi=(ROI,) * 3,
                                          sw_batch_size=4)
    with torch.no_grad():
        seg = infer(torch.zeros(1, 2, SIDE, SIDE, SIDE))
    assert seg.shape == (1, SIDE, SIDE, SIDE) and seg.dtype == torch.uint8


def test_an_export_under_a_running_profiler_has_the_same_op_nodes(tmp_path):
    """torch.export of the serving program while a profiler records: the
    spans stay out of the graph, which holds the op nodes an export without
    a profiler holds (`test_torch_port_export`'s counts for this model)."""
    model = registry.build("micformer", device="cpu", num_classes=8,
                           generator=torch.Generator().manual_seed(3), embed_dim=12,
                           depths=[1, 1], num_heads=[3, 6]).eval()
    with profile(activities=[ProfilerActivity.CPU]):
        meta = aot_export.export_artifact(str(tmp_path), model, target_shape=(32, 32, 40),
                                          roi=(ROI,) * 3, sw_batch_size=2)
    program = torch.export.load(str(tmp_path / meta["programs"]["cpu"]))
    assert aot_export.op_nodes(program) == {"window_attention": 16, "fused_window_attention": 0,
                                            "biased_window_attention": 0, "dw_conv3": 0,
                                            "softmax": 0}
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
