"""The port's SwinUNETR against the benchmark's plain reference
(`perfbench/reference/swinunetr.py`) on the CPU: forwards on seeded random
weights as the benchmark draws them, the strict state_dict load both ways,
the published configuration's parameter count, and the model's spans under
`torch.profiler` (MicFormer, which builds the same Swin classes, keeps its
own)."""

import json
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from micformer_tpu_torch import registry
from micformer_tpu_torch.kernels import ATTENTION_PATHS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench import drive  # noqa: E402
from perfbench.reference import build_reference  # noqa: E402

with open(os.path.join(REPO, "perfbench", "configs", "swinunetr.json")) as f:
    PUBLISHED = json.load(f)


def _config(input_size):
    """The published configuration at feature size 12 and `input_size`,
    with `parameters` its reference's count."""
    config = {**PUBLISHED, "kwargs": {**PUBLISHED["kwargs"], "feature_size": 12,
                                      "input_size": input_size}}
    model = build_reference(config, device="meta")
    return {**config, "parameters": sum(p.numel() for p in model.parameters())}


def _pair(config, seed, dtype=torch.float32):
    dev = torch.device("cpu")
    state = drive.weights(config, seed, dev)
    program = drive.program_model(config, dtype, dev, state).eval()
    reference = build_reference(config, dev)
    reference.load_state_dict(state)
    return program, reference


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# 32: grids 16-8-4-2, stages 0 and 1 pad their shifted windows (16 -> 21,
# 8 -> 14), stages 2 and 3 clamp theirs (no shift); 64: grids 32-16-8-4,
# stages 0-2 pad (32 -> 35, 16 -> 21, 8 -> 14), stage 3 clamps
@pytest.mark.parametrize("size", [32, 64])
def test_the_program_matches_the_reference(size):
    program, reference = _pair(_config(size), 11)
    x = torch.rand((1, 2, size, size, size), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got, want = program(x), reference(x)
    assert got.shape == want.shape == (1, 8, size, size, size)
    # f32 on both sides: the order of sums alone differs
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_a_bf16_program_fails_the_tolerance():
    program, reference = _pair(_config(32), 11, torch.bfloat16)
    x = torch.rand((1, 2, 32, 32, 32), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got, want = program(x), reference(x)
    assert (got - want).abs().max().item() > 1e-5 * want.abs().max().item()


def test_the_state_dict_loads_strictly_both_ways():
    program, reference = _pair(_config(32), 12)
    fresh = build_reference(_config(32), "cpu")
    fresh.load_state_dict(program.state_dict())
    program.load_state_dict(reference.state_dict())
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in reference.state_dict().items())


def test_the_published_configuration_counts_its_parameters():
    # 62,201,834 on both sides, each built on the meta device
    reference = build_reference(PUBLISHED, device="meta")
    with torch.device("meta"):
        program = registry.build("swinunetr", device="meta", **PUBLISHED["kwargs"])
    count = PUBLISHED["parameters"]
    assert count == 62_201_834
    assert sum(p.numel() for p in reference.parameters()) == count
    assert sum(p.numel() for p in program.parameters()) == count
    assert set(dict(program.named_parameters())) == set(dict(reference.named_parameters()))


def _spans(model, x):
    """The user spans of one profiled forward, as (name, start, end)."""
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x)
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(("swinunetr.", "micformer.", "mednext."))]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_a_profiled_forward_holds_the_spans_as_listed():
    program, _ = _pair(_config(32), 13)
    x = torch.rand((1, 2, 32, 32, 32), generator=torch.Generator().manual_seed(4))
    before = ATTENTION_PATHS["matmul"]
    spans = _spans(program, x)
    assert ATTENTION_PATHS["matmul"] - before == 8
    names = [s[0] for s in spans]
    blocks = [f"swinunetr.swin{i}.b{b}" for i in range(4) for b in range(2)]
    parts = (["swinunetr.embed", "swinunetr.out"] + [f"swinunetr.merge{i}" for i in range(4)]
             + [f"swinunetr.encoder{k}" for k in (1, 2, 3, 4, 10)]
             + [f"swinunetr.decoder{k}" for k in (5, 4, 3, 2, 1)])
    want = parts + [f"{b}{p}" for b in blocks for p in ("", ".attn", ".mlp", ".attn.core")]
    assert sorted(names) == sorted(want)
    got = {s[0]: s for s in spans}
    for b in blocks:
        assert _inside(got[f"{b}.attn"], got[b]) and _inside(got[f"{b}.mlp"], got[b])
        assert _inside(got[f"{b}.attn.core"], got[f"{b}.attn"])
        assert got[f"{b}.attn"][2] <= got[f"{b}.mlp"][1]


def test_micformer_keeps_its_spans():
    from test_torch_port_tracing import _model_spans

    model = registry.build("micformer", device="cpu", num_classes=8, embed_dim=12,
                           depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8],
                           generator=torch.Generator().manual_seed(0)).eval()
    names = {s[0] for s in _spans(model, torch.rand((1, 2, 32, 32, 32)))}
    assert names == {name for name, _ in _model_spans("micformer")}
