"""Fixtures of the benchmark's own tests: the repository root on sys.path,
tiny versions of the cells for CPU runs, and the card for the tests marked
`cuda` (decided inside the fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.device("cuda", 0)


def shrink(cell):
    """Cut a cell to a size a CPU run holds in seconds: narrow models, one
    stage deep where the model allows, 32³ tiles of 40³ volumes. The mix's
    other settings and the cell's limits stay."""
    from perfbench.reference import build_reference

    c, m = cell.config, cell.mix
    if c["model"] == "micformer":
        c["kwargs"].update(embed_dim=12, depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8])
    else:
        c["kwargs"]["n_channels"] = c["program_kwargs"]["n_channels"] = 4
    c["parameters"] = sum(p.numel() for p in build_reference(c, device="meta").parameters())
    if m["kind"] == "serve":
        m.update(side=40, roi=32, judge_range=2)
    else:
        m.update(side=32)
    return cell


@pytest.fixture
def tiny_cell():
    from perfbench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    return lambda name: shrink(harness.Cell(bench, name))
