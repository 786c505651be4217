"""What the benchmark loads: a whole run of a tiny cell on the CPU, and the
reference alone, each in a fresh interpreter."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "micformer_tpu"}

RUN = """
import json, os, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, os.path.join({root!r}, "perfbench", "tests"))
import torch
from conftest import shrink
from perfbench import harness
import perfbench.run  # noqa: F401
bench = harness.load_json(os.path.join({root!r}, "BENCHMARK.json"))
out = harness.run_cell(shrink(harness.Cell(bench, "micformer.pair_sw8")), 5, 0.5, False,
                       torch.device("cpu"), lambda: 0.0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.micformer, perfbench.reference.mednext, perfbench.work
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    proc = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    loaded = _modules(RUN)
    assert "micformer_tpu_torch" in loaded          # the program ran
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules(REFERENCE)
    assert not loaded & (FORBIDDEN | {"micformer_tpu_torch"})
