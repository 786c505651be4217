"""The lower-precision control on the card: the plain reference with fp8
operands, put in the program's place at the cell's own size, fails the
cell's limits. `calibrate.py` takes the same readings over many seeds."""

import os

import pytest
from conftest import ROOT

from perfbench import drive, harness, judge

CELLS = ["micformer.pair_sw8", "mednext_s.serve1", "mednext_s.train_b2"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_is_not_correct(cuda_device, name):
    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), name)
    seed = 2 ** 31 + 17
    if cell.mix["kind"] == "serve":
        pool = drive.serve_pool(cell.config, cell.mix, seed, cuda_device)
        kept = {0: None}
        numbers = judge.serve_numbers(cell.config, cell.mix, seed, pool, kept, cuda_device,
                                      control=True)
    else:
        res = {"batches": drive.train_batches(cell.config, cell.mix, seed, cuda_device),
               "losses": [0.0] * cell.mix["follow_steps"]}
        numbers = judge.train_check(cell.config, cell.mix, seed, res, cuda_device, control=True)
    correct, checks = judge.verdict(numbers, cell.limits)
    assert correct is False, checks
