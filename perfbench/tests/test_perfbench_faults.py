"""A run driven on the CPU with a fault planted under the timed path comes
out not correct: an answer altered where it is produced (serving), a step
that leaves the state unchanged and a loss over half the batch (training).
The cells are cut to a tiny size (conftest.shrink); their limits stay."""

import torch

from perfbench import harness
from perfbench.calibrate import half_batch

CPU = torch.device("cpu")


def _run(cell, fault=None, seed=2 ** 31 + 3):
    return harness.run_cell(cell, seed, 0.5, False, CPU, lambda: 0.0, fault=fault)


def altered_answer(infer):
    """The serving program with one octant of each map (a tile's worth)
    given the next class, as a blending or tiling fault would leave it."""
    def wrapped(volume):
        seg = infer(volume).clone()
        d, h, w = (n // 2 for n in seg.shape[1:])
        seg[:, :d, :h, :w] = (seg[:, :d, :h, :w] + 1) % 8
        return seg

    return wrapped


def frozen_step(trainer):
    """The optimizer's step does nothing: the state stays as it was."""
    trainer.optimizer.step = lambda *a, **k: None


def test_serving_fault_is_not_correct(tiny_cell):
    for name in ("micformer.pair_sw8", "mednext_s.serve1"):
        out = _run(tiny_cell(name), altered_answer)
        assert out["correct"] is False, (name, out["checks"])


def test_training_faults_are_not_correct(tiny_cell):
    for fault in (frozen_step, half_batch):
        out = _run(tiny_cell("mednext_s.train_b2"), fault)
        assert out["correct"] is False, (fault.__name__, out["checks"])
