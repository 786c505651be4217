#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, at the cell's own
size on the card, many seeds in one process (set-up is paid once):

- `program`: the program's numbers on each seed (a short window of the cell,
  judged as a run judges it);
- `control`: the plain reference computed with fp8 operands, put in the
  program's place, on the first `--control` seeds;
- `half_batch` (training cells): the program with half of each batch left
  out of the loss (the mean taken over the rest), on the first `--control`
  seeds.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 3]
        [--seconds 8]

Prints one JSON line per reading and the extremes of each kind last.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def half_batch(trainer):
    """A fault: the loss over the first half of each batch only."""
    loss = trainer.loss

    def half(out, labels):
        h = max(1, labels.shape[0] // 2)
        return loss(out[:h], labels[:h])

    trainer.loss = half


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=8.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import drive, harness, judge

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    # every number a run reads, with no limit, so each is printed
    names = (("seg_gap", "seg_gap_max", "seg_disagree") if cell.mix["kind"] == "serve"
             else ("loss_gap", "grad_gap", "change_gap", "grad_gap_median",
                   "change_gap_median"))
    cell.limits = dict.fromkeys(names, float("inf"))
    seeds = [int(s) for s in args.seeds.split(",")]
    readings = {"program": [], "control": [], "half_batch": []}

    def emit(kind, seed, numbers):
        readings[kind].append(numbers)
        print(json.dumps({"kind": kind, "seed": seed, **numbers}), flush=True)

    for i, seed in enumerate(seeds):
        t0 = time.time()
        out = harness.run_cell(cell, seed, args.seconds, False, device, lambda: 0.0)
        emit("program", seed, {k: c["value"] for k, c in out["checks"].items()})
        if i >= args.control:
            continue
        if cell.mix["kind"] == "serve":
            pool = drive.serve_pool(cell.config, cell.mix, seed, device)
            kept = {j: None for j in range(cell.mix["judge_calls"])}
            emit("control", seed, judge.serve_numbers(cell.config, cell.mix, seed, pool, kept,
                                                      device, control=True))
        else:
            res = {"batches": drive.train_batches(cell.config, cell.mix, seed, device),
                   "losses": [0.0] * cell.mix["follow_steps"]}
            emit("control", seed, judge.train_check(cell.config, cell.mix, seed, res, device,
                                                    control=True))
            out = harness.run_cell(cell, seed, 1.0, False, device, lambda: 0.0,
                                   fault=half_batch)
            emit("half_batch", seed, {k: c["value"] for k, c in out["checks"].items()})
        print(f"calibrate: seed {seed} took {time.time() - t0:.1f} s", file=sys.stderr)
    summary = {kind: {k: [min(r[k] for r in rows), max(r[k] for r in rows)] for k in rows[0]
                      if not isinstance(rows[0][k], str)}
               for kind, rows in readings.items() if rows}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
