"""The comparison that decides `correct`: what the timed path produced, held
against the plain f32 reference on the same seeded weights and inputs.

- Serving: for each sampled call, every voxel of the program's uint8 map is
  read against the reference's blended f32 logits of the same volume: its
  gap is how far the logit of the class the program chose lies below the
  reference's best, in units of the std of that volume's reference logits
  (a served token's gap, voxel by voxel). Per volume: `seg_gap` the mean
  gap, `seg_gap_max` the widest, `seg_disagree` the share of voxels with a
  gap; a cell's limits file names the ones it compares.
- Training: the reference follows the program's first steps from the same
  weights, batches and augmentation draws. `loss_gap` is the largest
  relative gap of a step's loss; `grad_gap` the worst leaf's gap between the
  norms of the first gradient (the program's as Adam received it), over the
  larger of that leaf's reference norm and the median leaf's; `change_gap`
  the same for the parameters' change over the followed steps;
  `grad_gap_median` and `change_gap_median` the median leaf's gaps, steady
  where the worst leaf's swing with the round-off of one large reduction
  (the stem's and the first stage's weight gradients over every voxel).
  All read only the leaves whose reference gradient is at least a
  thousandth of the median leaf's: the others, such as a bias ahead of a
  norm, have a gradient that is nought but for round-off, and move by
  round-off alone.

The reference runs once the window has closed and the program's state is
freed, in blocks of tiles. The lower-precision control is the same
reference with its matmul and conv operands rounded to fp8, put in the
program's place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.drive import weights
from perfbench.reference import build_reference
from perfbench.reference.common import (
    Adam, augment, cosine_lr, draw_augment, mdice_loss, strict_f32, tiled_logits,
)

# leaves whose reference gradient is under this share of the median leaf's
# are left out of grad_gap and change_gap
MOVED = 1e-3


def reference_model(config: dict, seed: int, device, fp8: bool = False):
    model = build_reference(config, device=device, fp8=fp8)
    model.load_state_dict(weights(config, seed, device))
    return model


# -- serving -------------------------------------------------------------------

def volume_gaps(logits: torch.Tensor, seg: torch.Tensor) -> dict:
    """Per volume of logits [B, K, ...] and labels seg [B, ...]: each voxel's
    gap, the reference's best logit less the logit of the class seg chose,
    over the std of that volume's reference logits; {"seg_gap": [B] mean
    gap, "seg_gap_max": [B] widest gap, "seg_disagree": [B] share of voxels
    whose label is not the reference's best}."""
    best = logits.amax(1)
    chosen = logits.gather(1, seg.long().unsqueeze(1)).squeeze(1)
    gap = (best - chosen).flatten(1) / logits.flatten(1).std(1, keepdim=True)
    return {"seg_gap": gap.mean(1), "seg_gap_max": gap.amax(1),
            "seg_disagree": (gap > 0).float().mean(1)}


def serve_numbers(config: dict, mix: dict, seed: int, pool: list, kept: dict, device,
                  control: bool = False) -> dict:
    """The worst volume's readings (`volume_gaps`) over the kept calls'
    maps (control: over the fp8 reference's argmax in the program's place),
    each distinct input run through the reference once."""
    K = config["kwargs"]["num_classes"]
    worst = {"seg_gap": 0.0, "seg_gap_max": 0.0, "seg_disagree": 0.0}
    with strict_f32():
        ref = reference_model(config, seed, device)
        low = reference_model(config, seed, device, fp8=True) if control else None
        for j in sorted({i % len(pool) for i in kept}):
            vol = torch.from_numpy(pool[j]).to(device)
            logits = tiled_logits(ref, vol, mix["roi"], mix["overlap"], K)
            if control:
                segs = [tiled_logits(low, vol, mix["roi"], mix["overlap"], K).argmax(1)]
            else:
                segs = [torch.from_numpy(out).to(device) for i, out in kept.items()
                        if i % len(pool) == j]
            for seg in segs:
                if seg.shape != logits[:, 0].shape:
                    return {k: float("inf") for k in worst}
                for k, v in volume_gaps(logits, seg).items():
                    worst[k] = max(worst[k], v.max().item())
            del logits, vol
    return worst


# -- training ------------------------------------------------------------------

def train_readings(config: dict, mix: dict, seed: int, batches: list, steps: int, device,
                   fp8: bool = False) -> dict:
    """The reference's first `steps` training steps from the cell's weights:
    {"losses", "grad1" (the first step's gradients), "after" (the
    parameters after the last step)}. The augmentation draws come from the
    program trainer's stream, seeded with the run's seed + 1."""
    model = reference_model(config, seed, device, fp8=fp8).train()
    params = dict(model.named_parameters())
    opt = Adam({n: p.data for n, p in params.items()})
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    K = config["kwargs"]["num_classes"]
    losses, grad1 = [], {}
    with strict_f32():
        for t in range(steps):
            images, labels = batches[t % len(batches)]
            x = images.to(device).float()
            y = F.one_hot(labels.to(device).long(), K).movedim(-1, 1).float()
            x, y = augment(x, y, draw_augment(gen, x.shape[0]))
            loss = mdice_loss(model(x), y)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            if t == 0:
                grad1 = {n: g.detach().clone() for n, g in grads.items()}
            opt.update(grads, cosine_lr(mix["lr"], t, mix["epochs"]))
            losses.append(loss.item())
    return {"losses": losses, "grad1": grad1,
            "after": {n: p.detach().clone() for n, p in params.items()}}


def _norms(tensors: dict, device) -> dict:
    return {n: torch.linalg.vector_norm(t.to(device).double()).item() for n, t in tensors.items()}


def train_numbers(got: dict, ref: dict, start: dict, device) -> dict:
    """{"loss_gap", "grad_gap", "change_gap", "grad_gap_median",
    "change_gap_median"} of readings `got` against the reference's `ref`,
    both from the parameters `start`; the `_median` numbers are the median
    leaf's gap rather than the worst's. "grad_leaf" and "change_leaf" name
    the worst leaves."""
    names = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median", "change_gap_median")
    if len(got["losses"]) != len(ref["losses"]) or set(got["grad1"]) != set(ref["grad1"]):
        return dict.fromkeys(names, float("inf"))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    g_ref, g_got = _norms(ref["grad1"], device), _norms(got["grad1"], device)
    g_med = float(np.median(list(g_ref.values())))
    moved = [n for n in g_ref if g_ref[n] >= MOVED * g_med]
    grad = {n: abs(g_got[n] - g_ref[n]) / max(g_ref[n], g_med) for n in moved}
    d_ref = _norms({n: ref["after"][n].to(device) - start[n] for n in moved}, device)
    d_got = _norms({n: got["after"][n].to(device) - start[n] for n in moved}, device)
    d_med = float(np.median(list(d_ref.values())))
    change = {n: abs(d_got[n] - d_ref[n]) / max(d_ref[n], d_med) for n in moved}
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap_median": float(np.median(list(change.values()))),
            "grad_leaf": max(grad, key=grad.get), "change_leaf": max(change, key=change.get)}


def train_check(config: dict, mix: dict, seed: int, res: dict, device,
                control: bool = False) -> dict:
    """The training cell's numbers for a run's readings `res` (control: for
    the fp8 reference's readings in the program's place)."""
    steps = len(res["losses"])
    ref = train_readings(config, mix, seed, res["batches"], steps, device)
    got = (train_readings(config, mix, seed, res["batches"], steps, device, fp8=True)
           if control else res)
    return train_numbers(got, ref, weights(config, seed, device), device)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: each at most its limit; a number that is not finite fails."""
    checks = {n: {"value": numbers[n], "limit": lim} for n, lim in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return bool(ok), checks
