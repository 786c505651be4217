"""Best-configuration search and the ensembling decision.

Counterpart of `micformer_tpu/pipeline/model_selection.py`, a slimmed
nnU-Net model selection (MedNeXt/nnunet_mednext/evaluation/model_selection/
figure_out_what_to_submit.py): given each configuration's cross-validation
summary (`pipeline.evaluator.aggregate_scores`), rank the single
configurations and the pairwise softmax ensembles by mean foreground Dice
and report the winner.
"""

from __future__ import annotations

import itertools

import numpy as np


def mean_fg_dice(agg: dict) -> float:
    """Mean foreground Dice from an aggregate_scores result."""
    means = agg["mean"]
    vals = [m["Dice"] for label, m in means.items() if str(label) != "0"]
    return float(np.mean(vals)) if vals else float("nan")


def find_best_configuration(config_aggregates: dict,
                            ensemble_aggregates: dict | None = None) -> dict:
    """config_aggregates: {name: aggregate_scores result}; optional
    ensemble_aggregates: {(nameA, nameB): aggregate}. Returns a decision dict
    mirroring nnU-Net's figure_out_what_to_submit output shape."""
    scores = {name: mean_fg_dice(a) for name, a in config_aggregates.items()}
    candidates = dict(scores)
    if ensemble_aggregates:
        for pair, agg in ensemble_aggregates.items():
            candidates["+".join(pair)] = mean_fg_dice(agg)
    best = max(candidates, key=lambda k: (np.nan_to_num(candidates[k], nan=-1)))
    return {
        "per_configuration_dice": scores,
        "per_candidate_dice": candidates,
        "best": best,
        "best_dice": candidates[best],
        "is_ensemble": "+" in best,
    }


def candidate_ensembles(names):
    """All unordered pairs, nnU-Net style."""
    return list(itertools.combinations(sorted(names), 2))
