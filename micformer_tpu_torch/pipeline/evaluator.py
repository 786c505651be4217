"""Segmentation evaluator: per-case metrics, their aggregation to JSON, and
region-based evaluation.

The port's own copy of `micformer_tpu/pipeline/evaluator.py` (nnU-Net's
`Evaluator` / `aggregate_scores`, its normalized surface Dice, and its
region-based evaluation with the summary_<measure>.csv layout): per (case,
class) Dice, IoU, precision, recall, tp/fp/fn/tn, HD95, mean surface
distance and normalized surface Dice; means over cases. Host code on numpy
label maps (metric definitions in `losses/metrics.py`).
"""

from __future__ import annotations

import json
import os

import numpy as np

from micformer_tpu_torch.losses.metrics import _hd95_of, _surface_distances


def normalized_surface_dice(a: np.ndarray, b: np.ndarray, threshold: float,
                            spacing=None) -> float:
    """Symmetric normalized surface Dice at `threshold` mm
    (surface_dice.py:20-57): fractions of each mask's surface voxels lying
    within `threshold` of the other's surface, combined Dice-style with the
    reference's 1e-8 guard. nan when either mask is empty."""
    a = np.asarray(a).astype(bool)
    b = np.asarray(b).astype(bool)
    if not a.any() or not b.any():
        return float("nan")
    return _nsd_of(_surface_distances(a, b, spacing), _surface_distances(b, a, spacing),
                   threshold)


def _nsd_of(a_to_b: np.ndarray, b_to_a: np.ndarray, threshold: float) -> float:
    """Normalized surface Dice of the two directed surface-distance sets."""
    tp_a = float(np.sum(a_to_b <= threshold)) / len(a_to_b)
    tp_b = float(np.sum(b_to_a <= threshold)) / len(b_to_a)
    fp = float(np.sum(a_to_b > threshold)) / len(a_to_b)
    fn = float(np.sum(b_to_a > threshold)) / len(b_to_a)
    return float((tp_a + tp_b) / (tp_a + tp_b + fp + fn + 1e-8))


def evaluate_case(pred: np.ndarray, gt: np.ndarray, labels, spacing=None,
                  nsd_tolerance_mm: float = 1.0) -> dict:
    """Metrics per class for one integer label map pair."""
    out = {}
    for l in labels:
        p, g = pred == l, gt == l
        tp = float(np.logical_and(p, g).sum())
        fp = float(np.logical_and(p, ~g).sum())
        fn = float(np.logical_and(~p, g).sum())
        tn = float(np.logical_and(~p, ~g).sum())
        denom = 2 * tp + fp + fn
        m = {
            "Dice": 1.0 if denom == 0 else 2 * tp / denom,
            "Jaccard": 1.0 if (tp + fp + fn) == 0 else tp / (tp + fp + fn),
            "Precision": 0.0 if (tp + fp) == 0 else tp / (tp + fp),
            "Recall": 0.0 if (tp + fn) == 0 else tp / (tp + fn),
            "True Positives": tp, "False Positives": fp,
            "False Negatives": fn, "True Negatives": tn,
        }
        if p.any() and g.any():
            # one pair of surface-distance sets serves the three metrics
            d_pg = _surface_distances(p, g, spacing)
            d_gp = _surface_distances(g, p, spacing)
            m["Hausdorff Distance 95"] = _hd95_of(d_pg, d_gp)
            m["Avg. Surface Distance"] = float((d_pg.mean() + d_gp.mean()) / 2)
            m["Normalized Surface Dice"] = _nsd_of(d_pg, d_gp, nsd_tolerance_mm)
        else:
            m["Hausdorff Distance 95"] = float("nan")
            m["Avg. Surface Distance"] = float("nan")
            m["Normalized Surface Dice"] = float("nan")
        out[str(int(l))] = m
    return out


# MM-WHS cardiac structures in stored-class order (labels 1..7 after one-hot,
# image_utils.MMWHS_LABEL_VALUES order: 205 myo, 420 LA, 500 LV, 550 RA,
# 600 RV, 820 aorta, 850 PA), then the composite whole-heart region.
def get_mmwhs_regions() -> dict:
    return {
        "myocardium": (1,),
        "left atrium": (2,),
        "left ventricle": (3,),
        "right atrium": (4,),
        "right ventricle": (5,),
        "ascending aorta": (6,),
        "pulmonary artery": (7,),
        "whole heart": (1, 2, 3, 4, 5, 6, 7),
    }


def create_region_from_mask(mask: np.ndarray, join_labels) -> np.ndarray:
    """Binary union of the given labels (region_based_evaluation.py:95-99)."""
    out = np.zeros_like(mask, dtype=np.uint8)
    for l in join_labels:
        out[mask == l] = 1
    return out


def evaluate_case_regions(pred: np.ndarray, gt: np.ndarray, regions: dict,
                          measure: str = "dc", spacing=None,
                          nsd_tolerance_mm: float = 1.0) -> list:
    """Per-region Dice ('dc') or normalized surface Dice ('surface_dc') for
    one case (evaluate_case_dc / evaluate_case_sdc parity): both-empty ->
    nan, else the metric over the joined binary masks."""
    results = []
    for join_labels in regions.values():
        p = create_region_from_mask(pred, join_labels).astype(bool)
        g = create_region_from_mask(gt, join_labels).astype(bool)
        if not p.any() and not g.any():
            results.append(float("nan"))
        elif measure == "dc":
            denom = p.sum() + g.sum()
            results.append(float(2.0 * np.logical_and(p, g).sum() / denom))
        elif measure == "surface_dc":
            results.append(normalized_surface_dice(p, g, nsd_tolerance_mm, spacing))
        else:
            raise ValueError(f"unknown measure {measure!r}")
    return results


def evaluate_regions(case_pairs, regions: dict, out_dir: str | None = None,
                     measures=("dc", "surface_dc"), spacing=None,
                     nsd_tolerance_mm: float = 1.0) -> dict:
    """Region evaluation over (case_id, pred, gt) triples; writes the
    reference's summary_<measure>.csv layout (per-case rows + mean / median /
    'nan is 1' aggregate rows, region_based_evaluation.py:160-196) when
    `out_dir` is given. Returns {measure: {region: {mean, median, ...}}}."""
    region_names = list(regions.keys())
    summary = {}
    for measure in measures:
        rows = []
        for case_id, pred, gt in case_pairs:
            rows.append((case_id, evaluate_case_regions(
                pred, gt, regions, measure, spacing, nsd_tolerance_mm)))
        per_region = {r: np.array([vals[k] for _, vals in rows])
                      for k, r in enumerate(region_names)}
        stats = {}
        for r, v in per_region.items():
            filled = np.where(np.isnan(v), 1.0, v)
            stats[r] = {
                "mean": float(np.nanmean(v)) if np.isfinite(v).any() else float("nan"),
                "median": float(np.nanmedian(v)) if np.isfinite(v).any() else float("nan"),
                "mean_nan_is_1": float(np.mean(filled)) if len(v) else float("nan"),
                "median_nan_is_1": float(np.median(filled)) if len(v) else float("nan"),
            }
        summary[measure] = stats
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"summary_{measure}.csv"), "w") as f:
                f.write("casename" + "".join(f",{r}" for r in region_names) + "\n")
                for case_id, vals in rows:
                    f.write(case_id + "".join(f",{v:02.4f}" for v in vals) + "\n")
                for key, row_name in [("mean", "mean"), ("median", "median"),
                                      ("mean_nan_is_1", "mean (nan is 1)"),
                                      ("median_nan_is_1", "median (nan is 1)")]:
                    f.write(row_name + "".join(
                        f",{stats[r][key]:02.4f}" for r in region_names) + "\n")
    return summary


def aggregate_scores(case_results, json_output_file=None, json_name="",
                     json_description="", json_author="", json_task=""):
    """nnU-Net aggregate_scores parity: {'all': [...], 'mean': {label: {metric:
    mean}}} with nan-aware means; optional json dump."""
    all_scores = {"all": list(case_results), "mean": {}}
    if case_results:
        labels = case_results[0].keys()
        for l in labels:
            all_scores["mean"][l] = {}
            metrics = case_results[0][l].keys()
            for m in metrics:
                vals = [c[l][m] for c in case_results if not np.isnan(c[l][m])]
                all_scores["mean"][l][m] = float(np.mean(vals)) if vals else float("nan")
    if json_output_file:
        os.makedirs(os.path.dirname(json_output_file) or ".", exist_ok=True)
        with open(json_output_file, "w") as f:
            json.dump({
                "name": json_name, "description": json_description,
                "author": json_author, "task": json_task,
                "results": all_scores,
            }, f, indent=2, default=str)
    return all_scores
