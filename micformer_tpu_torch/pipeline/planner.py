"""Experiment planning: the dataset fingerprint and the training plans.

Counterpart of `micformer_tpu/pipeline/planner.py`, a slimmed nnU-Net
experiment planning (MedNeXt/nnunet_mednext/experiment_planning/
DatasetAnalyzer.py, experiment_planner_baseline_3DUNet.py): collect per-case
shapes, spacings and foreground intensity statistics, then derive a plan
(target spacing, patch size, batch size, normalisation, class list, pool and
conv kernel schedules). The plans feed `models.generic_unet.build_from_plan`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


@dataclasses.dataclass
class DatasetFingerprint:
    shapes: list
    spacings: list
    class_values: list
    intensity_mean: float
    intensity_std: float
    intensity_p005: float
    intensity_p995: float

    def to_json(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


def analyze_dataset(volumes, labels, spacings=None) -> DatasetFingerprint:
    """volumes: iterable of np arrays [C, D, H, W]; labels: [D, H, W] int."""
    shapes, fg_samples, class_vals = [], [], set()
    spacings = list(spacings) if spacings is not None else []
    for vol, lab in zip(volumes, labels):
        shapes.append(list(np.asarray(vol).shape[1:]))
        lab = np.asarray(lab)
        class_vals.update(int(v) for v in np.unique(lab))
        fg = np.asarray(vol)[0][lab > 0]
        if fg.size:
            idx = np.random.RandomState(0).choice(fg.size, min(fg.size, 10000), replace=False)
            fg_samples.append(fg.ravel()[idx])
    fg_all = np.concatenate(fg_samples) if fg_samples else np.zeros(1, np.float32)
    return DatasetFingerprint(
        shapes=shapes,
        spacings=spacings,
        class_values=sorted(class_vals),
        intensity_mean=float(fg_all.mean()),
        intensity_std=float(fg_all.std()),
        intensity_p005=float(np.percentile(fg_all, 0.5)),
        intensity_p995=float(np.percentile(fg_all, 99.5)),
    )


def compute_pool_and_conv_schedules(patch_size, spacing=None,
                                    min_feature_map_size=4, max_pools=5):
    """Per-stage pool/conv kernel schedules — nnU-Net `get_pool_and_conv_props`
    (experiment_planning/common_utils.py) decisions, slimmed: each round pools
    (stride 2) every axis whose remaining extent allows it (>= 2*min feature
    map size) AND whose spacing is within 2x of the finest axis; conv kernels
    are 3 on axes within 3x anisotropy of the finest spacing, else 1 (the
    planner's anisotropy rule). Isotropic 128-ish patches yield the classic
    5x (2,2,2) pools / 6x (3,3,3) convs.

    Returns (pool_op_kernel_sizes, conv_kernel_sizes) with
    len(conv) == len(pool) + 1. Works for any rank (2D/3D).
    """
    nd = len(patch_size)
    spacing = [float(s) for s in (spacing or [1.0] * nd)]
    size = [int(p) for p in patch_size]

    def conv_kernel():
        m = min(spacing)
        return [3 if spacing[i] <= 3 * m else 1 for i in range(nd)]

    pools, convs = [], [conv_kernel()]
    while len(pools) < max_pools:
        m = min(spacing)
        axes = [i for i in range(nd)
                if size[i] >= 2 * min_feature_map_size and spacing[i] <= 2 * m]
        if not axes:
            break
        pools.append([2 if i in axes else 1 for i in range(nd)])
        for i in axes:
            spacing[i] *= 2
            size[i] //= 2
        convs.append(conv_kernel())
    return pools, convs


def plan_experiment(fp: DatasetFingerprint, max_patch=(128, 128, 128),
                    vram_budget_voxels=128 ** 3 * 2) -> dict:
    """Derive patch/batch/normalization plan (3DUNet planner decisions,
    reduced): patch = median shape clipped to max_patch and rounded to /16;
    batch grows while it fits the voxel budget (>=2 like nnU-Net's floor).
    The emitted pool/conv schedules feed models.generic_unet.build_from_plan,
    the plan-consuming architecture (generic_UNet.py:167)."""
    med = np.median(np.asarray(fp.shapes), axis=0).astype(int)
    patch = [min(int(m), mp) for m, mp in zip(med, max_patch)]
    patch = [max(16, (p // 16) * 16) for p in patch]
    batch = max(1, int(vram_budget_voxels // max(np.prod(patch), 1)))
    spacing = (list(np.median(np.asarray(fp.spacings), axis=0))
               if fp.spacings else [1.0] * len(patch))
    pools, convs = compute_pool_and_conv_schedules(patch, spacing)
    return {
        "patch_size": patch,
        "batch_size": batch,
        "normalization": "zscore_clip",
        "clip": [fp.intensity_p005, fp.intensity_p995],
        "mean": fp.intensity_mean,
        "std": fp.intensity_std,
        "classes": fp.class_values,
        "spacing": spacing,
        "pool_op_kernel_sizes": pools,
        "conv_kernel_sizes": convs,
        "base_num_features": 32,
    }


def plan_experiment_lowres(fp: DatasetFingerprint, max_patch=(128, 128, 128),
                           patch_coverage: float = 1.0) -> dict:
    """3d_lowres plan for the cascade's first stage (ExperimentPlanner3D's
    lowres rule, slimmed): uniformly coarsen the target spacing until the
    median shape fits within `patch_coverage` x the patch budget, so one
    (or few) patches see the whole anatomy — the property the cascade's
    first stage exists to provide. Emits the same schema as plan_experiment
    plus 'downsample_factor' and 'stage': consumers resample inputs by the
    factor before training/prediction, and the fullres stage consumes the
    stage-0 predictions as extra one-hot channels (data/cascade.py)."""
    med = np.median(np.asarray(fp.shapes), axis=0).astype(float)
    budget = np.asarray(max_patch, float) * patch_coverage
    factor = float(max(1.0, np.max(med / budget)))
    lowres_med = np.maximum((med / factor).astype(int), 16)
    fp_low = dataclasses.replace(
        fp,
        shapes=[list(lowres_med)],
        spacings=([list(np.asarray(s, float) * factor) for s in fp.spacings]
                  if fp.spacings else []),
    )
    plan = plan_experiment(fp_low, max_patch=max_patch)
    plan["downsample_factor"] = factor
    plan["stage"] = "3d_lowres"
    return plan


def plan_experiment_2d(fp: DatasetFingerprint, max_patch=(512, 512)) -> dict:
    """2D plan (ExperimentPlanner2D parity, slimmed): in-plane patch from the
    median shape's trailing two axes; schedules over rank-2 kernels, feeding
    the 2D GenericUNet that the 2D/pseudo-3D inference engines drive."""
    med = np.median(np.asarray(fp.shapes), axis=0).astype(int)[-2:]
    patch = [max(16, (min(int(m), mp) // 16) * 16) for m, mp in zip(med, max_patch)]
    spacing = (list(np.median(np.asarray(fp.spacings), axis=0))[-2:]
               if fp.spacings else [1.0, 1.0])
    pools, convs = compute_pool_and_conv_schedules(patch, spacing, max_pools=6)
    return {
        "patch_size": patch,
        "batch_size": 32,
        "normalization": "zscore_clip",
        "clip": [fp.intensity_p005, fp.intensity_p995],
        "mean": fp.intensity_mean,
        "std": fp.intensity_std,
        "classes": fp.class_values,
        "spacing": spacing,
        "pool_op_kernel_sizes": pools,
        "conv_kernel_sizes": convs,
        "base_num_features": 32,
    }
