"""The port's host-side pipeline against the JAX package's: the dataset
fingerprint and the three planners, the pool and conv schedules, cli/plan,
plan-driven preprocessing, cli/preprocess --no-registration, the dataset
integrity checks and the model selection. All numpy on the host; nothing is
compiled."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from micformer_tpu.cli import plan as jplan_cli
from micformer_tpu.cli import preprocess as jpre_cli
from micformer_tpu.data.nifti import write_nifti as jwrite_nifti
from micformer_tpu.pipeline import model_selection as jsel
from micformer_tpu.pipeline import planner as jplan
from micformer_tpu.pipeline import preprocessing as jpre
from micformer_tpu.pipeline import sanity_checks as jsan
from micformer_tpu_torch.cli import plan as tplan_cli
from micformer_tpu_torch.cli import preprocess as tpre_cli
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset
from micformer_tpu_torch.pipeline import model_selection as tsel
from micformer_tpu_torch.pipeline import planner as tplan
from micformer_tpu_torch.pipeline import preprocessing as tpre
from micformer_tpu_torch.pipeline import sanity_checks as tsan


def _cases(seed, shapes, channels=1):
    """Volumes [C, D, H, W] with a foreground box and integer labels."""
    rng = np.random.default_rng(seed)
    vols, labs = [], []
    for shape in shapes:
        vol = rng.normal(size=(channels, *shape)).astype(np.float32) * 50 + 100
        lab = np.zeros(shape, np.int16)
        lab[2:-2, 3:-3, 1:-1] = rng.choice([0, 205, 500, 850], size=lab[2:-2, 3:-3, 1:-1].shape)
        vols.append(vol)
        labs.append(lab)
    return vols, labs


SPACINGS = {"isotropic": [[1.0, 1.0, 1.0]] * 3,
            "anisotropic": [[5.0, 0.8, 0.8], [4.5, 0.75, 0.8], [5.0, 0.8, 0.7]],
            "none": None}


@pytest.mark.parametrize("spacing", sorted(SPACINGS))
def test_fingerprint_and_plans_equal_jax(spacing):
    vols, labs = _cases(0, [(40, 60, 52), (36, 64, 48), (44, 58, 50)])
    sp = SPACINGS[spacing]
    fp_t = tplan.analyze_dataset(vols, labs, spacings=sp)
    fp_j = jplan.analyze_dataset(vols, labs, spacings=sp)
    assert dataclasses.asdict(fp_t) == dataclasses.asdict(fp_j)
    for fn in ("plan_experiment", "plan_experiment_lowres", "plan_experiment_2d"):
        for kw in ({}, {"max_patch": (32, 32, 32)} if fn != "plan_experiment_2d"
                   else {"max_patch": (48, 48)}):
            assert getattr(tplan, fn)(fp_t, **kw) == getattr(jplan, fn)(fp_j, **kw), (fn, kw)


@pytest.mark.parametrize("patch,spacing,kw", [
    ((128, 128, 128), None, {}), ((96, 160, 160), (3.0, 1.0, 1.0), {}),
    ((64, 128, 128), (2.5, 0.7, 0.7), {"max_pools": 3}), ((256, 256), (1.0, 1.0), {}),
    ((40, 24, 200), (1.0, 2.1, 0.5), {"min_feature_map_size": 3})])
def test_pool_and_conv_schedules_equal_jax(patch, spacing, kw):
    got = tplan.compute_pool_and_conv_schedules(patch, spacing, **kw)
    assert got == jplan.compute_pool_and_conv_schedules(patch, spacing, **kw)
    assert len(got[1]) == len(got[0]) + 1


def test_cli_plan_writes_what_jax_writes(tmp_path):
    data = tmp_path / "mm"
    write_synthetic_dataset(str(data), n_cases=4, shape=(24, 28, 20), seed=3)
    tplan_cli.main(["--data", str(data), "--out", str(tmp_path / "t"), "--max-patch", "64"])
    jplan_cli.main(["--data", str(data), "--out", str(tmp_path / "j"), "--max-patch", "64"])
    for name in ("fingerprint.json", "plan_3d.json", "plan_2d.json", "plan_3d_lowres.json"):
        t = json.loads((tmp_path / "t" / name).read_text())
        assert t == json.loads((tmp_path / "j" / name).read_text()), name
    plan3d = json.loads((tmp_path / "t" / "plan_3d.json").read_text())
    assert plan3d["classes"][0] == 0 and len(plan3d["conv_kernel_sizes"]) == len(
        plan3d["pool_op_kernel_sizes"]) + 1


@pytest.mark.parametrize("ct_like", [True, False])
def test_preprocess_with_plan_equals_jax(ct_like):
    vols, labs = _cases(1, [(30, 34, 28)], channels=2)
    img, lab = vols[0], labs[0]
    img[:, :3] = 0                      # a zero border for the crop
    fp = jplan.analyze_dataset([img], [lab])
    plan = jplan.plan_experiment(fp)
    if not ct_like:
        plan = {k: v for k, v in plan.items() if k not in ("clip", "mean", "std")}
    kw = dict(in_spacing=(1.0, 0.8, 1.2), target_spacing=(1.5, 1.0, 1.0))
    ti, tl, tb = tpre.preprocess_with_plan(img, lab, plan, **kw)
    ji, jl, jb = jpre.preprocess_with_plan(img, lab, plan, **kw)
    assert tb == jb and ti.shape == ji.shape and ti.dtype == ji.dtype
    np.testing.assert_allclose(ti, ji, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tl, jl)
    # and each step alone
    for is_label, v in ((False, img[0]), (True, lab)):
        np.testing.assert_allclose(
            tpre.resample_to_spacing(v, (1, 1, 1), (0.7, 1.3, 1.0), is_label=is_label),
            jpre.resample_to_spacing(v, (1, 1, 1), (0.7, 1.3, 1.0), is_label=is_label),
            atol=1e-6, rtol=0)
    for a, b in zip(tpre.crop_to_nonzero(img, lab), jpre.crop_to_nonzero(img, lab)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tpre.normalize_with_plan(img[1], plan, ct_like),
                               jpre.normalize_with_plan(img[1], plan, ct_like), atol=1e-6)


def _train_layout(tmp_path):
    """<root>/ct_train and mr_train from a synthetic MM-WHS root, with a
    zero margin in the CT image so the crop cuts."""
    src = tmp_path / "flat"
    write_synthetic_dataset(str(src), n_cases=2, shape=(22, 26, 18), seed=4)
    root = tmp_path / "root"
    for mod in ("ct", "mr"):
        (root / f"{mod}_train").mkdir(parents=True)
        for f in sorted(os.listdir(src)):
            if f.startswith(f"{mod}_"):
                shutil.copy(src / f, root / f"{mod}_train" / f)
    from micformer_tpu_torch.data.nifti import read_nifti

    for f in os.listdir(root / "ct_train"):
        if f.endswith("_image.nii.gz"):
            path = root / "ct_train" / f
            vol = read_nifti(str(path)).astype(np.float32) + 1
            vol[:2], vol[:, -3:] = 0, 0
            jwrite_nifti(str(path), vol)
    return root


def test_cli_preprocess_no_registration_writes_what_jax_writes(tmp_path):
    from micformer_tpu_torch.data.nifti import read_nifti

    root = _train_layout(tmp_path)
    tpre_cli.main(["--data", str(root), "--out", str(tmp_path / "t"), "--no-registration"])
    jpre_cli.main(["--data", str(root), "--out", str(tmp_path / "j"), "--no-registration"])
    for sub in ("ct_crop", "mr_crop"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert len(names) == 4 and sorted(os.listdir(tmp_path / "t" / sub)) == names
        for f in names:
            a = read_nifti(str(tmp_path / "t" / sub / f))
            b = read_nifti(str(tmp_path / "j" / sub / f))
            # cropped from 22: two zero planes, less the box's one-voxel margin
            assert a.dtype == b.dtype and a.shape == b.shape and a.shape[0] == 21
            np.testing.assert_array_equal(a, b)


def test_cli_preprocess_without_ants_exits_as_jax(tmp_path):
    root = _train_layout(tmp_path)
    with pytest.raises(SystemExit) as t:
        tpre_cli.main(["--data", str(root), "--out", str(tmp_path / "t")])
    with pytest.raises(SystemExit) as j:
        jpre_cli.main(["--data", str(root), "--out", str(tmp_path / "j")])
    assert str(t.value) == str(j.value) and "--no-registration" in str(t.value)


def _integrity_root(tmp_path, fault):
    from micformer_tpu_torch.data.nifti import read_nifti

    root = tmp_path / fault
    write_synthetic_dataset(str(root), n_cases=3, shape=(12, 14, 10), seed=5)
    if fault == "missing":
        os.remove(root / "mr_1002_label.nii.gz")
    elif fault == "nan":
        vol = read_nifti(str(root / "ct_1001_image.nii.gz")).astype(np.float32)
        vol[3, 4, 5] = np.nan
        jwrite_nifti(str(root / "ct_1001_image.nii.gz"), vol)
    elif fault == "stray_label":
        lab = read_nifti(str(root / "mr_1003_label.nii.gz")).astype(np.int16)
        lab[0, 0, 0] = 999
        jwrite_nifti(str(root / "mr_1003_label.nii.gz"), lab)
    elif fault == "geometry":
        lab = read_nifti(str(root / "ct_1002_label.nii.gz"))
        jwrite_nifti(str(root / "ct_1002_label.nii.gz"), lab[:-1])
    elif fault == "orientation":
        for kind in ("image", "label"):
            path = str(root / f"ct_1003_{kind}.nii.gz")
            jwrite_nifti(path, read_nifti(path), affine=np.diag([-1.0, 1, 1, 1]))
    return str(root)


@pytest.mark.parametrize("fault", ["clean", "missing", "nan", "stray_label", "geometry",
                                   "orientation", "empty"])
def test_verify_dataset_integrity_reports_as_jax(tmp_path, fault):
    root = str(tmp_path) if fault == "empty" else _integrity_root(tmp_path, fault)
    got = tsan.verify_dataset_integrity(root)
    assert got == jsan.verify_dataset_integrity(root)
    assert bool(got["errors"]) == (fault not in ("clean", "orientation"))
    assert bool(got["warnings"]) == (fault == "orientation")
    if got["errors"]:
        with pytest.raises(AssertionError):
            tsan.verify_dataset_integrity(root, strict=True)


def _agg(seed, labels=range(8), nan_label=None):
    rng = np.random.default_rng(seed)
    mean = {str(c): {"Dice": float(rng.uniform(0.3, 0.95))} for c in labels}
    if nan_label is not None:
        mean[str(nan_label)]["Dice"] = float("nan")
    return {"mean": mean}


@pytest.mark.parametrize("with_ensembles", [False, True])
def test_find_best_configuration_decides_as_jax(with_ensembles):
    configs = {"3d_fullres": _agg(0), "2d": _agg(1), "3d_lowres": _agg(2, nan_label=3),
               "empty": _agg(3, labels=[0])}
    pairs = tsel.candidate_ensembles(configs)
    assert pairs == jsel.candidate_ensembles(configs)
    ens = {pair: _agg(10 + i) for i, pair in enumerate(pairs)} if with_ensembles else None
    got = tsel.find_best_configuration(configs, ens)
    want = jsel.find_best_configuration(configs, ens)
    assert got["best"] == want["best"] and got["is_ensemble"] == want["is_ensemble"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert np.isnan(tsel.mean_fg_dice(configs["empty"]))
