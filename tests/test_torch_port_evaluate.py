"""The port's postprocessing, metrics, evaluator, evaluate and ensemble CLIs
and overlay PNG against the JAX package's, on the same seeded numpy inputs.

Tolerances: postprocessing is bitwise; mean IoU, HD95 and the confusion
tuple within 1e-6 (the same float64 host arithmetic, or f32 sums of 0/1
products for mean IoU); evaluator dicts and the evaluate CLI's JSON equal
(floats compared as numbers, nan equal to nan); ensembled label maps and
overlay pixels equal.
"""

import glob
import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from micformer_tpu.cli import ensemble as jens
from micformer_tpu.cli import evaluate as jev
from micformer_tpu.losses import metrics as jmet
from micformer_tpu.pipeline import evaluator as jeval
from micformer_tpu.pipeline import postprocess as jpost
from micformer_tpu.train import logging as jlog
from micformer_tpu_torch.cli import ensemble as tens
from micformer_tpu_torch.cli import evaluate as tev
from micformer_tpu_torch.data.nifti import read_nifti, write_nifti
from micformer_tpu_torch.losses import metrics as tmet
from micformer_tpu_torch.pipeline import evaluator as teval
from micformer_tpu_torch.pipeline import postprocess as tpost
from micformer_tpu_torch.train import logging as tlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _labels(seed, shape=(20, 24, 22), k=8, smooth=1.5):
    """A blobby integer label map: the argmax of k smoothed noise fields, so
    classes come in several connected pieces."""
    rng = np.random.default_rng(seed)
    z = ndimage.gaussian_filter(rng.normal(size=(k,) + shape), (0,) + (smooth,) * 3)
    return np.argmax(z, 0).astype(np.int32)


def _same(a, b):
    """Equal nested structures, floats as numbers with nan equal to nan."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return float(a) == float(b) or (math.isnan(float(a)) and math.isnan(float(b)))
    return a == b


# --- postprocessing, bitwise ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_remove_all_but_largest_cc_matches_jax(seed):
    seg = _labels(seed).astype(np.uint8)
    for labels in (None, [1, 3, 7]):
        got = tpost.remove_all_but_largest_cc(seg, labels)
        ref = jpost.remove_all_but_largest_cc(seg, labels)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    empty = np.zeros((6, 6, 6), np.uint8)
    np.testing.assert_array_equal(tpost.remove_all_but_largest_cc(empty),
                                  jpost.remove_all_but_largest_cc(empty))
    np.testing.assert_array_equal(tpost.largest_cc_mask(empty > 0),
                                  jpost.largest_cc_mask(empty > 0))


def test_determine_and_apply_postprocessing_match_jax():
    preds = [_labels(s) for s in (3, 4, 5)]
    # ground truth: each prediction with its small components removed, so the
    # decision is on for some classes and off for others
    gts = [jpost.remove_all_but_largest_cc(_labels(s, smooth=2.5)) for s in (3, 4, 5)]
    for min_gain in (0.0, 0.01):
        got = tpost.determine_postprocessing(preds, gts, range(1, 8), min_gain)
        ref = jpost.determine_postprocessing(preds, gts, range(1, 8), min_gain)
        assert got == ref
        for p in preds:
            np.testing.assert_array_equal(tpost.apply_postprocessing(p, got),
                                          jpost.apply_postprocessing(p, ref))
    assert tpost.apply_postprocessing(preds[0], {1: False}) is preds[0]


# --- metrics, within 1e-6 ---------------------------------------------------

def _onehot(seg, k=8):
    return (np.arange(k)[:, None, None, None] == seg[None]).astype(np.float32)


@pytest.mark.parametrize("include_background", [False, True])
@pytest.mark.parametrize("ignore_empty", [True, False])
def test_mean_iou_matches_jax(include_background, ignore_empty):
    pred = np.stack([_onehot(_labels(6)), _onehot(_labels(7))])
    lab = np.stack([_onehot(_labels(8)), _onehot(_labels(9))])
    lab[0, 3] = 0   # an empty ground-truth class
    pred[1, 5] = 0  # an empty predicted class
    lab[1, 6] = pred[1, 6] = 0  # empty on both sides
    kw = dict(include_background=include_background, ignore_empty=ignore_empty)
    got = tmet.mean_iou(torch.from_numpy(pred), torch.from_numpy(lab), **kw)
    ref = float(jmet.mean_iou(jnp.asarray(pred), jnp.asarray(lab), **kw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), ref, atol=1e-6, rtol=0)


def test_mean_iou_all_empty_is_nan_as_in_jax():
    pred = np.zeros((1, 3, 4, 4, 4), np.float32)
    got = tmet.mean_iou(torch.from_numpy(pred), torch.from_numpy(pred))
    assert math.isnan(got.item()) and math.isnan(float(jmet.mean_iou(pred, pred)))


@pytest.mark.parametrize("spacing", [None, (1.5, 0.7, 0.9)])
def test_hd95_and_multiclass_match_jax(spacing):
    a, b = _labels(10), _labels(11)
    b[b == 4] = 0          # class 4 absent from the target
    a[a == 6] = 0          # class 6 absent from the prediction
    got = tmet.hd95_multiclass(a, b, 8, spacing)
    ref = jmet.hd95_multiclass(a, b, 8, spacing)
    assert math.isnan(got[3]) and math.isnan(got[5])
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    for c in (1, 2):
        np.testing.assert_allclose(tmet.hd95(a == c, b == c, spacing),
                                   jmet.hd95(a == c, b == c, spacing), atol=1e-6, rtol=0)
    empty = np.zeros_like(a, bool)
    assert math.isnan(tmet.hd95(empty, b == 1)) and math.isnan(tmet.hd95(a == 1, empty))
    np.testing.assert_array_equal(tmet._surface_distances(empty, b == 1),
                                  jmet._surface_distances(empty, b == 1))
    for c in (1, 3):
        np.testing.assert_allclose(np.sort(tmet._surface_distances(a == c, b == c, spacing)),
                                   np.sort(jmet._surface_distances(a == c, b == c, spacing)),
                                   atol=1e-6, rtol=0)


def test_calculate_dice_tp_fp_fn_matches_jax():
    a, b = _labels(12), _labels(13)
    empty = np.zeros_like(a, bool)
    for p, t in [(a == 2, b == 2), (a == 5, b == 1), (empty, b == 3), (a == 3, empty),
                 (empty, empty)]:
        got, ref = tmet.calculate_dice_tp_fp_fn(p, t), jmet.calculate_dice_tp_fp_fn(p, t)
        assert got.keys() == ref.keys()
        np.testing.assert_allclose([got[k] for k in ref], [ref[k] for k in ref],
                                   atol=1e-6, rtol=0)


# --- evaluator, equal dicts -------------------------------------------------

@pytest.mark.parametrize("spacing", [None, (1.5, 0.7, 0.9)])
def test_evaluate_case_and_nsd_match_jax(spacing):
    a, b = _labels(14), _labels(15)
    b[b == 2] = 0
    a[a == 7] = 0
    got = teval.evaluate_case(a, b, range(1, 8), spacing, nsd_tolerance_mm=1.5)
    ref = jeval.evaluate_case(a, b, range(1, 8), spacing, nsd_tolerance_mm=1.5)
    assert _same(got, ref), (got, ref)
    for c in (1, 3):
        assert _same(teval.normalized_surface_dice(a == c, b == c, 1.0, spacing),
                     jeval.normalized_surface_dice(a == c, b == c, 1.0, spacing))
    assert math.isnan(teval.normalized_surface_dice(a == 7, b == 1, 1.0))


def test_regions_and_aggregate_match_jax(tmp_path):
    assert teval.get_mmwhs_regions() == jeval.get_mmwhs_regions()
    regions = teval.get_mmwhs_regions()
    pairs = [(f"c{s}", _labels(s), _labels(s + 1)) for s in (16, 18)]
    pairs[1][1][pairs[1][1] == 5] = 0
    pairs[1][2][pairs[1][2] == 5] = 0   # region 5 empty on both sides: nan
    for measure in ("dc", "surface_dc"):
        for _, p, g in pairs:
            assert _same(teval.evaluate_case_regions(p, g, regions, measure),
                         jeval.evaluate_case_regions(p, g, regions, measure))
    with pytest.raises(ValueError):
        teval.evaluate_case_regions(pairs[0][1], pairs[0][2], regions, "hd")
    got = teval.evaluate_regions(pairs, regions, out_dir=str(tmp_path / "t"))
    ref = jeval.evaluate_regions(pairs, regions, out_dir=str(tmp_path / "j"))
    assert _same(got, ref)
    for name in ("summary_dc.csv", "summary_surface_dc.csv"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    cases = [teval.evaluate_case(p, g, range(1, 8)) for _, p, g in pairs]
    got = teval.aggregate_scores(cases, str(tmp_path / "t.json"), json_task="MM-WHS")
    ref = jeval.aggregate_scores(cases, str(tmp_path / "j.json"), json_task="MM-WHS")
    assert _same(got, ref)
    assert _same(json.loads((tmp_path / "t.json").read_text()),
                 json.loads((tmp_path / "j.json").read_text()))
    assert teval.aggregate_scores([]) == jeval.aggregate_scores([])


# --- evaluate and ensemble CLIs ---------------------------------------------

@pytest.fixture(scope="module")
def label_dirs(tmp_path_factory):
    """<pid>_pred.nii.gz and <pid>_gt.nii.gz for three cases, one with a
    class missing from its prediction, and one prediction without a GT."""
    root = tmp_path_factory.mktemp("labels")
    pred, gt = root / "pred", root / "gt"
    pred.mkdir()
    gt.mkdir()
    for i, pid in enumerate(["1001", "1002", "1003"]):
        p = _labels(20 + i).astype(np.uint8)
        if i == 1:
            p[p == 3] = 0
        write_nifti(str(pred / f"{pid}_pred.nii.gz"), p)
        write_nifti(str(gt / f"{pid}_gt.nii.gz"), _labels(30 + i).astype(np.uint8))
    write_nifti(str(pred / "1009_pred.nii.gz"), _labels(40).astype(np.uint8))
    return pred, gt


@pytest.mark.parametrize("regions", [False, True])
def test_evaluate_cli_matches_jax(label_dirs, tmp_path, regions):
    pred, gt = label_dirs
    outs = {}
    for name, mod in (("port", tev), ("jax", jev)):
        d = tmp_path / name
        d.mkdir()
        for f in pred.iterdir():   # the CSVs of --regions go into --pred
            (d / f.name).write_bytes(f.read_bytes())
        js = tmp_path / f"{name}.json"
        agg = mod.main(["--pred", str(d), "--gt", str(gt), "--json", str(js)]
                       + (["--regions"] if regions else []))
        outs[name] = (agg, json.loads(js.read_text()), d)
    (tagg, tjs, td), (jagg, jjs, jd) = outs["port"], outs["jax"]
    assert len(tagg["all"]) == 3
    assert _same(tagg, jagg) and _same(tjs, jjs)
    assert ("regions" in tjs) == regions
    for name in ("summary_dc.csv", "summary_surface_dc.csv"):
        assert (td / name).exists() == regions
        if regions:
            assert (td / name).read_text() == (jd / name).read_text()


def test_ensemble_cli_matches_jax(tmp_path):
    rng = np.random.default_rng(50)
    ins = []
    for m in range(2):
        d = tmp_path / f"model{m}"
        d.mkdir()
        ins.append(str(d))
        for pid in ("1001", "1002") if m == 0 else ("1001", "1002", "1005"):
            logits = ndimage.gaussian_filter(rng.normal(size=(8, 12, 14, 10)), (0, 1, 1, 1))
            sm = np.exp(4 * logits) / np.exp(4 * logits).sum(0)
            np.savez_compressed(str(d / f"{pid}_softmax.npz"), softmax=sm.astype(np.float16))
    for largest_cc in (False, True):
        extra = ["--largest-cc"] if largest_cc else []
        tens.main(["--inputs", *ins, "--out", str(tmp_path / "t"), *extra])
        jens.main(["--inputs", *ins, "--out", str(tmp_path / "j"), *extra])
        names = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "t" / "*")))
        assert names == ["1001_pred.nii.gz", "1002_pred.nii.gz"]
        for n in names:
            got = read_nifti(str(tmp_path / "t" / n))
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, read_nifti(str(tmp_path / "j" / n)))
    with pytest.raises(SystemExit):
        tens.main(["--inputs", ins[0], str(tmp_path / "t"), "--out", str(tmp_path / "x")])


# --- overlay PNG ------------------------------------------------------------

@pytest.mark.parametrize("channels", [False, True])
def test_save_overlay_png_matches_jax(tmp_path, channels):
    from PIL import Image

    rng = np.random.default_rng(60)
    image = rng.normal(size=(2, 9, 17, 13) if channels else (9, 17, 13)).astype(np.float32)
    seg = _labels(61, (9, 17, 13)).astype(np.uint8)
    seg[:4] = 0
    k_t = tlog.save_overlay_png(image, seg, str(tmp_path / "t.png"))
    k_j = jlog.save_overlay_png(image, seg, str(tmp_path / "j.png"))
    assert k_t == k_j
    got, ref = Image.open(tmp_path / "t.png"), Image.open(tmp_path / "j.png")
    assert got.mode == ref.mode == "RGB" and got.size == ref.size == (13, 17)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_overlay_module_imports_no_pil_or_matplotlib(tmp_path):
    code = ("import sys\n"
            "import numpy as np\n"
            "from micformer_tpu_torch.train.logging import save_overlay_png\n"
            "save_overlay_png(np.ones((3, 4, 5)), np.ones((3, 4, 5), int), sys.argv[1])\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0] in ('PIL', 'matplotlib')))\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "o.png")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]" and (tmp_path / "o.png").stat().st_size > 0
