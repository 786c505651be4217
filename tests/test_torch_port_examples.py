"""The port's examples on the CPU: examples/torch_evaluate_checkpoint.py on
a one-epoch UNet3D run at 32³, held against cli/evaluate on the same
prediction, and examples/torch_cascade_two_stage.py at its own shapes.

The example's mean Dice (1e-6 smoothing, f32 sums) and MONAI mean IoU
(classes empty in the ground truth left out) against the evaluator's Dice
and Jaccard (exact counts in float64): within 1e-5, on a case whose ground
truth holds every class, so both leave out the same classes (none).
"""

import glob
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from micformer_tpu_torch.cli import evaluate
from micformer_tpu_torch.cli import train
from micformer_tpu_torch.data.nifti import read_nifti
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("torch_evaluate_checkpoint", "torch_cascade_two_stage")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_checkpoint_equals_cli_evaluate(tmp_path):
    root, cache, run = tmp_path / "data", tmp_path / "cache", tmp_path / "run"
    write_synthetic_dataset(str(root), n_cases=6, shape=(36, 36, 36), seed=3)
    common = ["--data", str(root), "--cache", str(cache), "--target-shape", "32"]
    train.main(common + ["--device", "cpu", "--model", "unet3d", "--epochs", "1",
                         "--val", "1", "--run-dir", str(run)])
    dump = tmp_path / "dump"
    got = _example("torch_evaluate_checkpoint").main(
        common + ["--run-dir", str(run), "--device", "cpu", "--dump", str(dump)])
    assert len(got["cases"]) == 1

    gts = tmp_path / "gts"
    gts.mkdir()
    for path in glob.glob(str(dump / "*_gt.nii.gz")):
        shutil.copy(path, gts)
        assert set(np.unique(read_nifti(path))) == set(range(8))
    agg = evaluate.main(["--pred", str(dump), "--gt", str(gts)])
    labels = [str(c) for c in range(1, 8)]
    dice = np.mean([agg["mean"][c]["Dice"] for c in labels])
    jaccard = np.mean([agg["mean"][c]["Jaccard"] for c in labels])
    np.testing.assert_allclose(got["meandice"], dice, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["miou"], jaccard, rtol=0, atol=1e-5)


def test_cascade_two_stage_runs(tmp_path):
    out = _example("torch_cascade_two_stage").main([str(tmp_path), "--device", "cpu"])
    preds = glob.glob(os.path.join(out, "*_pred.nii.gz"))
    assert len(preds) == 1
    seg = read_nifti(preds[0])
    assert seg.shape == (32, 32, 32) and seg.max() < 8


def test_examples_import_no_jax():
    """Each example's imports (its main's, through --help) pull in neither
    JAX nor the JAX package."""
    code = (
        "import importlib.util, sys\n"
        f"for name in {EXAMPLES!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(name, 'examples/' + name + '.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    try:\n"
        "        mod.main(['--help'])\n"
        "    except SystemExit:\n"
        "        pass\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'micformer_tpu')]\n"
        "print('BAD', sorted(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "BAD []"
