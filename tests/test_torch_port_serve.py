"""The port's serve loop on the CPU, and the port's independence from JAX."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from micformer_tpu_torch import registry
from micformer_tpu_torch.cli import serve
from micformer_tpu_torch.data.nifti import read_nifti
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset
from micformer_tpu_torch.train.checkpoint import CheckpointManager
from micformer_tpu_torch.infer import sliding_window_inference
from micformer_tpu_torch.kernels import LAUNCHES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed_dim=12, depths=[1, 1], num_heads=[3, 6])


def test_serve_answers_npy_requests_on_cpu(tmp_path):
    model = registry.build("micformer", device="cpu", num_classes=8,
                           generator=torch.Generator().manual_seed(3), **TINY)
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    watch, out = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    vols = {}
    for i, name in enumerate(["case_a", "case_b"]):
        vols[name] = np.random.default_rng(i).normal(size=(2, 40, 36, 40)).astype(np.float32)
        path = watch / f"{name}.npy"
        np.save(path, vols[name])
        past = time.time() - 5
        os.utime(path, (past, past))
    before = dict(LAUNCHES)
    served = serve.main(["--weights", str(weights), "--model-kwargs", json.dumps(TINY),
                         "--device", "cpu", "--watch", str(watch), "--out", str(out),
                         "--roi", "32", "--sw-batch-size", "2", "--max-requests", "2",
                         "--poll", "0.05"])
    assert len(served) == 2
    assert LAUNCHES == before
    for name, vol in vols.items():
        logits = sliding_window_inference(torch.from_numpy(vol[None]), (32,) * 3, model,
                                          num_classes=8, sw_batch_size=2)
        seg = read_nifti(str(out / f"{name}_seg.nii.gz"))
        assert seg.dtype == np.uint8 and seg.shape == vol.shape[1:]
        np.testing.assert_array_equal(seg, logits.argmax(dim=1)[0].numpy())
        done = json.loads((out / f"{name}.done").read_text())
        assert done["request"] == name and done["latency_s"] > 0
        assert done["launches"] == {k: 0 for k in LAUNCHES}


def test_port_imports_no_jax_and_no_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import micformer_tpu_torch\n"
        "for m in pkgutil.walk_packages(micformer_tpu_torch.__path__, 'micformer_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, profile_torch_forward\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'sklearn', 'micformer_tpu')]\n"
        "print(sorted(n for n in sys.modules if n.startswith('micformer_tpu_torch')))\n"
        "print('BAD', sorted(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    for name in ("cli.serve", "models.mednext", "kernels.dw_conv3", "cli.train",
                 "train.trainer", "data.transforms", "kernels.fused_window_attention",
                 "losses.dice", "cli.predict", "cli.evaluate", "cli.ensemble",
                 "pipeline.evaluator", "pipeline.postprocess", "losses.metrics",
                 "parallel.distributed", "parallel.mesh", "parallel.spatial", "infer.sharded",
                 "models.generic_unet", "infer.sliding_window_2d", "ops.windows",
                 "models.unet3d", "models.nnformer", "models.swinunet3d", "models.vtunet",
                 "models.swinunetr", "models.transbts", "models.transunet", "ops.pe",
                 "parallel.tensor", "cli.export", "convert.aot_export", "convert.swin2d",
                 "cli.plan", "cli.preprocess", "pipeline.planner", "pipeline.preprocessing",
                 "pipeline.sanity_checks", "pipeline.model_selection", "data.brats", "utils",
                 "native", "convert.torch_import", "convert.zoo_import"):
        assert f"micformer_tpu_torch.{name}" in lines[0], name
    assert lines[-1] == "BAD []", lines[-1]


def _age(path):
    past = time.time() - 5
    os.utime(path, (past, past))


def _serve(source, watch, out, n, *extra):
    return serve.main([*source, "--device", "cpu", "--watch", str(watch), "--out", str(out),
                       "--roi", "16", "--target-shape", "24", "--sw-batch-size", "2",
                       "--max-requests", str(n), "--poll", "0.05", *extra])


def test_serve_from_a_trained_run_equals_serving_its_weights(tmp_path):
    """A run trained by the port's cli/train, served with --run-dir, answers
    .npy and NIfTI-pair requests as --weights does with the same params."""
    from micformer_tpu_torch.cli import train

    data = tmp_path / "mm"
    write_synthetic_dataset(str(data), n_cases=6, shape=(20, 20, 20), seed=1)
    run = tmp_path / "run"
    train.main(["--device", "cpu", "--data", str(data), "--cache", str(tmp_path / "c"),
                "--model", "micformer", "--model-kwargs", json.dumps(TINY),
                "--target-shape", "16", "--epochs", "1", "--val", "1", "--workers", "0",
                "--run-dir", str(run)])
    weights = tmp_path / "w.pt"
    torch.save(CheckpointManager(str(run)).restore_params_only("best_dice"), weights)
    watch = tmp_path / "in"
    watch.mkdir()
    np.save(watch / "vol.npy", np.random.default_rng(5).normal(size=(2, 20, 18, 16))
            .astype(np.float32))
    for f in ("ct_1003_image.nii.gz", "mr_1003_image.nii.gz"):
        (watch / f).write_bytes((data / f).read_bytes())
    for f in os.listdir(watch):
        _age(watch / f)
    _serve(["--run-dir", str(run)], watch, tmp_path / "a", 2)
    _serve(["--weights", str(weights), "--model-kwargs", json.dumps(TINY)], watch,
           tmp_path / "b", 2)
    for name, shape in (("vol", (20, 18, 16)), ("ct_1003", (24, 24, 24))):
        a = read_nifti(str(tmp_path / "a" / f"{name}_seg.nii.gz"))
        assert a.shape == shape
        np.testing.assert_array_equal(a, read_nifti(str(tmp_path / "b" / f"{name}_seg.nii.gz")))
    assert not (tmp_path / "a" / "mr_1003_image.nii.gz.error").exists()


@pytest.mark.parametrize("normalisation", ["minmax", "percentile", "zscore"])
def test_nifti_pair_request_loads_as_in_jax(tmp_path, normalisation):
    """float32 [2, D, H, W], within 1e-6 + 1e-6·|x| of the JAX loader: the
    same formulas, but the JAX package resizes with its native library when
    it is built, whose f32 roundings differ by an ulp."""
    from micformer_tpu.cli.serve import _load_request as jax_load

    write_synthetic_dataset(str(tmp_path), n_cases=1, shape=(21, 18, 25), seed=2)
    path = str(tmp_path / "ct_1001_image.nii.gz")
    name, got = serve._load_request(path, (16, 20, 24), normalisation)
    ref_name, ref = jax_load(path, (16, 20, 24), normalisation)
    assert name == ref_name == "ct_1001"
    assert got.dtype == np.float32 and got.shape == ref.shape == (2, 16, 20, 24)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_serve_takes_exactly_one_weight_source(tmp_path):
    model = registry.build("micformer", device="cpu", **TINY)
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    for source in ([], ["--weights", str(weights), "--run-dir", str(tmp_path)]):
        with pytest.raises(SystemExit):
            _serve(source, tmp_path / "in", tmp_path / "out", 1)
    with pytest.raises(SystemExit):
        _serve(["--exported", str(tmp_path), "--weights", str(weights)], tmp_path / "in",
               tmp_path / "out", 1)
