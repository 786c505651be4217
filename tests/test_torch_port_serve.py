"""The port's serve loop on the CPU, and the port's independence from JAX."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from micformer_tpu_torch import registry
from micformer_tpu_torch.cli import serve
from micformer_tpu_torch.data.nifti import read_nifti
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
                 "losses.dice"):
        assert f"micformer_tpu_torch.{name}" in lines[0], name
    assert lines[-1] == "BAD []", lines[-1]
