"""The port's host helpers and small public API against the JAX package's.

`enable_nan_debugging` (a NaN made by a forward op and one made in a
backward raise FloatingPointError naming the op; off again, neither does);
`slice_montage`, `export_csv`, `get_run_dataframe` (and None without pandas),
`load_nii`, `save_metrics` (its scalars and val.txt) and `shifted_window_mask`
equal the JAX functions' outputs on the same input, exactly; the TensorBoard
mirror writes an event file (in a subprocess: importing
torch.utils.tensorboard loads TensorFlow here, seconds and hundreds of MB);
and each package of the port offers the names the JAX package's
`__init__.py` exports, without building anything at import.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from micformer_tpu.data import nifti as jnifti
from micformer_tpu.ops import windows as jw
from micformer_tpu.train import logging as jlog
from micformer_tpu.train import run_export as jrun
from micformer_tpu_torch.data import nifti as tnifti
from micformer_tpu_torch.ops import windows as tw
from micformer_tpu_torch.train import logging as tlog
from micformer_tpu_torch.train import run_export as trun
from micformer_tpu_torch.train.profiling import enable_nan_debugging

from test_torch_port_completeness import JAX, NOT_PORTED, RENAMED, jax_surface

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def nan_debugging():
    enable_nan_debugging()
    try:
        yield
    finally:
        enable_nan_debugging(False)


def _nan_backward():
    """sqrt at 0 times 0: a finite forward, 0 / 0 in sqrt's backward."""
    x = torch.tensor(0.0, requires_grad=True)
    (torch.sqrt(x) * 0).backward()
    return x.grad


def test_nan_debugging_raises_naming_the_op(nan_debugging):
    with pytest.raises(FloatingPointError, match="aten.log"):
        torch.log(torch.tensor(-1.0))
    with pytest.raises(FloatingPointError, match="aten.div"):
        _nan_backward()
    assert torch.exp(torch.tensor(1.0)).item() == pytest.approx(np.e)


def test_nan_debugging_off_restores_normal_dispatch():
    enable_nan_debugging()
    enable_nan_debugging(False)
    enable_nan_debugging(False)          # off twice is off
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    assert torch.isnan(_nan_backward())


@pytest.mark.parametrize("shape,n,axis", [((7, 5, 6), 4, 0), ((2, 9, 4, 5), 3, 1),
                                          ((6, 6, 6), 8, 2)])
def test_slice_montage_equals_jax(shape, n, axis):
    v = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = tlog.slice_montage(v, n_slices=n, axis=axis)
    want = jlog.slice_montage(v, n_slices=n, axis=axis)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_export_csv_equals_jax(tmp_path):
    rows = [{"case": "a", "dice": 0.5, "hd95": 3}, {"case": "b", "dice": 0.25, "hd95": 1.5}]
    tlog.export_csv(rows, str(tmp_path / "port" / "m.csv"))
    jlog.export_csv(rows, str(tmp_path / "jax" / "m.csv"))
    assert (tmp_path / "port" / "m.csv").read_bytes() == (tmp_path / "jax" / "m.csv").read_bytes()
    tlog.export_csv([], str(tmp_path / "none" / "m.csv"))
    assert not (tmp_path / "none").exists()


def _run_dir(path):
    path.mkdir()
    with open(path / "events.jsonl", "w") as f:
        for step in range(3):
            f.write(json.dumps({"tag": "val/meandice", "value": 0.1 * step, "step": step}) + "\n")
    with open(path / "log.jsonl", "w") as f:
        for epoch in range(3):
            f.write(json.dumps({"epoch": epoch, "loss": 1.0 / (epoch + 1), "nan": False,
                                "lr": 1e-3}) + "\n")
    return str(path)


def test_get_run_dataframe_equals_jax(tmp_path, monkeypatch):
    run = _run_dir(tmp_path / "run")
    got, want = trun.get_run_dataframe(run), jrun.get_run_dataframe(run)
    assert list(got.columns) == list(want.columns) and len(got) == 3
    assert got.to_dict("list") == want.to_dict("list")
    monkeypatch.setitem(sys.modules, "pandas", None)
    assert trun.get_run_dataframe(run) is None and jrun.get_run_dataframe(run) is None


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
def test_load_nii_equals_jax(tmp_path, dtype):
    a = (np.random.default_rng(1).normal(size=(5, 6, 7)) * 40).astype(dtype)
    path = str(tmp_path / "v.nii.gz")
    jnifti.write_nifti(path, a)
    got, want = tnifti.load_nii(path), jnifti.load_nii(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_save_metrics_equals_jax(tmp_path):
    """The scalars (events.jsonl) and val.txt of two epochs, JSONL writers."""
    dice = np.random.default_rng(2).uniform(size=(3, 4)).astype(np.float32)
    names = ["bg", "lv", "rv", "la"]
    for side, mod in (("port", tlog), ("jax", jlog)):
        run = str(tmp_path / side)
        writer = mod.MetricsWriter(run, tensorboard=False)
        for epoch in (0, 1):
            mod.save_metrics(writer, dice * (epoch + 1) / 2, names, epoch, run, teacher=False)
        writer.close()
    for name in ("events.jsonl", "val.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


@pytest.mark.parametrize("dims,window,shift", [
    ((8, 8, 8), (4, 4, 4), (2, 2, 2)), ((8, 8, 8), (4, 4, 4), (0, 0, 0)),
    ((8, 4, 12), (2, 4, 4), (1, 2, 2)), ((4, 4, 8), (4, 4, 4), (0, 0, 2))])
def test_shifted_window_mask_equals_jax(dims, window, shift):
    got = tw.shifted_window_mask(dims, window, shift)
    want = jw.shifted_window_mask(dims, window, shift)
    if want is None:
        assert got is None
        return
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


TENSORBOARD = """
import os, sys
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
from micformer_tpu_torch.train.logging import MetricsWriter, save_metrics
run = sys.argv[1]
w = MetricsWriter(run)
w.scalar("train/loss", 0.5, 1)
fig, ax = plt.subplots()
ax.plot([0, 1])
w.figure("fig/line", fig, 1)
w.image("img/montage", np.zeros((4, 6, 1), np.float32), 1)
save_metrics(w, np.full((2, 3), 0.5), ["a", "b", "c"], 2, run)
w.close()
print(w._tb is not None)
"""


def test_tensorboard_mirror_writes_an_event_file(tmp_path):
    run = tmp_path / "run"
    res = subprocess.run([sys.executable, "-c", TENSORBOARD, str(run)], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1", TF_CPP_MIN_LOG_LEVEL="3"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-1] == "True"
    events = [f for f in os.listdir(run) if f.startswith("events.out.tfevents")]
    assert len(events) == 1
    data = (run / events[0]).read_bytes()
    for tag in (b"train/loss", b"fig/line", b"img/montage", b"val/dice_a",
                b"val/dice_per_class"):
        assert tag in data, tag
    assert (run / "val.txt").read_text() == "Epoch 2: a=0.5000, b=0.5000, c=0.5000\n"
    assert len((run / "events.jsonl").read_text().splitlines()) == 4


IMPORTS = """
import json, subprocess, sys
calls = []
_init = subprocess.Popen.__init__
def spy(self, *a, **k):
    calls.append(str(a[0] if a else k.get("args")))
    _init(self, *a, **k)
subprocess.Popen.__init__ = spy
import importlib
want = json.loads(sys.argv[1])
missing = []
for pkg, names in want.items():
    mod = importlib.import_module(pkg)
    missing += [f"{pkg}.{n}" for n in names if not hasattr(mod, n)]
from micformer_tpu_torch import native
from micformer_tpu_torch.kernels import _build
print(json.dumps({"missing": missing, "processes": calls, "kernels": sorted(_build._loaded),
                  "native": native._lib is not None,
                  "jax": sorted(n for n in sys.modules if n.split(".")[0] in
                                ("jax", "flax", "micformer_tpu"))}))
"""


def test_packages_export_the_jax_names_and_build_nothing():
    """Each name a JAX `__init__.py` exports resolves on the port's package
    (under its own name or the RENAMED one; NOT_PORTED plumbing aside), the
    lazily loaded ones included, in a fresh process that starts no compiler
    and loads no library."""
    want = {}
    for init in sorted(JAX.rglob("__init__.py")):
        rel = init.relative_to(JAX).as_posix()
        names = []
        for name in sorted(jax_surface(init)):
            if (rel, name) in NOT_PORTED:
                continue
            names.append(RENAMED.get((rel, name), (rel, name))[1])
        if names:
            want[".".join(["micformer_tpu_torch", *init.relative_to(JAX).parent.parts])] = names
    assert want["micformer_tpu_torch"] == ["build_model", "registry"]
    assert "tensor_parallel_apply" in want["micformer_tpu_torch.parallel"]
    res = subprocess.run([sys.executable, "-c", IMPORTS, json.dumps(want)], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"missing": [], "processes": [], "kernels": [], "native": False, "jax": []}
