"""Export's `--platforms` on the CPU: an artifact holds one `torch.export`
program for each platform it lists (`convert/aot_export.py`), and the load
picks the program of the device it is asked for.

A `--platforms cpu` artifact of a tiny MicFormer run (built on the CPU
whatever --device says) serves as `serve --run-dir` does, 0 voxels differing;
its meta lists its platforms and programs; `--platforms cuda` (alone or
beside cpu) raises on a host without a card before anything is written; a
version 1 artifact (one `module.pt2`) still loads and serves; a two-program
artifact gives each device its own program and refuses another. A real
`cuda cpu` artifact needs the card: `chip_smoke.py` exports and serves one.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from micformer_tpu_torch import registry
from micformer_tpu_torch.cli import export, serve
from micformer_tpu_torch.config import Config, save_config
from micformer_tpu_torch.convert import aot_export
from micformer_tpu_torch.data.nifti import read_nifti

TINY = dict(embed_dim=12, depths=[1, 1], num_heads=[3, 6])
FLAGS = ["--target-shape", "32", "--roi", "32", "--sw-batch-size", "2"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A run dir of a tiny MicFormer (config.json, ckpt_best_dice.pt)."""
    path = tmp_path_factory.mktemp("run")
    cfg = Config()
    cfg.model.name = "micformer"
    cfg.model.embed_dim = TINY["embed_dim"]
    cfg.model.extra = {k: v for k, v in TINY.items() if k != "embed_dim"}
    save_config(cfg, str(path / "config.json"))
    model = registry.build("micformer", device="cpu", num_classes=8,
                           generator=torch.Generator().manual_seed(5), **TINY)
    torch.save(model.state_dict(), path / "ckpt_best_dice.pt")
    return path


@pytest.fixture(scope="module")
def artifact(run, tmp_path_factory):
    """cli/export --platforms cpu of the run, with --device left at cuda."""
    out = tmp_path_factory.mktemp("art") / "art"
    meta = export.main(["--run-dir", str(run), "--out", str(out), "--platforms", "cpu", *FLAGS])
    return out, meta


def _serve(tmp_path, out, *source):
    """serve on one [2, 32³] request: its label map."""
    watch = tmp_path / "in"
    if not watch.exists():
        watch.mkdir()
        np.save(watch / "vol.npy",
                np.random.default_rng(9).normal(size=(2, 32, 32, 32)).astype(np.float32))
        past = time.time() - 5
        os.utime(watch / "vol.npy", (past, past))
    serve.main([*source, "--out", str(tmp_path / out), "--device", "cpu", "--watch", str(watch),
                "--max-requests", "1", "--poll", "0.05"])
    return read_nifti(str(tmp_path / out / "vol_seg.nii.gz"))


def test_cpu_artifact_serves_as_live_serving(artifact, run, tmp_path):
    art, meta = artifact
    assert meta["platforms"] == ["cpu"] and meta["programs"] == {"cpu": "module.cpu.pt2"}
    assert sorted(os.listdir(art)) == ["meta.json", "module.cpu.pt2"]
    assert json.loads((art / "meta.json").read_text()) == meta
    got = _serve(tmp_path, "exported", "--exported", str(art))
    want = _serve(tmp_path, "live", "--run-dir", str(run), *FLAGS[2:])
    assert got.shape == (32, 32, 32)
    assert int(np.count_nonzero(got != want)) == 0


@pytest.mark.parametrize("platforms", [["cuda"], ["cpu", "cuda"]])
def test_cuda_without_a_card_raises_before_writing(run, tmp_path, monkeypatch, platforms):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.main(["--run-dir", str(run), "--out", str(tmp_path / "art"), "--device", "cpu",
                     "--platforms", *platforms, *FLAGS])
    assert not (tmp_path / "art").exists()
    model = registry.build("micformer", device="cpu", num_classes=8, **TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aot_export.export_artifact(str(tmp_path / "art"), model, target_shape=(32,) * 3,
                                   roi=(32,) * 3, platforms=platforms)
    assert not (tmp_path / "art").exists()


def test_version_1_artifact_still_loads(artifact, tmp_path):
    """The layout written before artifacts held a program a platform: one
    `module.pt2`, version 1, no "programs"."""
    art, meta = artifact
    old = tmp_path / "old"
    old.mkdir()
    shutil.copy(art / "module.cpu.pt2", old / "module.pt2")
    (old / "meta.json").write_text(json.dumps(
        {k: v for k, v in dict(meta, version=1).items() if k != "programs"}))
    fn, got_meta = aot_export.load_artifact(str(old))
    assert got_meta["programs"] == {"cpu": "module.pt2"} and got_meta["version"] == 1
    seg = _serve(tmp_path, "old_out", "--exported", str(old))
    x = torch.from_numpy(np.load(tmp_path / "in" / "vol.npy")[None])
    with torch.no_grad():
        np.testing.assert_array_equal(fn(x)[0].numpy(), seg)


class _Add(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c

    def forward(self, x):
        return x + self.c


def test_load_picks_the_devices_program(tmp_path, monkeypatch):
    """A two-platform artifact: each device gets its own program (here two
    CPU stand-ins that add 1 and 2); by default the card's, which raises on
    a host without one (nothing falls back to the cpu program); a device it
    holds no program for raises."""
    art = tmp_path / "two"
    art.mkdir()
    for name, c in (("cuda", 1.0), ("cpu", 2.0)):
        torch.export.save(torch.export.export(_Add(c), (torch.zeros(2),)),
                          str(art / f"module.{name}.pt2"))
    (art / "meta.json").write_text(json.dumps({
        "version": aot_export.VERSION, "output": "logits_f32", "platforms": ["cuda", "cpu"],
        "programs": {"cuda": "module.cuda.pt2", "cpu": "module.cpu.pt2"}}))
    x = torch.zeros(2)
    for device, c in (("cuda", 1.0), ("cpu", 2.0)):
        fn, meta = aot_export.load_artifact(str(art), device=device)
        assert fn(x).tolist() == [c, c] and meta["platforms"] == ["cuda", "cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fn, _ = aot_export.load_artifact(str(art))
    assert fn(x).tolist() == [1.0, 1.0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aot_export.load_artifact(str(art))
    meta = json.loads((art / "meta.json").read_text())
    (art / "meta.json").write_text(json.dumps(dict(meta, platforms=["cuda"],
                                                   programs={"cuda": "module.cuda.pt2"})))
    with pytest.raises(ValueError, match="runs on \\['cuda'\\], not on cpu"):
        aot_export.load_artifact(str(art), device="cpu")
