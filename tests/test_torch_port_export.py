"""The port's kernels as custom ops, and its serving artifacts on the CPU:
`torch.library.opcheck` on K1, K2 and K3 (their fakes' shapes, dtypes and
strides), `convert/aot_export.py` against the live pipeline after a save and
a load in a fresh process, and cli/export with cli/serve --exported."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from micformer_tpu_torch import registry
from micformer_tpu_torch.config import Config, save_config
from micformer_tpu_torch.convert import aot_export
from micformer_tpu_torch.kernels import CALLS, LAUNCHES
from micformer_tpu_torch.kernels import window_attention as k1
from micformer_tpu_torch.kernels.dw_conv3 import dw_conv3_op
from micformer_tpu_torch.kernels.fused_window_attention import fused_window_attention_op
from micformer_tpu_torch.kernels.window_attention import window_attention_op

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed_dim=12, depths=[1, 1], num_heads=[3, 6])
SHAPE = (32, 32, 40)          # two tiles of roi 32: one predictor call at sw_batch 2
ROI = (32, 32, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


OPCHECK_CASES = {
    # K1 on dense [N, T, h, d], and on q, k, v as slices of one fused qkv
    # projection [N, T, 3, h, d] (the MicFormer path's layout)
    "k1_contiguous": lambda: (window_attention_op,
                              (_randn(5, 8, 3, 16), _randn(5, 8, 3, 16, seed=1),
                               _randn(5, 8, 3, 16, seed=2), None)),
    "k1_qkv_slices": lambda: (window_attention_op,
                              tuple(_randn(5, 8, 3, 3, 16).unbind(2)) + (0.25,)),
    "k1_cross": lambda: (window_attention_op,
                         (_randn(4, 8, 2, 8),) + tuple(_randn(4, 4, 2, 2, 8, seed=3).unbind(2))
                         + (None,)),
    # K2 on dense [N, h, T, d], and on head-inside-token views (the
    # --fused-attention path), whose output follows q's layout
    "k2_contiguous": lambda: (fused_window_attention_op,
                              (_randn(5, 3, 8, 16), _randn(5, 3, 8, 16, seed=1),
                               _randn(5, 3, 8, 16, seed=2), None)),
    "k2_token_major": lambda: (fused_window_attention_op,
                               tuple(t.transpose(1, 2) for t in
                                     _randn(5, 8, 3, 3, 16).unbind(2)) + (None,)),
    "k3_bias": lambda: (dw_conv3_op, (_randn(1, 4, 6, 7, 5), _randn(4, 1, 3, 3, 3, seed=1),
                                      _randn(4, seed=2))),
    "k3_k5_no_bias": lambda: (dw_conv3_op, (_randn(2, 3, 5, 6, 7),
                                            _randn(3, 1, 5, 5, 5, seed=1), None)),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_custom_op_opcheck(case):
    """Schema, fake tensor (shape, dtype and strides of the real output) and
    AOT dispatch of each op on CPU tensors."""
    op, args = OPCHECK_CASES[case]()
    res = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in res.values()), res


def test_k2_op_output_follows_q_layout():
    q, k, v = (t.transpose(1, 2) for t in _randn(5, 8, 3, 3, 16).unbind(2))
    out = fused_window_attention_op(q, k, v, None)
    assert out.stride() == (8 * 3 * 16, 16, 3 * 16, 1)
    assert out.transpose(1, 2).is_contiguous()


def test_wrappers_count_calls_and_no_launches_on_cpu():
    from micformer_tpu_torch.kernels.dw_conv3 import dw_conv3
    from micformer_tpu_torch.kernels.fused_window_attention import fused_window_attention

    before, launches = dict(CALLS), dict(LAUNCHES)
    q = _randn(4, 8, 3, 16)
    k1.window_attention(q, q, q)
    fused_window_attention(q, q, q)
    dw_conv3(_randn(1, 2, 4, 4, 4), _randn(2, 1, 3, 3, 3))
    assert {n: CALLS[n] - before[n] for n in CALLS} == dict.fromkeys(CALLS, 1)
    assert LAUNCHES == launches


def _model(name="micformer", seed=3, **kw):
    kw = dict(TINY, **kw) if name == "micformer" else dict({"n_channels": 4}, **kw)
    return registry.build(name, device="cpu", num_classes=8,
                          generator=torch.Generator().manual_seed(seed), **kw)


def _live(model, x, argmax):
    with torch.no_grad():
        return aot_export.build_inference_fn(model, roi=ROI, sw_batch_size=2,
                                             argmax=argmax)(x)


LOAD_AND_RUN = """
import json, sys, numpy as np, torch
from micformer_tpu_torch.convert.aot_export import load_artifact, op_nodes
from micformer_tpu_torch.kernels import LAUNCHES
fn, meta = load_artifact(sys.argv[1])
with torch.no_grad():
    out = fn(torch.from_numpy(np.load(sys.argv[2])))
np.save(sys.argv[3], out.numpy())
print(meta["output"], meta["platforms"], sum(LAUNCHES.values()))
print(json.dumps(op_nodes(fn)))
print(sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax",
      "micformer_tpu") or n.startswith("micformer_tpu_torch.models")))
"""


@pytest.mark.parametrize("name,argmax", [("micformer", True), ("micformer", False),
                                         ("mednext", False)])
def test_artifact_round_trip_in_a_fresh_process(tmp_path, name, argmax):
    """Export on the CPU, then load and run in a process that imports
    neither JAX, nor the JAX package, nor the port's models: the artifact
    equals the live pipeline (argmax exactly; logits within atol 1e-5,
    rtol 5e-4) and its graph holds the op nodes of the model's kernels."""
    model = _model(name)
    art = tmp_path / "art"
    before = dict(CALLS)
    meta = aot_export.export_artifact(str(art), model, target_shape=SHAPE, roi=ROI,
                                      sw_batch_size=2, argmax=argmax, model_name=name)
    assert meta["platforms"] == ["cpu"] and meta["input_shape"] == [1, 2, *SHAPE]
    assert meta["version"] == aot_export.VERSION and "torch_version" in meta
    assert meta["output"] == ("argmax_uint8" if argmax else "logits_f32")
    traced = {n: CALLS[n] - before[n] for n in aot_export.OPS}
    x = _randn(1, 2, *SHAPE, seed=7)
    np.save(tmp_path / "x.npy", x.numpy())
    res = subprocess.run([sys.executable, "-c", LOAD_AND_RUN, str(art), str(tmp_path / "x.npy"),
                          str(tmp_path / "y.npy")], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    first, nodes, bad = res.stdout.strip().splitlines()[-3:]
    assert first == f"{meta['output']} ['cpu'] 0"
    nodes = json.loads(nodes)
    want = {"micformer": {"window_attention": 16, "fused_window_attention": 0, "dw_conv3": 0},
            "mednext": {"window_attention": 0, "fused_window_attention": 0, "dw_conv3": 18}}
    # one op node a traced wrapper call, and no softmax chain of a plain version
    assert nodes == dict(want[name], softmax=0) and want[name] == traced
    assert bad == "[]"
    got = np.load(tmp_path / "y.npy")
    ref = _live(model, x, argmax).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if argmax:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=5e-4)


def test_export_refuses_a_kernel_traced_as_plain_math(tmp_path, monkeypatch):
    """A forward wrapper whose op is bypassed (its plain version inlined)
    leaves no op node: the export raises instead of writing an artifact
    that would never launch the kernel."""
    monkeypatch.setattr(k1, "window_attention_op", k1.window_attention_reference)
    with pytest.raises(RuntimeError, match="traced as plain math"):
        aot_export.export_artifact(str(tmp_path / "art"), _model(), target_shape=SHAPE,
                                   roi=ROI, sw_batch_size=2)
    assert not (tmp_path / "art").exists()


def test_type_hints_are_computed_once_a_class_during_a_load_only():
    """load_artifact's cache of typing.get_type_hints: one result a class
    and arguments while it runs, unhashable objects passed through, and
    typing's own function back afterwards."""
    import typing

    class Hinted:
        x: int
        __hash__ = None          # instances are unhashable

    get = typing.get_type_hints
    with aot_export._type_hints_once():
        first = typing.get_type_hints(Hinted)
        assert first == {"x": int} and typing.get_type_hints(Hinted) is first
        assert typing.get_type_hints(Hinted, include_extras=True) == first
        assert typing.get_type_hints(Hinted()) == {"x": int}
    assert typing.get_type_hints is get


def test_load_refuses_a_newer_artifact(tmp_path):
    art = tmp_path / "art"
    art.mkdir()
    (art / "meta.json").write_text(json.dumps({"version": aot_export.VERSION + 1}))
    with pytest.raises(ValueError, match="newer than"):
        aot_export.load_artifact(str(art))


def _run_dir(path, model):
    cfg = Config()
    cfg.model.name = "micformer"
    cfg.model.embed_dim = TINY["embed_dim"]
    cfg.model.extra = {k: v for k, v in TINY.items() if k != "embed_dim"}
    save_config(cfg, str(path / "config.json"))
    torch.save(model.state_dict(), path / "ckpt_best_dice.pt")
    return path


def test_cli_export_then_serve_exported_answers_as_serve_run_dir(tmp_path):
    """cli/export of a run, then cli/serve --exported on a .npy request: the
    segmentation of cli/serve --run-dir on the same run and flags; the
    .done line holds the latency and the (zero) launches of the CPU, and
    serve's report the load seconds and the loaded graph's op nodes."""
    from micformer_tpu_torch.cli import export, serve
    from micformer_tpu_torch.data.nifti import read_nifti

    run = _run_dir(tmp_path, _model(seed=5))
    flags = ["--roi", "32", "--sw-batch-size", "2"]
    meta = export.main(["--run-dir", str(run), "--out", str(tmp_path / "art"), "--device",
                        "cpu", "--target-shape", "32", *flags])
    assert meta["model"] == "micformer" and meta["input_shape"] == [1, 2, 32, 32, 32]
    watch = tmp_path / "in"
    watch.mkdir()
    np.save(watch / "vol.npy", _randn(2, 32, 32, 32, seed=9).numpy())
    past = time.time() - 5
    os.utime(watch / "vol.npy", (past, past))
    common = ["--device", "cpu", "--watch", str(watch), "--max-requests", "1", "--poll", "0.05"]
    report = {}
    lat = serve.main(["--exported", str(tmp_path / "art"), "--out", str(tmp_path / "a"),
                      *common], report=report)
    serve.main(["--run-dir", str(run), "--out", str(tmp_path / "b"), *flags, *common])
    assert len(lat) == 1
    assert report["model"] == "micformer" and report["load_s"] > 0
    assert report["op_nodes"] == {"window_attention": 16, "fused_window_attention": 0,
                                  "dw_conv3": 0, "softmax": 0}
    a = read_nifti(str(tmp_path / "a" / "vol_seg.nii.gz"))
    assert a.shape == (32, 32, 32) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, read_nifti(str(tmp_path / "b" / "vol_seg.nii.gz")))
    done = json.loads((tmp_path / "a" / "vol.done").read_text())
    assert done["latency_s"] > 0 and done["launches"] == {k: 0 for k in LAUNCHES}


def test_serve_exported_refuses_logits_and_another_device(tmp_path):
    from micformer_tpu_torch.cli import serve

    # a stand-in program: serve reads the meta before it runs anything
    art = tmp_path / "logits"
    art.mkdir()
    torch.export.save(torch.export.export(torch.nn.Identity(), (torch.zeros(1),)),
                      str(art / "module.pt2"))
    (art / "meta.json").write_text(json.dumps({
        "version": aot_export.VERSION, "output": "logits_f32", "platforms": ["cpu"],
        "input_shape": [1, 2, 32, 32, 32], "roi": list(ROI), "sw_batch_size": 1}))
    common = ["--watch", str(tmp_path / "in"), "--out", str(tmp_path / "out"),
              "--max-requests", "1"]
    with pytest.raises(SystemExit, match="argmax artifact"):
        serve.main(["--exported", str(tmp_path / "logits"), "--device", "cpu", *common])
    meta_path = tmp_path / "logits" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps(dict(meta, output="argmax_uint8")))
    with pytest.raises(SystemExit, match="runs on \\['cpu'\\]"):
        serve.main(["--exported", str(tmp_path / "logits"), "--device", "cuda", *common])
