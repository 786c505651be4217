"""The port's prediction path on the CPU against the JAX package's: batched
mirror TTA, and the predict CLI on converted weights of a tiny MicFormer
(embed 24, two stages) over the same synthetic MM-WHS root.

Tolerances: logits of batched TTA within 1e-4 of JAX's and 1e-5 of the
port's serial TTA (f32 sums in another order); the CLIs' softmax files
within 1e-3 (f16 storage, whose step near 1 is 4.9e-4); label maps equal
wherever the top-2 margin of JAX's probabilities exceeds 2e-3. The JAX
package's MICFORMER_* flags are cleared before it is imported, so it runs its
default forms (and serial TTA unless a test asks for the batched one).
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import dataclasses  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from micformer_tpu import config as jcfg  # noqa: E402
from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu.cli import predict as jpredict  # noqa: E402
from micformer_tpu.data import cascade as jcascade  # noqa: E402
from micformer_tpu.data.image_utils import resize_trilinear as jresize  # noqa: E402
from micformer_tpu.infer import sliding_window as jsw  # noqa: E402
from micformer_tpu.train.checkpoint import CheckpointManager as JCheckpoints  # noqa: E402
from micformer_tpu_torch import config as tcfg  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.cli import predict as tpredict  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.data import cascade as tcascade  # noqa: E402
from micformer_tpu_torch.data.nifti import read_nifti  # noqa: E402
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from micformer_tpu_torch.infer import sliding_window as tsw  # noqa: E402
from micformer_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

EXTRA = dict(depths=(1, 1), num_heads=(3, 6))
TINY = dict(num_classes=8, embed_dim=24, **EXTRA)
# a source grid unlike the model's, with a world transform that is not the
# identity, so --native-geometry resamples and writes the source affine
SOURCE = (20, 24, 28)
AFFINE = np.array([[0.0, -1.25, 0.0, 31.0], [1.5, 0.0, 0.0, -14.5],
                   [0.0, 0.0, 2.0, 7.25], [0.0, 0.0, 0.0, 1.0]])
GRID = ["--target-shape", "32", "--roi", "32", "--sw-batch-size", "2"]


def _arr(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def folds():
    """Two folds of the tiny MicFormer: (JAX params, the port's state_dict).
    Weights are drawn with numpy into the tree `init` would make (nothing is
    compiled): kernels of variance 1/fan_in, biases around 0, norm scales
    around 1."""
    jmodel = jreg.build("micformer", **TINY)
    tmodel = treg.build("micformer", device="cpu", **TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 2, 32, 32, 32)))["params"]
    out = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        flat = {}
        for key, sd in flatten_dict(shapes).items():
            z = rng.normal(size=sd.shape).astype(np.float32)
            flat[key] = (z / np.sqrt(np.prod(sd.shape[:-1])) if key[-1] == "kernel"
                         else 0.1 * z + (1.0 if key[-1] == "scale" else 0.0))
        params = unflatten_dict(flat)
        out.append((params, state_dict_from_flax(params, tmodel)))
    return out


@pytest.fixture(scope="module")
def runs(folds, tmp_path_factory):
    """Per fold, a JAX run dir (orbax checkpoint, config.yaml) and a port
    run dir (ckpt_best_dice.pt, config.json) holding the same weights."""
    root = tmp_path_factory.mktemp("runs")
    out = []
    for k, (params, sd) in enumerate(folds):
        jdir, tdir = str(root / f"jax{k}"), str(root / f"port{k}")
        JCheckpoints(jdir).save("best_dice", {"params": params})
        cfg = jcfg.Config()
        cfg.model.embed_dim = 24
        cfg.model.extra = {k_: list(v) for k_, v in EXTRA.items()}
        jcfg.save_config(cfg, os.path.join(jdir, "config.yaml"))
        cfg = tcfg.Config()
        cfg.model.embed_dim = 24
        cfg.model.extra = {k_: list(v) for k_, v in EXTRA.items()}
        tcfg.save_config(cfg, os.path.join(tdir, "config.json"))
        CheckpointManager(tdir).save("best_dice", {"params": sd, "step": 3}, metric=0.5)
        out.append((jdir, tdir))
    return out


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """15 synthetic cases, so the 5-fold split's test fold holds two."""
    root = str(tmp_path_factory.mktemp("mmwhs"))
    write_synthetic_dataset(root, n_cases=15, shape=SOURCE, seed=4, affine=AFFINE)
    return root


def _predict_both(data_root, runs, out, folds_used, extra):
    """Run the JAX and the port predict CLIs with the same arguments; returns
    the two output dirs."""
    dirs = {}
    for side, main, idx in (("jax", jpredict.main, 0), ("port", tpredict.main, 1)):
        d = os.path.join(out, side)
        args = ["--data", data_root, "--cache", os.path.join(data_root, f"cache_{side}"),
                "--run-dirs", *[runs[k][idx] for k in folds_used], "--out", d, *GRID, *extra]
        main(args + (["--device", "cpu"] if side == "port" else []))
        dirs[side] = d
    return dirs["jax"], dirs["port"]


def _margin(probs):
    top2 = np.sort(probs, axis=0)[-2:]
    return top2[1] - top2[0]


def _check_outputs(jdir, tdir, native=False):
    pids = sorted(f[: -len("_pred.nii.gz")] for f in os.listdir(jdir)
                  if f.endswith("_pred.nii.gz"))
    assert len(pids) == 2
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for pid in pids:
        jsm = np.load(os.path.join(jdir, f"{pid}_softmax.npz"))["softmax"]
        tsm = np.load(os.path.join(tdir, f"{pid}_softmax.npz"))["softmax"]
        assert tsm.dtype == np.float16 and tsm.shape == jsm.shape == (8, 32, 32, 32)
        np.testing.assert_allclose(tsm.astype(np.float32), jsm.astype(np.float32), atol=1e-3)
        jseg, jhdr = read_nifti(os.path.join(jdir, f"{pid}_pred.nii.gz"), with_header=True)
        tseg, thdr = read_nifti(os.path.join(tdir, f"{pid}_pred.nii.gz"), with_header=True)
        assert tseg.dtype == jseg.dtype == np.uint8 and tseg.shape == jseg.shape
        probs = jsm.astype(np.float32)
        if native:
            assert tseg.shape == SOURCE
            np.testing.assert_allclose(thdr.affine, AFFINE, atol=1e-5)
            probs = jresize(probs, SOURCE)
        sure = _margin(probs) > 2e-3
        assert sure.mean() > 0.25    # the comparison covers much of the volume
        np.testing.assert_array_equal(tseg[sure], jseg[sure])
    return pids


def test_batched_tta_matches_jax_and_serial(folds, monkeypatch):
    params, sd = folds[0]
    jmodel = jreg.build("micformer", **TINY)
    tmodel = treg.build("micformer", device="cpu", **TINY)
    tmodel.load_state_dict(sd)
    vol = _arr(1, (1, 2, 32, 32, 40))   # two tiles: one chunk at sw_batch 2
    kw = dict(num_classes=8, sw_batch_size=2, mirror_tta=True)
    ref = np.asarray(jax.jit(lambda v: jsw.sliding_window_inference(
        v, (32,) * 3, lambda w: jmodel.apply({"params": params}, w), tta_batched=True,
        **kw))(jnp.asarray(vol)))
    calls = []

    def predictor(w):
        calls.append(w.shape[0])
        return tmodel(w)

    got = tsw.sliding_window_inference(torch.from_numpy(vol), (32,) * 3, predictor,
                                       tta_batched=True, **kw)
    assert calls == [16]          # the 8 flips of 2 tiles in one forward
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    calls.clear()
    serial = tsw.sliding_window_inference(torch.from_numpy(vol), (32,) * 3, predictor,
                                          tta_batched=False, **kw)
    assert calls == [2] * 8
    np.testing.assert_allclose(got.numpy(), serial.numpy(), atol=1e-5)
    # None reads MICFORMER_TTA_BATCHED, as the JAX function does
    calls.clear()
    monkeypatch.setenv("MICFORMER_TTA_BATCHED", "1")
    env = tsw.sliding_window_inference(torch.from_numpy(vol), (32,) * 3, predictor, **kw)
    assert calls == [16]
    np.testing.assert_array_equal(env.numpy(), got.numpy())


@pytest.mark.parametrize("case", ["single", "ensemble_native"])
def test_predict_cli_matches_jax(data_root, runs, tmp_path, case):
    """One fold with mirror TTA, the cascade's and the overlay files; and a
    two-fold ensemble resampled to the source geometry."""
    if case == "single":
        folds_used = [0]
        extra = ["--mirror-tta", "--save-seg-for-next-stage", "--overlays"]
    else:
        folds_used = [0, 1]
        extra = ["--native-geometry"]
    jdir, tdir = _predict_both(data_root, runs, str(tmp_path), folds_used,
                               extra + ["--largest-cc", "--save-softmax"])
    pids = _check_outputs(jdir, tdir, native=case != "single")
    if case == "single":
        for pid in pids:
            jseg = np.load(os.path.join(jdir, f"{pid}_segFromPrevStage.npy"))
            tseg = np.load(os.path.join(tdir, f"{pid}_segFromPrevStage.npy"))
            assert tseg.dtype == jseg.dtype == np.uint8 and tseg.shape == (32, 32, 32)
            jsm = np.load(os.path.join(jdir, f"{pid}_softmax.npz"))["softmax"]
            sure = _margin(jsm.astype(np.float32)) > 2e-3
            np.testing.assert_array_equal(tseg[sure], jseg[sure])


def test_cascade_stage_matches_jax(data_root, runs, tmp_path):
    """Both CLIs read the same previous-stage files (from a first stage of
    the other fold) and append their one-hot; MicFormer reads channels 0 and
    1 only, as the JAX model does."""
    prev = str(tmp_path / "prev")
    tpredict.main(["--data", data_root, "--cache", os.path.join(data_root, "cache_port"),
                   "--run-dirs", runs[1][1], "--out", prev, "--device", "cpu", *GRID,
                   "--save-seg-for-next-stage"])
    jdir, tdir = _predict_both(data_root, runs, str(tmp_path), [0],
                               ["--cascade-prev-seg-dir", prev, "--save-softmax"])
    _check_outputs(jdir, tdir)
    for f in os.listdir(prev):
        if f.endswith("_segFromPrevStage.npy"):
            seg = np.load(os.path.join(prev, f))
            for shape in ((32, 32, 32), (17, 40, 9)):
                got = tcascade.resize_seg_nearest(seg, shape)
                np.testing.assert_array_equal(got, jcascade.resize_seg_nearest(seg, shape))
                np.testing.assert_array_equal(tcascade.seg_to_onehot(got, range(1, 8)),
                                              jcascade.seg_to_onehot(got, range(1, 8)))


def _files(d):
    out = {}
    for f in sorted(os.listdir(d)):
        p = os.path.join(d, f)
        out[f] = (np.load(p)["softmax"] if f.endswith(".npz")
                  else np.load(p) if f.endswith(".npy") else read_nifti(p))
    return out


def test_predict_workers_give_the_same_files(data_root, runs, tmp_path):
    base = ["--data", data_root, "--cache", os.path.join(data_root, "cache_port"),
            "--run-dirs", runs[0][1], "--device", "cpu", *GRID, "--save-softmax",
            "--save-seg-for-next-stage"]
    ref = None
    for workers, mode in ((0, "thread"), (2, "thread"), (2, "process")):
        out = str(tmp_path / f"{workers}_{mode}")
        recs = tpredict.main(base + ["--out", out, "--workers", str(workers),
                                     "--worker-mode", mode])
        assert len(recs) == 2 and all(r["seconds"] > 0 for r in recs)
        files = _files(out)
        if ref is None:
            ref = files
            continue
        assert files.keys() == ref.keys()
        for k, v in files.items():
            np.testing.assert_array_equal(v, ref[k])


def _generic_unet_run(run):
    """A port run dir of a tiny GenericUNet (base 4, two (2, 2, 2) pools)."""
    kw = dict(base_num_features=4, pool_kernels=[[2, 2, 2]] * 2, conv_kernels=[[3, 3, 3]] * 3,
              in_channels=2)
    cfg = tcfg.Config()
    cfg.model.name = "generic_unet"
    cfg.model.extra = kw
    tcfg.save_config(cfg, os.path.join(run, "config.json"))
    model = treg.build("generic_unet", device="cpu", num_classes=8,
                       generator=torch.Generator().manual_seed(5), **kw)
    CheckpointManager(run).save("best_dice", {"params": model.state_dict(), "step": 1})


def _same_predictions(a, b):
    """Two output dirs of the same cases: softmax files within 1e-3 (f16
    storage), label maps equal wherever the top-2 margin exceeds 2e-3."""
    pids = sorted(f[: -len("_pred.nii.gz")] for f in os.listdir(a) if f.endswith("_pred.nii.gz"))
    assert len(pids) == 2 and sorted(os.listdir(a)) == sorted(os.listdir(b))
    for pid in pids:
        sa = np.load(os.path.join(a, f"{pid}_softmax.npz"))["softmax"].astype(np.float32)
        sb = np.load(os.path.join(b, f"{pid}_softmax.npz"))["softmax"].astype(np.float32)
        np.testing.assert_allclose(sa, sb, atol=1e-3)
        sure = _margin(sa) > 2e-3
        assert sure.mean() > 0.25
        np.testing.assert_array_equal(read_nifti(os.path.join(a, f"{pid}_pred.nii.gz"))[sure],
                                      read_nifti(os.path.join(b, f"{pid}_pred.nii.gz"))[sure])


@pytest.mark.parametrize("args, expect", [
    (["--engine", "2d"], "queue 4"), (["--engine", "p3d"], "queue 4"),
    (["--engine", "spatial"], "whole-volume forward"), (["--spatial-shards", "2"], "refused"),
    (["--pseudo3d-slices", "5"], "queue 4"), (["--sharded-tiles"], "sw_batch 1"),
], ids=["args0-queue 4", "args1-queue 4", "args2-queue 3", "args3-queue 3", "args4-queue 4",
        "args5-queue 3"])
def test_unported_options_raise(data_root, runs, tmp_path, args, expect):
    """The 2D engines still raise, naming ROADMAP queue 4. At world size 1
    --sharded-tiles is the 3d engine at sw_batch 1, and --engine spatial the
    whole-volume forward of a GenericUNet run (the 3d engine with the roi
    equal to the volume); --spatial-shards other than the world size is
    refused."""
    if expect == "queue 4":
        with pytest.raises(NotImplementedError, match=f"ROADMAP {expect}"):
            tpredict.main(["--data", str(tmp_path), "--run-dirs", str(tmp_path),
                           "--device", "cpu", *args])
        return
    if expect == "refused":
        with pytest.raises(SystemExit, match="runs on every rank, 1 here"):
            tpredict.main(["--data", str(tmp_path), "--run-dirs", str(tmp_path),
                           "--device", "cpu", "--engine", "spatial", *args])
        return
    run = runs[0][1]
    if expect == "whole-volume forward":
        run = str(tmp_path / "generic_unet")
        _generic_unet_run(run)
    base = ["--data", data_root, "--cache", os.path.join(data_root, "cache_port"),
            "--run-dirs", run, "--device", "cpu", "--target-shape", "32", "--roi", "32",
            "--save-softmax"] + (["--mirror-tta"] if expect == "sw_batch 1" else [])
    got, want = str(tmp_path / "got"), str(tmp_path / "want")
    tpredict.main(base + ["--out", got] + args)
    tpredict.main(base + ["--out", want, "--sw-batch-size", "1"])
    _same_predictions(got, want)


def test_predict_without_a_card_raises(data_root, runs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpredict.main(["--data", data_root, "--run-dirs", runs[0][1],
                       "--out", str(tmp_path / "p"), *GRID])
    assert not (tmp_path / "p").exists()


def test_run_model_rebuilds_the_ports_runs(tmp_path):
    """config.json back to the model: extra lists as tuples, MicFormer's
    embed_dim and fused_attention; another --model ignores the run."""
    cfg = tcfg.Config()
    cfg.model.embed_dim = 24
    cfg.model.fused_attention = True
    cfg.model.num_classes = 5
    cfg.model.extra = {"depths": [1, 1], "num_heads": [3, 6]}
    tcfg.save_config(cfg, str(tmp_path / "config.json"))
    name, kw = tcfg.run_model(str(tmp_path))
    assert (name, kw) == ("micformer", dict(num_classes=5, embed_dim=24, fused_attention=True,
                                            depths=(1, 1), num_heads=(3, 6)))
    assert tcfg.run_model(str(tmp_path), "mednext", 8) == ("mednext", {"num_classes": 8})
    assert tcfg.run_model(str(tmp_path / "none")) == ("micformer", {"num_classes": 8})
    model = treg.build(name, device="cpu", **kw)
    assert all(m.fused_attention for m in model.modules() if hasattr(m, "fused_attention"))
    cfg = tcfg.Config()
    cfg.model.name = "mednext"
    cfg.model.extra = {"n_channels": 4, "deep_supervision": True}
    tcfg.save_config(cfg, str(tmp_path / "config.json"))
    assert tcfg.run_model(str(tmp_path)) == ("mednext", dict(
        num_classes=8, n_channels=4, deep_supervision=True))
    assert dataclasses.asdict(tcfg.load_config(overrides=json.loads(
        (tmp_path / "config.json").read_text()))) == dataclasses.asdict(cfg)


def test_deep_supervised_run_predicts_its_full_resolution_head(data_root, tmp_path):
    """A MedNeXt run with deep supervision: predict takes the pyramid's first
    output; checked against sliding-window inference of that head."""
    from micformer_tpu_torch.data.mmwhs import get_datasets

    run = str(tmp_path / "run")
    cfg = tcfg.Config()
    cfg.model.name = "mednext"
    cfg.model.extra = {"n_channels": 4, "deep_supervision": True}
    tcfg.save_config(cfg, os.path.join(run, "config.json"))
    model = treg.build("mednext", device="cpu", n_channels=4, deep_supervision=True,
                       generator=torch.Generator().manual_seed(5))
    CheckpointManager(run).save("best_loss", {"params": model.state_dict()})
    out = str(tmp_path / "p")
    tpredict.main(["--data", data_root, "--cache", os.path.join(data_root, "cache_port"),
                   "--run-dirs", run, "--ckpt-tag", "best_loss", "--out", out,
                   "--device", "cpu", *GRID, "--save-softmax"])
    _, _, test_ds = get_datasets(data_root, cache_dir=os.path.join(data_root, "cache_port"),
                                 target_shape=(32,) * 3)
    s = test_ds[0]
    logits = tsw.sliding_window_inference(torch.tensor(s["image"][None]), (32,) * 3,
                                          lambda w: model(w)[0], num_classes=8,
                                          sw_batch_size=2)
    sm = np.load(os.path.join(out, f"{s['patient_id']}_softmax.npz"))["softmax"]
    np.testing.assert_allclose(sm.astype(np.float32), torch.softmax(logits, 1)[0].numpy(),
                               atol=1e-3)


def test_restore_params_only_takes_a_payload_or_a_bare_state_dict(tmp_path):
    sd = {"w": torch.arange(3.0)}
    cm = CheckpointManager(str(tmp_path))
    cm.save("best_dice", {"params": sd, "opt_state": {}, "step": 1})
    cm.save("latest", sd)
    for tag in ("best_dice", "latest"):
        got = cm.restore_params_only(tag)
        assert got.keys() == sd.keys() and torch.equal(got["w"], sd["w"])


def test_case_paths_rewrite_the_file_name_only(tmp_path):
    """A data root whose directories hold "ct" and "image" (the JAX package
    rewrites those too) still finds each case's MR and label files."""
    from micformer_tpu_torch.data.mmwhs import CasePaths, get_datasets

    root = tmp_path / "project_ct_image"
    write_synthetic_dataset(str(root), n_cases=5, shape=(8, 8, 8), seed=0)
    case = CasePaths.from_ct_image(str(root / "ct_1003_image.nii.gz"))
    assert case == CasePaths("1003", str(root / "ct_1003_image.nii.gz"),
                             str(root / "ct_1003_label.nii.gz"),
                             str(root / "mr_1003_image.nii.gz"),
                             str(root / "mr_1003_label.nii.gz"))
    train_ds, _, _ = get_datasets(str(root), target_shape=(8, 8, 8))
    assert train_ds[0]["image"].shape == (2, 8, 8, 8)
