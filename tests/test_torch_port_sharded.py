"""Prediction over several ranks on the CPU (gloo): the port's
`sliding_window_inference_sharded` at W = 2 and 3 (8 tiles, so W = 3 runs
one padding tile of weight 0), with and without mirror TTA, against the
port's `sliding_window_inference` and the JAX sharded function; and
`cli/predict` over the ranks, `--sharded-tiles` (every rank predicts every
case, the primary writes) and the default round-robin of cases, against
one process.

Tolerances: logits 1e-5 (f32 sums of the same tiles in another order);
the CLIs' f16 softmax files 1e-3 and label maps equal wherever the top-2
margin exceeds 2e-3. The ranks are spawned processes that import no JAX
(`torch_port_ranks`).
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu.infer.sharded import sliding_window_inference_sharded as jsharded  # noqa
from micformer_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from micformer_tpu_torch import config as tcfg  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.cli import predict as tpredict  # noqa: E402
from micformer_tpu_torch.data.nifti import read_nifti  # noqa: E402
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from micformer_tpu_torch.infer import sliding_window_inference  # noqa: E402
from micformer_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

import torch_port_ranks as ranks  # noqa: E402

EXTRA = dict(embed_dim=12, depths=[1, 1], num_heads=[3, 6])


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A synthetic root (two test cases), a tiny MicFormer run, and one
    process's predictions at sw_batch 1 (which also fills the cache)."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("sharded")
    data = str(root / "data")
    write_synthetic_dataset(data, n_cases=15, shape=(20, 24, 28), seed=4)
    run = str(root / "run")
    cfg = tcfg.Config()
    cfg.model.embed_dim = 12
    cfg.model.extra = {k: v for k, v in EXTRA.items() if k != "embed_dim"}
    tcfg.save_config(cfg, os.path.join(run, "config.json"))
    model = treg.build("micformer", device="cpu", generator=torch.Generator().manual_seed(2),
                       **EXTRA)
    CheckpointManager(run).save("best_dice", {"params": model.state_dict(), "step": 1})
    base = ["--data", data, "--cache", str(root / "cache"), "--run-dirs", run, "--device", "cpu",
            "--target-shape", "24", "--roi", "16", "--save-softmax", "--mirror-tta"]
    single = str(root / "single")
    tpredict.main(base + ["--out", single, "--sw-batch-size", "1"])
    return root, base, single


def _same_predictions(a, b, pids):
    for pid in pids:
        sa = np.load(os.path.join(a, f"{pid}_softmax.npz"))["softmax"].astype(np.float32)
        sb = np.load(os.path.join(b, f"{pid}_softmax.npz"))["softmax"].astype(np.float32)
        np.testing.assert_allclose(sa, sb, atol=1e-3)
        top2 = np.sort(sb, axis=0)[-2:]
        sure = top2[1] - top2[0] > 2e-3
        assert sure.mean() > 0.25
        np.testing.assert_array_equal(read_nifti(os.path.join(a, f"{pid}_pred.nii.gz"))[sure],
                                      read_nifti(os.path.join(b, f"{pid}_pred.nii.gz"))[sure])


@pytest.fixture(scope="module", params=[2, 3], ids=["W2", "W3"])
def spawned(request, setup):
    world = request.param
    root, base, _ = setup
    tmp = root / f"w{world}"
    jobs = [(ranks.sharded_worker, dict(mirror_tta=False)),
            (ranks.sharded_worker, dict(mirror_tta=True)),
            (ranks.predict_worker, dict(argv=base + ["--out", str(tmp / "tiles"),
                                                     "--sharded-tiles"])),
            (ranks.predict_worker, dict(argv=base + ["--out", str(tmp / "cases"),
                                                     "--sw-batch-size", "1"]))]
    return world, tmp, ranks.run_ranks(world, tmp, ranks.many_worker, jobs=jobs)


@pytest.mark.parametrize("mirror", [False, True], ids=["plain", "mirror_tta"])
def test_sharded_tiles_match_the_single_engine_and_jax(spawned, mirror):
    world, _, out = spawned
    vol, w = ranks.sharded_inputs()
    kw = dict(mirror_tta=mirror)
    want = sliding_window_inference(torch.from_numpy(vol), (16,) * 3, ranks.linear_predictor(w),
                                    **kw).numpy()
    mesh = jmake_mesh(data=world, devices=jax.devices()[:world])
    jw = jnp.asarray(w)
    jax_out = np.asarray(jsharded(jnp.asarray(vol), (16,) * 3,
                                  lambda x: jnp.einsum("oc,bcdhw->bodhw", jw, x), mesh, **kw))
    per_rank = -(-8 // world)
    for r in out:
        got, calls = r[int(mirror)]
        assert calls == per_rank * (8 if mirror else 1)   # padding tiles run too, as in JAX
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-5)


def test_cli_predict_sharded_tiles_and_round_robin_match_one_process(spawned, setup):
    world, tmp, out = spawned
    _, _, single = setup
    pids = sorted(f[: -len("_pred.nii.gz")] for f in os.listdir(single)
                  if f.endswith("_pred.nii.gz"))
    assert len(pids) == 2
    # --sharded-tiles: every rank predicted both cases, the primary wrote them
    assert [sorted(rec["patient_id"] for rec in r[2]) for r in out] == [pids] * world
    assert sorted(os.listdir(tmp / "tiles")) == sorted(os.listdir(single))
    _same_predictions(str(tmp / "tiles"), single, pids)
    # round-robin: rank r predicted and wrote cases r, r + W, ...
    assert [[rec["patient_id"] for rec in r[3]] for r in out] == [
        pids[r::world] for r in range(world)]
    assert sorted(os.listdir(tmp / "cases")) == sorted(os.listdir(single))
    _same_predictions(str(tmp / "cases"), single, pids)
