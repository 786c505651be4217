"""The port's data-parallel trainer on the CPU over gloo ranks: a DDP step
of a small MicFormer (embed 24, two stages) and of a small MedNeXt at
W = 2 against the port's single process on the whole batch and against the
JAX `Trainer` under make_mesh(data=2) on the same converted weights; ZeRO-1
against plain DDP, and its checkpoint resumed in one process; case-parallel
validation against the serial loop; `torchrun ... cli.train --mesh data=2
[--zero1]` and its resume in one process.

Tolerances (those of `tests/test_distributed_multiprocess.py`): loss 1e-5
relative, parameters after one SGD-Nesterov step 1e-6; gradients 1e-5 of
the largest (f32 sums per rank, then over the ranks). ZeRO-1 and
case-parallel validation run the same arithmetic as their references:
bitwise. The ranks are spawned processes that import no JAX
(`torch_port_ranks`).
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu.models import mednext as jm  # noqa: E402
from micformer_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from micformer_tpu.train.trainer import TrainConfig as JConfig  # noqa: E402
from micformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402

import torch_port_ranks as ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# drop path off where a run resumes: its generator's state is not checkpointed
MICFORMER = ("micformer", dict(num_classes=8, embed_dim=24, depths=(1, 1), num_heads=(3, 6),
                               drop_path_rate=0.0))
MEDNEXT = ("mednext", dict(num_classes=8, n_channels=4, block_counts=(1,) * 9))
SHAPES = {"micformer": (16, 16, 16), "mednext": (32, 32, 32)}
SGD = dict(optimizer="sgd_nesterov", lr=0.05, scheduler="constant")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jobs():
    """The spawned ranks' work: each model's DDP step (MicFormer with the
    monai augmentation and DropPath, so both draw a rank's rows of the
    global batch; MedNeXt with deep supervision and dice_ce), then ZeRO-1
    with Adam and validation."""
    mic_cfg = dict(SGD, augment="monai")
    mn_cfg = dict(SGD, augment="nnunet", loss="dice_ce", deep_supervision=True)
    val = [b for b in ranks.train_batches(3, 1, (16, 16, 16), seed=9)]
    return [
        (ranks.ddp_step_worker, dict(name="micformer", kwargs=dict(MICFORMER[1],
                                                                  drop_path_rate=0.2),
                                     cfg=mic_cfg, shape=SHAPES["micformer"], tag="mic")),
        (ranks.ddp_step_worker, dict(name="mednext",
                                     kwargs=dict(MEDNEXT[1], deep_supervision=True),
                                     cfg=mn_cfg, shape=SHAPES["mednext"], tag="mn")),
        (ranks.zero1_worker, dict(name="micformer", kwargs=MICFORMER[1],
                                  cfg=dict(optimizer="adam", lr=1e-3, augment="none"),
                                  shape=SHAPES["micformer"], val=val)),
    ], (mic_cfg, mn_cfg, val)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("ddp")
    jobs, cfgs = _jobs()
    return tmp, ranks.run_ranks(2, tmp, ranks.many_worker, jobs=jobs), cfgs


def _single(tmp, name, kwargs, cfg, shape, steps=1, state=None):
    """The port's single process on the whole batches."""
    tr = ranks.trainer(name, kwargs, os.path.join(tmp, f"single_{name}"), state=state, **cfg)
    recs = [tr.train_step(torch.from_numpy(i), torch.from_numpy(lab))
            for i, lab in ranks.train_batches(steps, 4, shape)]
    return tr, recs


def _check_step(out, tr, recs):
    for r in out:
        assert r["losses"][0] == pytest.approx(recs[0]["loss"], rel=1e-5)
    assert out[0]["losses"] == out[1]["losses"]          # every rank: the global loss
    top = max(p.grad.abs().max().item() for p in tr.model.parameters() if p.grad is not None)
    for n, p in tr.model.named_parameters():
        for r in out:
            torch.testing.assert_close(r["grads"][n], p.grad, rtol=0, atol=1e-5 * top, msg=n)
    for k, v in tr.model.state_dict().items():
        for r in out:
            torch.testing.assert_close(r["params"][0][k], v, rtol=0, atol=1e-6, msg=k)


@pytest.mark.parametrize("which", [0, 1], ids=["micformer", "mednext"])
def test_ddp_step_equals_the_single_process_on_the_whole_batch(spawned, tmp_path, which):
    tmp, out, (mic_cfg, mn_cfg, _) = spawned
    if which == 0:
        tr, recs = _single(tmp_path, "micformer", dict(MICFORMER[1], drop_path_rate=0.2),
                           mic_cfg, SHAPES["micformer"])
    else:
        tr, recs = _single(tmp_path, "mednext", dict(MEDNEXT[1], deep_supervision=True),
                           mn_cfg, SHAPES["mednext"])
    _check_step([r[which] for r in out], tr, recs)


def test_zero1_equals_ddp_and_its_checkpoint_resumes_in_one_process(spawned, tmp_path):
    from micformer_tpu_torch.train.trainer import TrainConfig, Trainer

    tmp, out, _ = spawned
    for r in out:
        z, d = r[2]["zero1"], r[2]["ddp"]
        assert z["sharded"] == "ZeroRedundancyOptimizer" and d["sharded"] == "Adam"
        for step in range(3):
            for k, v in d["params"][step].items():
                torch.testing.assert_close(z["params"][step][k], v, rtol=0, atol=0, msg=k)
    # the consolidated state, in the plain optimizer's format
    cfg = dict(optimizer="adam", lr=1e-3, augment="none")
    tr = Trainer(ranks.make_model(*MICFORMER), TrainConfig(run_dir=str(tmp / "zero1"), **cfg))
    payload = tr.restore("latest")
    plain = ranks.trainer(*MICFORMER, tmp_path / "plain", **cfg)
    batches = ranks.train_batches(4, 4, SHAPES["micformer"])
    plain.train_step(*(torch.from_numpy(a) for a in batches[0]))
    want = plain.optimizer.state_dict()
    got = payload["opt_state"]
    assert set(got["state"]) == set(want["state"]) == set(range(len(plain.params)))
    assert set(got["param_groups"][0]) == set(want["param_groups"][0])
    assert all(int(s["step"]) == 3 for s in got["state"].values())
    # the fourth step in one process from the checkpoint is DDP's fourth
    assert tr.step == 3 and type(tr.optimizer) is torch.optim.Adam
    tr.train_step(*(torch.from_numpy(a) for a in batches[3]))
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(v, out[0][2]["ddp"]["params"][3][k], rtol=0, atol=1e-6, msg=k)


def test_case_parallel_validation_equals_the_serial_loop(spawned, tmp_path):
    tmp, out, (_, _, val) = spawned
    tr = ranks.trainer(*MICFORMER, tmp_path, state=out[0][2]["ddp"]["params"][-1],
                       optimizer="adam", lr=1e-3, augment="none")
    want = tr.validate([(torch.from_numpy(i), torch.from_numpy(lab), {}) for i, lab in val])
    for r in out:
        got = r[2]["val"]
        assert got["per_class_dice"].shape == (3, 8)
        np.testing.assert_array_equal(got["per_class_dice"], want["per_class_dice"])
        assert (got["val_loss"], got["meandice"]) == (want["val_loss"], want["meandice"])


@pytest.mark.parametrize("zero1", [False, True], ids=["ddp", "zero1"])
def test_torchrun_cli_train_mesh_and_resume_in_one_process(tmp_path, zero1):
    """torchrun --nproc-per-node 2 ... --device cpu --mesh data=2 [--zero1]
    for one epoch (4 training cases, global batch 2: two steps), then
    --resume in one process without --mesh for a second."""
    from micformer_tpu_torch.cli import train

    data = tmp_path / "data"
    write_synthetic_dataset(str(data), n_cases=6, shape=(20, 18, 22), seed=0)
    run = tmp_path / "run"
    args = ["--data", str(data), "--cache", str(tmp_path / "cache"), "--device", "cpu",
            "--model-kwargs", json.dumps({"embed_dim": 6, "depths": [1, 1],
                                          "num_heads": [3, 6]}),
            "--target-shape", "16", "--val", "1", "--run-dir", str(run), "--workers", "0",
            "--batch-size", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "micformer_tpu_torch.cli.train", *args, "--epochs", "1", "--mesh", "data=2"]
        + (["--zero1"] if zero1 else []),
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("backend gloo (device cpu)") == 2
    assert f"rank 1 of data=2{', ZeRO-1' if zero1 else ''})" in res.stdout
    saved = json.loads((run / "config.json").read_text())["train"]
    assert saved["mesh"] == "data=2" and saved["zero1"] is zero1
    log = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    assert sum("n_parameters" in r for r in log) == 1           # the primary alone writes
    assert [r["epoch"] for r in log if "train_loss" in r] == [0]
    for name in ("ckpt_latest.pt", "ckpt_best_dice.pt", "ckpt_best_loss.pt"):
        assert (run / name).exists(), name
    resumed = train.main(args + ["--epochs", "2", "--resume"])
    assert resumed.step == 4 and len(resumed.history) == 2
    assert all(np.isfinite(r["loss"]) for r in resumed.history)


# -- against the JAX Trainer under make_mesh(data=2) ----------------------------------------

def _jax_ddp_reference(name, kwargs, shape, run_dir, loss="mdice", deep_supervision=False):
    """The JAX Trainer's one data-parallel step on the whole batch of 4 over
    a two-device mesh: (params0, loss, params after the step)."""
    mesh = jmake_mesh(data=2, devices=jax.devices()[:2])
    model = jm.MedNeXt(**kwargs) if name == "mednext" else jreg.build(name, **kwargs)
    cfg = JConfig(run_dir=str(run_dir), augment="none", nan_guard=False, loss=loss,
                  deep_supervision=deep_supervision, **SGD)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        trainer = JTrainer(model, cfg, mesh=mesh)
    state = trainer.init_state((1, 2) + shape)
    params0 = jax.tree.map(np.asarray, state.params)
    images, labels = ranks.train_batches(1, 4, shape)[0]
    sh = NamedSharding(mesh, P("data"))
    state, metrics = trainer.train_step(state, jax.device_put(jnp.asarray(images), sh),
                                        jax.device_put(jnp.asarray(labels), sh),
                                        jax.random.key(0))
    return params0, float(metrics["loss"]), jax.tree.map(np.asarray, state.params)


@pytest.mark.slow
@pytest.mark.parametrize("which", ["micformer", "mednext"])
def test_ddp_step_matches_the_jax_trainer_under_a_data_mesh(tmp_path, which):
    """About a minute of JAX compilation a model."""
    if which == "micformer":
        name, kwargs = MICFORMER[0], dict(MICFORMER[1], drop_path_rate=0.0)
        ds = dict(loss="mdice")
    else:
        name, kwargs = MEDNEXT[0], dict(MEDNEXT[1], deep_supervision=True)
        ds = dict(loss="dice_ce", deep_supervision=True)
    params0, loss, after = _jax_ddp_reference(name, kwargs, SHAPES[which], tmp_path / "jax", **ds)
    model = ranks.make_model(name, kwargs)
    state = state_dict_from_flax(params0, model)
    cfg = dict(SGD, augment="none", **ds)
    out = ranks.run_ranks(2, tmp_path / "ranks", ranks.ddp_step_worker, name=name,
                          kwargs=kwargs, cfg=cfg, shape=SHAPES[which], state=state)
    want = state_dict_from_flax(after, model)
    for r in out:
        assert r["losses"][0] == pytest.approx(loss, rel=1e-5)
        for k, v in want.items():
            torch.testing.assert_close(r["params"][0][k], v, rtol=0, atol=1e-6, msg=k)
