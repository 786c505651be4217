"""The port's trainer against the JAX `Trainer` on the CPU: one training
step's loss and gradients and three SGD-Nesterov steps from the same
JAX-initialised parameters, with the fused-attention option off and on; the
NaN guard, checkpoints and resume; and `cli/train.py --device cpu`.

The JAX package reads its MICFORMER_* flags at import; they are cleared here
first, so it runs its default forms.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu.train.trainer import TrainConfig as JConfig  # noqa: E402
from micformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from micformer_tpu_torch.kernels import LAUNCHES  # noqa: E402
from micformer_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

TINY = dict(num_classes=8, embed_dim=12, depths=(1, 1), num_heads=(3, 6),
            drop_path_rate=0.0)
# sgd_nesterov at a learning rate that moves the parameters visibly in
# three steps; cosine over 10 epochs of one step
OPT = dict(optimizer="sgd_nesterov", lr=0.05, epochs=10, steps_per_epoch=1,
           augment="none")


def _batch(seed, shape=(32, 32, 32)):
    """A loader batch: f16 image [1, 2, *shape], uint8 class map [1, *shape]."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, 2) + shape).astype(np.float16)
    lab = rng.integers(0, 8, (1,) + shape).astype(np.uint8)
    return img, lab


def _jax_reference(kw, run_dir, steps=3):
    """The JAX trainer from its own init: (params, loss and grads of the
    first step, params after `steps` train steps), all as numpy trees."""
    model = jreg.build("micformer", **kw)
    # the JAX trainer's MetricsWriter tries TensorBoard first; barring that
    # import keeps it on its JSONL-only path and saves seconds of start-up
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        trainer = JTrainer(model, JConfig(run_dir=str(run_dir), **OPT))
    state = trainer.init_state((1, 2, 32, 32, 32))
    params0 = jax.tree.map(np.asarray, state.params)
    img, lab = (jnp.asarray(a) for a in _batch(0))

    def loss_fn(params):
        images, labels = trainer._prep_batch(img, lab)
        logits = model.apply({"params": params}, images, deterministic=False,
                             rngs={"dropout": jax.random.key(1)})
        return trainer._loss(logits, labels)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    losses = []
    for i in range(steps):
        state, metrics = trainer.train_step(state, img, lab, jax.random.key(i))
        losses.append(float(metrics["loss"]))
    return {"params0": params0, "loss": float(loss), "losses": losses,
            "grads": jax.tree.map(np.asarray, grads),
            "params": jax.tree.map(np.asarray, state.params)}


def _port_trainer(kw, params0, run_dir, fused=False, **cfg):
    model = treg.build("micformer", device="cpu", fused_attention=fused, **kw)
    model.load_state_dict(state_dict_from_flax(params0, model))
    return Trainer(model, TrainConfig(run_dir=str(run_dir), **{**OPT, **cfg}))


def _check_against_jax(ref, kw, run_dir, fused):
    trainer = _port_trainer(kw, ref["params0"], run_dir, fused)
    img, lab = (torch.from_numpy(a) for a in _batch(0))
    rec = trainer.train_step(img, lab)
    # the loss: f32 sums over 32³·8 voxels in another order
    assert rec["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    model = trainer.model
    want = state_dict_from_flax(ref["grads"], model)
    worst = 0.0
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        # each leaf relative to its own max |g|; leaves whose gradient is
        # zero in exact arithmetic (a one-token window's query side) carry
        # ~1e-13 of rounding in JAX, hence the 1e-8 floor
        scale = max(want[name].abs().max().item(), 1e-8)
        worst = max(worst, (g - want[name]).abs().max().item() / scale)
    assert worst <= 1e-3, worst
    for _ in range(2):
        trainer.train_step(img, lab)
    after = state_dict_from_flax(ref["params"], model)
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, after[name], rtol=0, atol=1e-6, msg=name)
    assert trainer.step == 3
    assert [r["loss"] for r in trainer.history] == pytest.approx(ref["losses"], rel=1e-5)
    assert all(n == 0 for n in rec["launches"].values())


@pytest.fixture(scope="module")
def tiny_reference(tmp_path_factory):
    return _jax_reference(TINY, tmp_path_factory.mktemp("jax_run"))


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_jax_trainer(tiny_reference, tmp_path, fused):
    """Loss (rel 1e-5), every gradient leaf (1e-3 of the leaf's max |g|) and
    the parameters after three steps (atol 1e-6) against the JAX trainer. On
    the CPU both attention options take plain versions of one function."""
    _check_against_jax(tiny_reference, TINY, tmp_path, fused)


@pytest.mark.slow
def test_train_step_matches_jax_trainer_four_stages(tmp_path):
    """embed 24, depths 1-1-1-1, heads 3-6-12-24 at 1x2x32³ (stage 3 holds
    one token); about two minutes of JAX compilation on the CPU."""
    kw = dict(TINY, embed_dim=24, depths=(1, 1, 1, 1), num_heads=(3, 6, 12, 24))
    ref = _jax_reference(kw, tmp_path / "jax")
    _check_against_jax(ref, kw, tmp_path / "port", fused=True)


TINY_PORT = dict(TINY, embed_dim=6)


def _tiny_trainer(run_dir, **cfg):
    model = treg.build("micformer", device="cpu", generator=torch.Generator().manual_seed(1),
                       **TINY_PORT)
    return Trainer(model, TrainConfig(run_dir=str(run_dir), **{**OPT, **cfg}))


def test_nan_guard_skips_the_step_bitwise(tmp_path):
    trainer = _tiny_trainer(tmp_path, optimizer="adam", augment="monai")
    img, lab = (torch.from_numpy(a) for a in _batch(1, (16, 16, 16)))
    trainer.train_step(img, lab)
    params = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt = {i: {k: v.clone() for k, v in s.items()}
           for i, s in trainer.optimizer.state_dict()["state"].items()}
    lr = trainer.optimizer.param_groups[0]["lr"]
    bad = img.clone()
    bad[0, 0, 3, 4, 5] = float("nan")
    rec = trainer.train_step(bad, lab)
    assert rec["skipped"] and not np.isfinite(rec["loss"]) and trainer.step == 1
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for i, s in trainer.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt[i][k]), (i, k)
    assert trainer.optimizer.param_groups[0]["lr"] == lr
    assert not trainer.train_step(img, lab)["skipped"] and trainer.step == 2


def test_nan_guard_halts_after_max_consecutive(tmp_path):
    trainer = _tiny_trainer(tmp_path, max_consecutive_nan=2)
    img, lab = _batch(2, (16, 16, 16))
    img[:] = np.nan
    loader = [(torch.from_numpy(img), torch.from_numpy(lab), {})] * 3
    with pytest.raises(FloatingPointError):
        trainer.fit(loader)


@pytest.mark.parametrize("kw, error", [
    ({"zero1": True}, NotImplementedError), ({"mesh": "data=4"}, NotImplementedError),
    ({"pretrained": "runs/x"}, None), ({"loss": "gdl"}, None), ({"loss": "topk"}, None),
    ({"loss": "focal"}, None), ({"loss": "mcc"}, None), ({"loss": "dice_topk"}, None),
    ({"loss": "dice_bce"}, None), ({"loss": "edice"}, ValueError)],
    ids=["zero1", "mesh", "pretrained", "gdl", "topk", "focal", "mcc", "dice_topk", "dice_bce",
         "unknown_loss"])
def test_unported_config_fields_raise(kw, error):
    """Data parallelism (zero1, mesh) is still unported and raises naming its
    ROADMAP item; `pretrained` and the loss zoo are ported and construct; a
    loss the JAX trainer does not dispatch raises ValueError, as it does."""
    if error is None:
        assert getattr(TrainConfig(**kw), next(iter(kw))) == next(iter(kw.values()))
        return
    with pytest.raises(error, match="item 3" if error is NotImplementedError else "edice"):
        TrainConfig(**kw)


def test_checkpoint_round_trip_and_keep_best_k(tmp_path):
    from micformer_tpu_torch.train.checkpoint import SCHEMA_VERSION, CheckpointManager

    trainer = _tiny_trainer(tmp_path, optimizer="adamw", weight_decay=0.01)
    img, lab = (torch.from_numpy(a) for a in _batch(3, (16, 16, 16)))
    trainer.train_step(img, lab)
    trainer.ckpt.save("latest", trainer._payload(0, 0.25, 0.5))
    other = _tiny_trainer(tmp_path, optimizer="adamw", weight_decay=0.01)
    payload = other.restore("latest")
    assert other.step == 1 and payload["epoch"] == 0 and payload["best_dice"] == 0.25
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, other.model.state_dict()[k])
    a, b = trainer.optimizer.state_dict(), other.optimizer.state_dict()
    for i, s in a["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["state"][i][k])
    # the next step is the same on both
    r1, r2 = trainer.train_step(img, lab), other.train_step(img, lab)
    assert r1["loss"] == r2["loss"]
    assert trainer.ckpt.meta("latest")["schema_version"] == SCHEMA_VERSION == 2
    mgr = CheckpointManager(tmp_path / "k", keep_best_k=2)
    for step, metric in [(1, 0.5), (2, 0.7), (3, 0.6), (4, 0.1)]:
        mgr.save("best_dice", {"step": step}, metric=metric)
    kept = sorted(f for f in os.listdir(mgr.run_dir) if f.endswith(".pt"))
    assert kept == ["ckpt_best_dice.pt", "ckpt_best_dice_k2.pt", "ckpt_best_dice_k3.pt"]


def test_cli_train_on_cpu_writes_logs_checkpoints_and_resumes(tmp_path):
    """Two epochs of `cli/train.py --device cpu` on a synthetic root (six
    cases: four train, one validation), then --resume for a third."""
    from micformer_tpu_torch.cli import train

    data = tmp_path / "data"
    write_synthetic_dataset(str(data), n_cases=6, shape=(20, 18, 22), seed=0)
    run = tmp_path / "run"
    args = ["--data", str(data), "--cache", str(tmp_path / "cache"), "--device", "cpu",
            "--model-kwargs", json.dumps({k: v for k, v in TINY_PORT.items()
                                          if k != "num_classes"}),
            "--target-shape", "16", "--val", "1", "--run-dir", str(run),
            "--workers", "2", "--lr", "1e-3"]
    before = dict(LAUNCHES)
    trainer = train.main(args + ["--epochs", "2"])
    assert trainer.step == 8 and len(trainer.history) == 8
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    assert LAUNCHES == before
    log = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    assert log[0]["n_parameters"] == sum(p.numel() for p in trainer.model.parameters())
    assert [r["epoch"] for r in log if "train_loss" in r] == [0, 1]
    assert all(np.isfinite(r["meandice"]) for r in log if "meandice" in r)
    for name in ("ckpt_latest.pt", "ckpt_best_dice.pt", "ckpt_best_loss.pt",
                 "ckpt_latest.meta.json", "events.jsonl", "val.txt", "config.json"):
        assert (run / name).exists(), name
    resumed = train.main(args + ["--epochs", "3", "--resume"])
    assert resumed.step == 12 and len(resumed.history) == 4


@pytest.mark.parametrize("extra, error", [
    ([], RuntimeError), (["--zero1"], NotImplementedError),
    (["--mesh", "data=4"], NotImplementedError)], ids=["no_card", "zero1", "mesh"])
def test_cli_train_raises_without_a_card_and_for_unported_flags(tmp_path, extra, error):
    """Without --device cpu the CLI asks for the card and raises without one;
    --zero1 and --mesh parse but raise naming ROADMAP queue 1 item 3 (data
    parallelism), before any data or device is touched."""
    from micformer_tpu_torch.cli import train

    if error is RuntimeError and torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(error, match="CUDA" if error is RuntimeError else "item 3"):
        train.main(["--data", str(tmp_path)] + extra)
