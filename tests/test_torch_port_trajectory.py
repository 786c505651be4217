"""The port's `Trainer` against the JAX `Trainer` over many steps on the
CPU, both from JAX's init, f32, drop_path 0, no augmentation.

20-step fixed-batch trajectories, shaped like tests/test_train_trajectory.py
(the same 20 seeded batches on both sides):
  - MicFormer (tiny), Adam 1e-4, cosine stepped per batch, mdice;
  - MedNeXt (narrow, one block a stage) with deep supervision, dice_ce,
    SGD-Nesterov 0.01, poly, clipping at 12.
Each step's loss agrees to rel 1e-4 (the JAX repo's trajectory bar); the
parameters after 20 steps agree to atol 1e-5 under both optimizers (under
Adam a tenth of the most one step moves a weight, about lr = 1e-4, so an
optimizer that moved nothing, or the wrong way, fails).

`find_lr` of the tiny MicFormer (the trajectory's init, which JAX's fresh
init for the sweep equals): six iterations over two of the batches, mdice.
The swept learning rates agree to rel 1e-12 and the bias-corrected smoothed
losses to rel 1e-4; the port's trainer keeps its own weights, optimizer state
and step; both write the curve to log.jsonl.

The JAX package reads its MICFORMER_* flags at import; they are cleared here
first, so it runs its default forms. The port's side runs torch on one
thread: the models are tiny, and the test workers share the machine's cores.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu.models import mednext as jm  # noqa: E402
from micformer_tpu.train.trainer import TrainConfig as JConfig  # noqa: E402
from micformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from micformer_tpu.train.trainer import TrainState  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.models import mednext as tm  # noqa: E402
from micformer_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

STEPS = 20
SHAPE = (32, 32, 32)
TINY = dict(num_classes=8, embed_dim=12, depths=(1, 1), num_heads=(3, 6), drop_path_rate=0.0)
SMALL = dict(num_classes=8, n_channels=4, block_counts=(1,) * 9, deep_supervision=True)
# (JAX model, port model, trainer config, parameter atol after 20 steps)
RUNS = {
    "micformer_adam": (lambda: jreg.build("micformer", **TINY),
                       lambda: treg.build("micformer", device="cpu", **TINY),
                       dict(optimizer="adam", lr=1e-4, scheduler="cosine",
                            scheduler_per_batch=True, epochs=30, steps_per_epoch=4,
                            loss="mdice"),
                       1e-5),
    "mednext_sgd": (lambda: jm.MedNeXt(**SMALL), lambda: tm.MedNeXt(**SMALL),
                    dict(optimizer="sgd_nesterov", lr=0.01, scheduler="poly", epochs=STEPS,
                         steps_per_epoch=1, loss="dice_ce", deep_supervision=True,
                         grad_clip_norm=12.0),
                    1e-5),
}


def _batches():
    """STEPS loader batches: f16 image [1, 2, *SHAPE], uint8 class map."""
    rng = np.random.default_rng(20)
    return [(rng.uniform(0, 1, (1, 2) + SHAPE).astype(np.float16),
             rng.integers(0, 8, (1,) + SHAPE).astype(np.uint8)) for _ in range(STEPS)]


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _jax_trainer(model, run_dir, cfg):
    # barring TensorBoard keeps the JAX MetricsWriter on its JSONL path
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        return JTrainer(model, JConfig(run_dir=str(run_dir), **cfg))


def _state(jtr, params):
    """The JAX trainer's fresh state around `params` (init_state's form)."""
    params = jax.tree.map(jnp.asarray, params)
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=jtr.tx.init(params), tx=jtr.tx)


@pytest.fixture(scope="module")
def micformer_init(tmp_path_factory):
    """The tiny MicFormer's JAX init (seed 1234, the configs' default), once
    for the trajectory and the find_lr sweep."""
    jtr = _jax_trainer(RUNS["micformer_adam"][0](), tmp_path_factory.mktemp("init"),
                       dict(augment="none"))
    return jax.tree.map(np.asarray, jtr.init_state((1, 2) + SHAPE).params)


@pytest.fixture(scope="module", params=list(RUNS))
def trajectories(request, tmp_path_factory):
    """(run name, JAX losses and params, port losses and model)."""
    jmodel, tmodel, cfg, _ = RUNS[request.param]
    cfg = dict(cfg, augment="none")
    jtr = _jax_trainer(jmodel(), tmp_path_factory.mktemp("jax"), cfg)
    if request.param == "micformer_adam":
        state = _state(jtr, request.getfixturevalue("micformer_init"))
    else:
        state = jtr.init_state((1, 2) + SHAPE)
    model = tmodel()
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, state.params), model))
    ttr = Trainer(model, TrainConfig(run_dir=str(tmp_path_factory.mktemp("port")), **cfg))
    jlosses, tlosses = [], []
    for s, (img, lab) in enumerate(_batches()):
        state, m = jtr.train_step(state, jnp.asarray(img), jnp.asarray(lab), jax.random.key(s))
        jlosses.append(float(m["loss"]))
        with _one_thread():
            rec = ttr.train_step(torch.from_numpy(img), torch.from_numpy(lab))
        assert not rec["skipped"]
        tlosses.append(rec["loss"])
    return (request.param, jlosses, jax.tree.map(np.asarray, state.params), tlosses, ttr)


def test_trajectory_losses_match_jax(trajectories):
    name, jlosses, _, tlosses, ttr = trajectories
    assert ttr.step == STEPS
    worst = max(abs(t - j) / abs(j) for t, j in zip(tlosses, jlosses))
    print(f"{name}: worst per-step loss rel delta {worst:.3g}")
    assert worst <= 1e-4, (worst, tlosses, jlosses)
    # the run moved: the trajectory is not flat
    assert abs(tlosses[-1] - tlosses[0]) > 1e-3 * abs(tlosses[0])


def test_trajectory_params_match_jax(trajectories):
    name, _, jparams, _, ttr = trajectories
    atol = RUNS[name][3]
    want = state_dict_from_flax(jparams, ttr.model)
    worst = max((p - want[k]).abs().max().item() for k, p in ttr.model.state_dict().items())
    print(f"{name}: worst parameter |delta| after {STEPS} steps {worst:.3g} (atol {atol:g})")
    assert worst <= atol, worst


FIND_LR = dict(augment="none", loss="mdice")
ITERS = 6


class _JaxLoader:
    def __iter__(self):
        for img, lab in _batches()[:2]:
            yield jnp.asarray(img), jnp.asarray(lab), {}

    def peek_shape(self):
        return (1, 2) + SHAPE


@pytest.fixture(scope="module")
def jax_sweep(micformer_init, tmp_path_factory):
    """JAX's (lrs, losses) and its run dir. Its fresh init for the sweep is
    `micformer_init` (the same model, seed and input shape)."""
    run_dir = tmp_path_factory.mktemp("jax_find_lr")
    jtr = _jax_trainer(RUNS["micformer_adam"][0](), run_dir, FIND_LR)
    assert jtr.cfg.seed == JConfig().seed
    jtr.init_state = lambda shape, rng=None: _state(jtr, micformer_init)
    lrs, losses = jtr.find_lr(_JaxLoader(), num_iters=ITERS)
    return lrs, losses, run_dir


def test_find_lr_matches_jax(micformer_init, jax_sweep, tmp_path):
    want_lrs, want_losses, jax_dir = jax_sweep
    model = treg.build("micformer", device="cpu", **TINY)
    model.load_state_dict(state_dict_from_flax(micformer_init, model))
    trainer = Trainer(model, TrainConfig(run_dir=str(tmp_path), **FIND_LR))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = trainer.optimizer.state_dict()
    loader = [(torch.from_numpy(i), torch.from_numpy(l), {}) for i, l in _batches()[:2]]
    with _one_thread():
        lrs, losses = trainer.find_lr(loader, num_iters=ITERS)
    assert len(lrs) == len(losses) == ITERS
    assert lrs == pytest.approx(want_lrs, rel=1e-12)
    assert lrs[0] == pytest.approx(1e-6) and lrs[-1] == pytest.approx(1.0)
    worst = max(abs(t - j) / abs(j) for t, j in zip(losses, want_losses))
    print(f"find_lr: worst smoothed-loss rel delta {worst:.3g}")
    assert worst <= 1e-4, (losses, want_losses)
    # the sweep ran on a copy: the trainer's own state is untouched
    assert trainer.model is model and trainer.step == 0 and trainer.history == []
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert trainer.optimizer.state_dict() == opt_before
    for run in (tmp_path, jax_dir):
        rec = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
        assert len(rec[-1]["find_lr"]["losses"]) == ITERS
