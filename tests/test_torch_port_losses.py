"""The port's loss zoo against `micformer_tpu/losses/dice.py` on the CPU:
each of the trainer's eight losses, plain and under the deep-supervision
wrapper, on seeded logits against one-hot and soft targets (value to rel
1e-5, the logits' gradient to 1e-5 of its max |g|); the weighted and
background-free softmax Dice + CE and the BraTS region loss; the default
softmax Dice + CE pinned bitwise to its values before it took its options;
and every loss computing in f32 under bf16 autocast.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from micformer_tpu.losses import dice as jdice
from micformer_tpu_torch.losses import dice as tdice
from micformer_tpu_torch.train.trainer import LOSSES

NAMES = {"mdice": "mdice_loss", "dice_ce": "softmax_dice_ce_loss",
         "gdl": "generalized_dice_loss", "topk": "topk_ce_loss", "focal": "focal_loss",
         "mcc": "mcc_loss", "dice_topk": "dice_topk_loss", "dice_bce": "dice_bce_loss"}


def _logits(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 2.0


def _target(seed, shape, soft):
    """[B, C, ...] float32: a one-hot of seeded labels, or a soft target (a
    softmax of seeded noise)."""
    rng = np.random.default_rng(seed)
    c = shape[1]
    if soft:
        z = rng.normal(size=shape).astype(np.float32) * 3.0
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    lab = rng.integers(0, c, (shape[0],) + shape[2:])
    return np.moveaxis(np.eye(c, dtype=np.float32)[lab], -1, 1).copy()


def _compare(jfn, tfn, xs, t):
    """(value, gradients w.r.t. each logits array) of jfn and tfn on the same
    inputs; asserts value rel 1e-5 and each gradient within 1e-5 of its max
    |g|."""
    jval, jgrads = jax.jit(jax.value_and_grad(lambda a: jfn(a, jnp.asarray(t))))(
        [jnp.asarray(x) for x in xs])
    txs = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    tval = tfn(txs, torch.from_numpy(t))
    tval.backward()
    assert tval.dtype == torch.float32
    assert tval.item() == pytest.approx(float(jval), rel=1e-5)
    for tx, jg in zip(txs, jgrads):
        jg = np.asarray(jg)
        scale = np.abs(jg).max()
        assert scale > 0
        assert np.abs(tx.grad.numpy() - jg).max() <= 1e-5 * scale


@pytest.mark.parametrize("soft", [False, True], ids=["onehot", "soft"])
@pytest.mark.parametrize("name", list(NAMES))
def test_loss_matches_jax(name, soft):
    shape = (2, 4, 6, 5, 7)
    jfn, tfn = getattr(jdice, NAMES[name]), LOSSES[name]
    _compare(lambda xs, t: jfn(xs[0], t), lambda xs, t: tfn(xs[0], t),
             [_logits(1, shape)], _target(2, shape, soft))


@pytest.mark.parametrize("soft", [False, True], ids=["onehot", "soft"])
@pytest.mark.parametrize("name", list(NAMES))
def test_deep_supervision_loss_matches_jax(name, soft):
    """A three-level pyramid (8³, 4³, 2³) against an 8³ target, which the
    wrapper takes at each level by strided slicing."""
    pyramid = [_logits(3 + i, (2, 4) + (8 // 2 ** i,) * 3) for i in range(3)]
    jfn, tfn = getattr(jdice, NAMES[name]), LOSSES[name]
    _compare(lambda xs, t: jdice.deep_supervision_loss(xs, t, loss_fn=jfn),
             lambda xs, t: tdice.deep_supervision_loss(xs, t, loss_fn=tfn),
             pyramid, _target(4, (2, 4, 8, 8, 8), soft))


@pytest.mark.parametrize("kw", [dict(ce_weight=0.0), dict(dice_weight=0.5, ce_weight=2.0),
                                dict(include_background=False, smooth=1.0)],
                         ids=["dice_only", "weighted", "no_background"])
def test_softmax_dice_ce_options_match_jax(kw):
    shape = (2, 3, 5, 6, 4)
    _compare(lambda xs, t: jdice.softmax_dice_ce_loss(xs[0], t, **kw),
             lambda xs, t: tdice.softmax_dice_ce_loss(xs[0], t, **kw),
             [_logits(5, shape)], _target(6, shape, False))


def test_edice_and_square_volume_gdl_match_jax():
    shape = (2, 3, 5, 6, 4)
    x, t = [_logits(7, shape)], _target(8, shape, False)
    _compare(lambda xs, t: jdice.edice_loss(xs[0], t),
             lambda xs, t: tdice.edice_loss(xs[0], t), x, t)
    _compare(lambda xs, t: jdice.generalized_dice_loss(xs[0], t, square_volumes=True),
             lambda xs, t: tdice.generalized_dice_loss(xs[0], t, square_volumes=True), x, t)


def test_default_softmax_dice_ce_is_bitwise_unchanged():
    """The default path that the dice_ce runs take: value and gradient pinned
    to their bits before the loss took its weights and options."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 4, 6, 5, 7)).astype(np.float32))
    lab = rng.integers(0, 4, (2, 6, 5, 7))
    t = torch.from_numpy(np.eye(4, dtype=np.float32)[lab]).movedim(-1, 1)
    x.requires_grad_(True)
    v = tdice.softmax_dice_ce_loss(x, t)
    v.backward()
    assert v.item().hex() == "0x1.32eb700000000p+1"
    assert hashlib.sha256(x.grad.numpy().tobytes()).hexdigest()[:16] == "68e3284060225589"


@pytest.mark.parametrize("name", list(NAMES))
def test_loss_computes_in_f32_under_bf16_autocast(name):
    """Under bf16 autocast a loss of f32 logits is bitwise the loss without
    autocast, and bf16 logits give the loss of their f32 upcast: nothing in
    it runs in bf16."""
    shape = (2, 4, 6, 5, 7)
    x = torch.from_numpy(_logits(9, shape))
    t = torch.from_numpy(_target(10, shape, False))
    fn = LOSSES[name]
    want = fn(x, t)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = fn(x, t)
        got_bf16 = fn(x.bfloat16(), t)
    assert got.dtype == got_bf16.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(got_bf16, fn(x.bfloat16().float(), t))


def test_topk_takes_k_over_the_whole_flattened_batch():
    """k = max(1, int(N·k%/100)) of all N voxels of the batch: one sample
    with large errors takes the whole top-k."""
    x = np.zeros((2, 3, 4, 4, 5), np.float32)
    t = _target(11, x.shape, False)
    x[0] = -20.0 * t[0]                    # sample 0 confidently wrong
    got = tdice.topk_ce_loss(torch.from_numpy(x), torch.from_numpy(t), k_percent=25.0)
    ce0 = -(torch.from_numpy(t[0]) * torch.log_softmax(torch.from_numpy(x[0]), 0)).sum(0)
    k = int(2 * 80 * 25 / 100)
    assert got.item() == pytest.approx(ce0.flatten().topk(k).values.mean().item(), rel=1e-6)
    assert got.item() == pytest.approx(float(jdice.topk_ce_loss(jnp.asarray(x), jnp.asarray(t),
                                                                25.0)), rel=1e-6)
