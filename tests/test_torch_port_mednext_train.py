"""The MedNeXt training slice against the JAX package on the CPU: the K3
backward's plain version and the autograd Function around the kernel, the
depthwise layer under bf16 autocast, the dice_ce and deep-supervision
losses, the "nnunet" augmentation stack, one MedNeXt trainer step against
the JAX `Trainer` (mdice, and dice_ce with deep supervision), and
`cli/train.py --device cpu --model mednext` with the nnU-Net preset.

Inputs come from numpy with a seed; both sides get the same arrays. The JAX
modules are channels-last where the port is channels-first, so inputs are
transposed. Augmentations cannot share a PRNG: the JAX draws are read off
its keys and handed to the port's transforms. The JAX package reads its
MICFORMER_* flags at import; they are cleared here first, so it runs its
default forms.
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

from micformer_tpu.data import transforms as jtf  # noqa: E402
from micformer_tpu.losses import dice as jdice  # noqa: E402
from micformer_tpu.models import mednext as jm  # noqa: E402
from micformer_tpu.ops.pallas.dw_stencil import dw_conv3_pallas  # noqa: E402
from micformer_tpu.train.trainer import TrainConfig as JConfig  # noqa: E402
from micformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from micformer_tpu_torch.config import build_argparser, config_from_args  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.data import transforms as ttf  # noqa: E402
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from micformer_tpu_torch.kernels import LAUNCHES  # noqa: E402
from micformer_tpu_torch.kernels.dw_conv3 import (  # noqa: E402
    dw_conv3, dw_conv3_backward, dw_conv3_backward_reference,
)
from micformer_tpu_torch.losses import dice as tdice  # noqa: E402
from micformer_tpu_torch.models import layers as tl  # noqa: E402
from micformer_tpu_torch.models import mednext as tm  # noqa: E402
from micformer_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arr(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cf(a):
    """JAX channels-last numpy array -> the port's channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _dw_weight(w):
    """flax depthwise kernel [k, k, k, 1, C] -> Conv3d weight [C, 1, k, k, k]."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


# -- K3's backward -----------------------------------------------------------------

# (channels-last [B, D, H, W, C], k): ragged, no axis a multiple of another
BWD_CASES = [((2, 5, 6, 7, 3), 3), ((1, 6, 5, 9, 2), 5)]


def _jax_vjp(x, w, g):
    """(dx, dw) of dw_conv3_pallas in interpret mode, channels-last."""
    _, vjp = jax.vjp(lambda a, b: dw_conv3_pallas(a, b, True), jnp.asarray(x), jnp.asarray(w))
    return tuple(np.asarray(t) for t in vjp(jnp.asarray(g)))


@pytest.fixture(scope="module", params=BWD_CASES, ids=["k3", "k5"])
def bwd_case(request):
    (B, D, H, W, C), k = request.param
    x, g = _arr(1, (B, D, H, W, C)), _arr(2, (B, D, H, W, C))
    w = _arr(3, (k, k, k, 1, C)) / k ** 1.5
    return x, w, g, _jax_vjp(x, w, g)


def test_dw_conv3_backward_reference_matches_pallas_vjp(bwd_case):
    """dx, dw against jax.vjp of the Pallas kernel (f32, 1e-5: sums of up to
    540 f32 terms in another order); db is the sum of g."""
    x, w, g, (jdx, jdw) = bwd_case
    dx, dw, db = dw_conv3_backward_reference(_cf(x), _dw_weight(w), _cf(g))
    np.testing.assert_allclose(np.moveaxis(dx.numpy(), 1, -1), jdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), _dw_weight(jdw).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), g.sum((0, 1, 2, 3)), rtol=1e-5, atol=1e-5)
    assert dx.dtype == dw.dtype == db.dtype == torch.float32
    # the wrapper on CPU tensors is the plain version, with no launch
    before = dict(LAUNCHES)
    for a, b in zip(dw_conv3_backward(_cf(x), _dw_weight(w), _cf(g)), (dx, dw, db)):
        assert torch.equal(a, b)
    assert LAUNCHES == before


def test_dw_conv3_autograd_on_cpu_matches_pallas_vjp(bwd_case):
    """dw_conv3 under autograd (the Function's CPU branch) gives the JAX
    gradients for x and w and Σg for the bias (f32, 1e-5)."""
    x, w, g, (jdx, jdw) = bwd_case
    xt, wt = _cf(x).requires_grad_(), _dw_weight(w).requires_grad_()
    bt = torch.zeros(x.shape[-1], requires_grad=True)
    before = dict(LAUNCHES)
    dw_conv3(xt, wt, bt).backward(_cf(g))
    assert LAUNCHES == before
    np.testing.assert_allclose(np.moveaxis(xt.grad.numpy(), 1, -1), jdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), _dw_weight(jdw).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), g.sum((0, 1, 2, 3)), rtol=1e-5, atol=1e-5)
    # only what autograd asks for: w alone
    wt.grad = None
    dw_conv3(_cf(x), wt).backward(_cf(g))
    np.testing.assert_allclose(wt.grad.numpy(), _dw_weight(jdw).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("need_dx, need_dwb", [(True, False), (False, True)])
def test_dw_conv3_backward_computes_only_what_is_asked(bwd_case, need_dx, need_dwb):
    """The backward that autograd runs: the gradients not asked for are
    None, the others the JAX ones (f32, 1e-5)."""
    x, w, g, (jdx, jdw) = bwd_case
    dx, dw, db = dw_conv3_backward(_cf(x), _dw_weight(w), _cf(g), need_dx, need_dwb)
    assert (dx is not None) == need_dx and (dw is not None) == (db is not None) == need_dwb
    if need_dx:
        np.testing.assert_allclose(np.moveaxis(dx.numpy(), 1, -1), jdx, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(dw.numpy(), _dw_weight(jdw).numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(db.numpy(), g.sum((0, 1, 2, 3)), rtol=1e-5, atol=1e-5)


def test_dw_conv3_backward_checks_its_gradient():
    x, w = torch.zeros(1, 2, 4, 4, 4), torch.zeros(2, 1, 3, 3, 3)
    for g in (torch.zeros(1, 2, 4, 4, 5), torch.zeros(1, 2, 4, 4, 4, dtype=torch.bfloat16),
              torch.zeros(1, 2, 4, 4, 4).transpose(3, 4)):
        with pytest.raises(ValueError):
            dw_conv3_backward(x, w, g)


@pytest.mark.parametrize("mode", ["same", "stride2", "pad", "transpose2"])
def test_depthwise_conv_under_bf16_autocast_gives_f32_gradients(mode):
    """DepthwiseConv3D with f32 parameters on a bf16 activation under CPU
    autocast: runs, returns bf16, hands f32 gradients to its parameters
    close to the f32 layer's (bf16 rounding of inputs and outputs: 3e-2 of
    the gradient's max)."""
    kw = {"same": {}, "stride2": dict(stride=2), "pad": dict(pad=((1, 1), (0, 2), (2, 0))),
          "transpose2": dict(transpose2=True)}[mode]
    torch.manual_seed(0)
    layer = tl.DepthwiseConv3D(4, 3, **kw)
    with torch.no_grad():
        layer.bias.normal_()
    x = torch.from_numpy(_arr(4, (2, 4, 6, 8, 6)))
    ref = layer(x)
    g = torch.from_numpy(_arr(5, tuple(ref.shape)))
    ref.backward(g)
    want = {n: p.grad.clone() for n, p in layer.named_parameters()}
    layer.zero_grad(set_to_none=True)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = layer(x.bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    out.backward(g.bfloat16())
    for n, p in layer.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, n
        scale = want[n].abs().max().item()
        assert (p.grad - want[n]).abs().max().item() <= 3e-2 * scale, n


# -- losses ---------------------------------------------------------------------------

def _logits_and_target(seed, shape=(2, 8, 8, 8, 8)):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    idx = rng.integers(0, shape[1], size=(shape[0],) + shape[2:])
    return logits, np.moveaxis(np.eye(shape[1], dtype=np.float32)[idx], -1, 1)


@pytest.mark.parametrize("target_kind", ["one_hot", "soft"])
def test_softmax_dice_ce_loss_matches_jax(target_kind):
    """Value (rel 1e-5) and gradient in the logits (1e-5 of its max), f32
    sums over 8³·8 voxels in another order, on a one-hot and on a soft
    target (the affine-warped label), at JAX's defaults."""
    logits, t = _logits_and_target(0)
    target = t if target_kind == "one_hot" else t * 0.7 + 0.3 / t.shape[1]
    jv, jg = jax.value_and_grad(lambda lg: jdice.softmax_dice_ce_loss(
        lg, jnp.asarray(target)))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    v = tdice.softmax_dice_ce_loss(lt, torch.from_numpy(target))
    v.backward()
    assert v.item() == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())


@pytest.mark.parametrize("loss", ["dice_ce", "mdice"])
def test_deep_supervision_loss_matches_jax(loss):
    """The five-level pyramid (full to 1/16) at 32³: weights 2^-i
    normalised, targets sliced [::f]; value (rel 1e-5) and every level's
    gradient (1e-4 of its max), f32 sums over 32³·8 voxels in another
    order, which mdice's gradient takes differences of."""
    logits, t = _logits_and_target(1, (1, 8, 32, 32, 32))
    pyramid = [logits] + [_arr(10 + i, (1, 8) + (32 // 2 ** i,) * 3) * 3 for i in range(1, 5)]
    jfn_loss = {"dice_ce": jdice.softmax_dice_ce_loss, "mdice": jdice.mdice_loss}[loss]
    tfn_loss = {"dice_ce": tdice.softmax_dice_ce_loss, "mdice": tdice.mdice_loss}[loss]
    jv, jg = jax.value_and_grad(lambda p: jdice.deep_supervision_loss(
        p, jnp.asarray(t), loss_fn=jfn_loss))([jnp.asarray(a) for a in pyramid])
    tp = [torch.from_numpy(a).requires_grad_() for a in pyramid]
    v = tdice.deep_supervision_loss(tp, torch.from_numpy(t), loss_fn=tfn_loss)
    v.backward()
    assert v.item() == pytest.approx(float(jv), rel=1e-5)
    for a, b in zip(tp, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(b)).max())


# -- the "nnunet" augmentation stack ----------------------------------------------------

def _aug_sample(seed, C=2, K=4, shape=(6, 7, 5)):
    """One sample: image [C, D, H, W], one-hot label [K, D, H, W]."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(C,) + shape).astype(np.float32)
    idx = rng.integers(0, K, size=shape)
    return img, np.moveaxis(np.eye(K, dtype=np.float32)[idx], -1, 0)


def _u(key, lo, hi, shape=()):
    """U(lo, hi) from a JAX key: a float, or an array of `shape`."""
    u = np.array(jax.random.uniform(key, shape, minval=lo, maxval=hi))
    return float(u) if shape == () else u


def _t(*arrays):
    """Each array as a float32 batch of one."""
    return [torch.from_numpy(np.array(a, dtype=np.float32))[None] for a in arrays]


def test_intensity_transforms_match_jax_given_the_same_draws():
    """Noise, blur (circular shift, radius 3), inverted and plain gamma
    (min and max over all channels jointly) and the scale at p 1, each on
    the draw read off the JAX key; p 0 leaves the image as it was."""
    img, _ = _aug_sample(0)
    key = jax.random.key(3)
    x = jnp.asarray(img)
    (ti,) = _t(img)

    kn, ks, _ = jax.random.split(key, 3)
    sigma = _u(ks, 0.0, 0.1)
    noise = np.array(jax.random.normal(kn, img.shape, jnp.float32))
    got = ttf.gaussian_noise(ti, *_t(noise), torch.tensor([sigma]))
    np.testing.assert_allclose(got[0].numpy(), jtf.rand_gaussian_noise(key, x, prob=1.0),
                               atol=1e-6)
    np.testing.assert_array_equal(jtf.rand_gaussian_noise(key, x, prob=0.0), img)

    sigma = _u(jax.random.split(key)[0], 0.5, 1.0)
    got = ttf.gaussian_blur(ti, torch.tensor([sigma]))
    np.testing.assert_allclose(got[0].numpy(), jtf.rand_gaussian_blur(key, x, prob=1.0),
                               atol=1e-6)
    # sigma floored at 1e-3: the blur of a tiny sigma is the identity
    np.testing.assert_allclose(ttf.gaussian_blur(ti, torch.tensor([0.0]))[0].numpy(), img,
                               atol=1e-6)

    f = _u(jax.random.split(key)[0], -0.25, 0.25)
    np.testing.assert_allclose(ttf.scale_intensity(ti, torch.tensor([f]))[0].numpy(),
                               jtf.rand_scale_intensity(key, x, 0.25, prob=1.0), rtol=1e-6)

    gamma = _u(jax.random.split(key)[0], 0.7, 1.5)
    for invert in (False, True):
        got = ttf.gamma_transform(ti, torch.tensor([gamma]), invert=invert)
        want = jtf.rand_gamma(key, x, prob=1.0, invert_image=invert)
        np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-5)


def test_spatial_transforms_match_jax_given_the_same_draws():
    """The rotation and zoom about the centre, and the elastic field
    (radius-4 blur at sigma / 3, times alpha), on image and one-hot label
    through trilinear resampling with zeros padding; the label stays soft."""
    img, lab = _aug_sample(1)
    key = jax.random.key(5)
    ti, tlab = _t(img, lab)
    k1, k2, k3, k4, _ = jax.random.split(key, 5)
    angles = torch.tensor([[_u(k, -0.26, 0.26) for k in (k1, k2, k3)]])
    zoom = torch.tensor([_u(k4, 0.85, 1.25)])
    got = ttf.affine_transform(ti, tlab, angles, zoom)
    want = jtf.rand_affine(key, jnp.asarray(img), jnp.asarray(lab), prob=1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), w, atol=2e-5)
    soft = got[1].numpy()
    assert ((soft > 1e-3) & (soft < 1 - 1e-3)).any()              # the label is soft

    ka, ks, kn, _ = jax.random.split(key, 4)
    alpha, sigma = _u(ka, 0.0, 200.0), _u(ks, 9.0, 13.0)
    noise = _u(kn, -1.0, 1.0, (3,) + img.shape[1:])
    got = ttf.elastic_transform(ti, tlab, *_t(noise), torch.tensor([alpha]),
                                torch.tensor([sigma]))
    want = jtf.rand_elastic(key, jnp.asarray(img), jnp.asarray(lab), prob=1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), w, atol=2e-5)


# the stack's transforms with their probabilities, in JAX's key order
STACK_P = {"affine": 0.2, "noise": 0.1, "blur": 0.2, "scale": 0.15, "gamma_inv": 0.1,
           "gamma": 0.3}


def _jax_stack_draws(key, B, mod_shape):
    """The draws batched_nnunet_train_augment makes, read off its keys, as
    the port's draw dict."""
    d = {n: [] for n in ("affine", "affine_angles", "affine_zoom", "noise", "noise_sigma",
                         "noise_field", "blur", "blur_sigma", "scale", "scale_factor",
                         "gamma_inv", "gamma_inv_gamma", "gamma", "gamma_gamma", "flip")}
    for k in jax.random.split(key, B):
        ks = jax.random.split(k, 9)
        k1, k2, k3, k4, kp = jax.random.split(ks[0], 5)
        d["affine"].append(bool(jax.random.bernoulli(kp, STACK_P["affine"])))
        d["affine_angles"].append([_u(a, -0.26, 0.26) for a in (k1, k2, k3)])
        d["affine_zoom"].append(_u(k4, 0.85, 1.25))
        kn, kso, kp = jax.random.split(ks[1], 3)
        d["noise"].append(bool(jax.random.bernoulli(kp, STACK_P["noise"])))
        d["noise_sigma"].append(_u(kso, 0.0, 0.1))
        d["noise_field"].append(np.array(jax.random.normal(kn, mod_shape, jnp.float32)))
        for name, i, lo, hi, param in (("blur", 2, 0.5, 1.0, "blur_sigma"),
                                       ("scale", 3, -0.25, 0.25, "scale_factor"),
                                       ("gamma_inv", 4, 0.7, 1.5, "gamma_inv_gamma"),
                                       ("gamma", 5, 0.7, 1.5, "gamma_gamma")):
            kv, kp = jax.random.split(ks[i])
            d[name].append(bool(jax.random.bernoulli(kp, STACK_P[name])))
            d[param].append(_u(kv, lo, hi))
        d["flip"].append([bool(jax.random.bernoulli(ks[6 + a], 0.5)) for a in range(3)])
    arrays = {n: np.asarray(v) for n, v in d.items()}
    return {n: torch.from_numpy(a if a.dtype == bool else a.astype(np.float32))
            for n, a in arrays.items()}


def _covering_key(B):
    """The first key whose batch applies every transform of the stack to at
    least one sample, so that the comparison exercises all of them."""
    @jax.jit
    def flags(key):
        def one(k):
            ks = jax.random.split(k, 9)
            subs = [jax.random.split(ks[0], 5)[4], jax.random.split(ks[1], 3)[2]] + [
                jax.random.split(ks[i])[1] for i in (2, 3, 4, 5)]
            return jnp.stack([jax.random.bernoulli(s, p)
                              for s, p in zip(subs, STACK_P.values())])
        return jax.vmap(one)(jax.random.split(key, B)).any(0).all()

    return next(jax.random.key(s) for s in range(2000) if bool(flags(jax.random.key(s))))


@pytest.mark.parametrize("num_modalities", [None, 1])
def test_batched_nnunet_augment_matches_jax_given_the_same_draws(num_modalities):
    """The whole stack on a batch of four, on JAX's draws; with
    num_modalities 1 the intensity steps leave the second channel alone."""
    B = 4
    rng = np.random.default_rng(7)
    imgs, labs = zip(*(_aug_sample(int(rng.integers(1 << 30))) for _ in range(B)))
    img, lab = np.stack(imgs), np.stack(labs)
    key = _covering_key(B)
    want_i, want_l = jtf.batched_nnunet_train_augment(key, jnp.asarray(img), jnp.asarray(lab),
                                                      num_modalities)
    mod_shape = img.shape[1:] if num_modalities is None else (num_modalities,) + img.shape[2:]
    draws = _jax_stack_draws(key, B, mod_shape)
    for name in STACK_P:
        assert bool(draws[name].any()), name
    got_i, got_l = ttf.apply_nnunet_augment(torch.from_numpy(img), torch.from_numpy(lab),
                                            draws, num_modalities)
    assert got_l.dtype == torch.float32
    np.testing.assert_allclose(got_i.numpy(), want_i, rtol=1e-5, atol=3e-5)
    np.testing.assert_allclose(got_l.numpy(), want_l, atol=2e-5)


def test_nnunet_draws_have_the_stack_distributions():
    """The port's own draws: each flag a coin at its probability, each
    parameter uniform in its range, the noise field standard normal."""
    d = ttf.draw_nnunet_augment(torch.Generator().manual_seed(0), 20000, (1, 2, 2, 2))
    for name, p in STACK_P.items():
        assert d[name].dtype == torch.bool and d[name].shape == (20000,)
        assert abs(d[name].float().mean().item() - p) < 0.015, name
    assert abs(d["flip"].float().mean().item() - 0.5) < 0.015 and d["flip"].shape == (20000, 3)
    for name, lo, hi in (("affine_angles", -0.26, 0.26), ("affine_zoom", 0.85, 1.25),
                         ("noise_sigma", 0.0, 0.1), ("blur_sigma", 0.5, 1.0),
                         ("scale_factor", -0.25, 0.25), ("gamma_inv_gamma", 0.7, 1.5),
                         ("gamma_gamma", 0.7, 1.5)):
        v = d[name]
        assert lo <= v.min() and v.max() <= hi, name
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.01 * (hi - lo), name
    f = d["noise_field"]
    assert f.shape == (20000, 1, 2, 2, 2)
    assert abs(f.mean().item()) < 0.01 and abs(f.std().item() - 1.0) < 0.01
    # the batched stack draws per sample and keeps shapes; the label turns float
    img, lab = (torch.from_numpy(a)[None].repeat(3, 1, 1, 1, 1) for a in _aug_sample(2))
    out_i, out_l = ttf.batched_nnunet_train_augment(torch.Generator().manual_seed(1),
                                                    img, lab)
    assert out_i.shape == img.shape and out_l.shape == lab.shape
    assert torch.isfinite(out_i).all() and out_l.dtype == torch.float32


def test_rand_elastic_applies_its_generator_draw():
    """alpha U(0, 200), sigma U(9, 13), the field U(-1, 1), then the coin,
    drawn in that order from the generator."""
    img, lab = (torch.from_numpy(a)[None] for a in _aug_sample(3))
    got = ttf.rand_elastic(torch.Generator().manual_seed(4), img, lab, prob=1.0)
    gen = torch.Generator().manual_seed(4)
    alpha = torch.rand((1,), generator=gen) * 200.0
    sigma = torch.rand((1,), generator=gen) * 4.0 + 9.0
    noise = torch.rand((1, 3) + img.shape[2:], generator=gen) * 2.0 - 1.0
    want = ttf.elastic_transform(img, lab, noise, alpha, sigma)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    same = ttf.rand_elastic(torch.Generator().manual_seed(4), img, lab, prob=0.0)
    assert torch.equal(same[0], img) and torch.equal(same[1], lab)


# -- one trainer step against the JAX Trainer ---------------------------------------------

# a narrow MedNeXt-S: 4 channels, one block a stage, at 1x2x32³
SMALL = dict(num_classes=8, n_channels=4, block_counts=(1,) * 9)
OPT = dict(optimizer="sgd_nesterov", lr=0.05, epochs=10, steps_per_epoch=1, augment="none")
VARIANTS = {"mdice": dict(loss="mdice", deep_supervision=False),
            "dice_ce_ds": dict(loss="dice_ce", deep_supervision=True)}


def _batch(seed, shape=(32, 32, 32)):
    """A loader batch: f16 image [1, 2, *shape], uint8 class map [1, *shape]."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, 2) + shape).astype(np.float16)
    lab = rng.integers(0, 8, (1,) + shape).astype(np.uint8)
    return img, lab


def _jax_reference(variant, run_dir, steps=3):
    """The JAX trainer from its own init: (params, loss and grads of the
    first step, params after `steps` train steps), as numpy trees."""
    cfg = VARIANTS[variant]
    model = jm.MedNeXt(deep_supervision=cfg["deep_supervision"], **SMALL)
    # barring TensorBoard keeps the JAX MetricsWriter on its JSONL path
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        trainer = JTrainer(model, JConfig(run_dir=str(run_dir), **OPT, **cfg))
    state = trainer.init_state((1, 2, 32, 32, 32))
    params0 = jax.tree.map(np.asarray, state.params)
    img, lab = (jnp.asarray(a) for a in _batch(0))

    def loss_fn(params):
        images, labels = trainer._prep_batch(img, lab)
        return trainer._loss(model.apply({"params": params}, images, deterministic=False),
                             labels)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    losses = []
    for i in range(steps):
        state, metrics = trainer.train_step(state, img, lab, jax.random.key(i))
        losses.append(float(metrics["loss"]))
    return {"params0": params0, "loss": float(loss), "losses": losses,
            "grads": jax.tree.map(np.asarray, grads),
            "params": jax.tree.map(np.asarray, state.params)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def mednext_reference(request, tmp_path_factory):
    return request.param, _jax_reference(request.param, tmp_path_factory.mktemp("jax_run"))


def test_mednext_train_step_matches_jax_trainer(mednext_reference, tmp_path):
    """Loss (rel 1e-5), every gradient leaf (1e-3 of the leaf's max |g|;
    the depthwise biases, whose exact gradient is zero, within 1e-5 of the
    largest gradient) and the parameters after three SGD-Nesterov steps
    (atol 1e-6) against the JAX trainer, through the depthwise Function's
    CPU branch."""
    variant, ref = mednext_reference
    cfg = VARIANTS[variant]
    model = tm.MedNeXt(deep_supervision=cfg["deep_supervision"], **SMALL)
    model.load_state_dict(state_dict_from_flax(ref["params0"], model))
    trainer = Trainer(model, TrainConfig(run_dir=str(tmp_path), **OPT, **cfg))
    img, lab = (torch.from_numpy(a) for a in _batch(0))
    rec = trainer.train_step(img, lab)
    assert rec["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    want = state_dict_from_flax(ref["grads"], model)
    top = max(g.abs().max().item() for g in want.values())
    worst = 0.0
    for name, p in model.named_parameters():
        if name.endswith("dw.bias"):
            # an instance norm follows every depthwise conv, so its bias's
            # gradient is zero in exact arithmetic: both sides hold rounding
            assert max(p.grad.abs().max().item(), want[name].abs().max().item()) <= 1e-5 * top
            continue
        scale = want[name].abs().max().item()
        worst = max(worst, (p.grad - want[name]).abs().max().item() / scale)
    assert worst <= 1e-3, worst
    for _ in range(2):
        trainer.train_step(img, lab)
    after = state_dict_from_flax(ref["params"], model)
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, after[name], rtol=0, atol=1e-6, msg=name)
    assert trainer.step == 3
    assert [r["loss"] for r in trainer.history] == pytest.approx(ref["losses"], rel=1e-5)
    assert all(n == 0 for n in rec["launches"].values())


def test_trainer_takes_full_resolution_without_the_deep_supervision_flag(tmp_path):
    """A pyramid without --deep-supervision trains on its first output, as
    the JAX trainer's logits[0]; validation reads the first output too."""
    model = tm.MedNeXt(deep_supervision=True, **SMALL)
    trainer = Trainer(model, TrainConfig(run_dir=str(tmp_path), loss="dice_ce", **{
        k: v for k, v in OPT.items()}))
    images, labels = trainer.prep_batch(*(torch.from_numpy(a) for a in _batch(1, (16,) * 3)))
    out = model(images)
    assert len(out) == 5
    loss = trainer.loss(out, labels)
    assert loss.item() == pytest.approx(tdice.softmax_dice_ce_loss(out[0], labels).item())
    vm = trainer.validate([(torch.from_numpy(_batch(1, (16,) * 3)[0]),
                            torch.from_numpy(_batch(1, (16,) * 3)[1]), {})])
    assert np.isfinite(vm["val_loss"]) and vm["per_class_dice"].shape == (1, 8)


# -- the command line ------------------------------------------------------------------------

def test_mednext_config_loads_as_published():
    """configs/mednext_s_mmwhs.yaml: MedNeXt-S k3, batch 2, lr 1e-4, and the
    nnU-Net preset's flags on top of it."""
    args = build_argparser().parse_args(
        ["--cfg", os.path.join(REPO, "configs", "mednext_s_mmwhs.yaml")])
    cfg = config_from_args(args)
    assert cfg.model.name == "mednext" and cfg.model.extra == {"size": "S", "kernel": 3}
    assert cfg.train.batch_size == 2 and cfg.train.lr == 1e-4
    assert cfg.train.extra_loss == "mdice" and not cfg.train.deep_supervision
    assert cfg.train.augment == "monai"
    args = build_argparser().parse_args(
        ["--cfg", os.path.join(REPO, "configs", "mednext_s_mmwhs.yaml"), "--deep-supervision",
         "--loss", "dice_ce", "--augment", "nnunet", "--model-kwargs",
         '{"deep_supervision": true}'])
    cfg = config_from_args(args)
    assert cfg.train.extra_loss == "dice_ce" and cfg.train.deep_supervision
    assert cfg.train.augment == "nnunet"
    assert cfg.model.extra == {"size": "S", "kernel": 3, "deep_supervision": True}
    # the loss zoo parses; a name the JAX parser lacks does not
    assert build_argparser().parse_args(["--loss", "gdl"]).loss == "gdl"
    for bad in (["--loss", "edice"], ["--augment", "rand"]):
        with pytest.raises(SystemExit):
            build_argparser().parse_args(bad)


def test_cli_train_mednext_nnunet_preset_on_cpu_and_resume(tmp_path):
    """Two epochs of the nnU-Net preset through `cli/train.py --device cpu`
    (a 4-channel MedNeXt-S with its pyramid, 16³, four train cases), then
    --resume for a third."""
    from micformer_tpu_torch.cli import train

    data = tmp_path / "data"
    write_synthetic_dataset(str(data), n_cases=6, shape=(20, 18, 22), seed=0)
    run = tmp_path / "run"
    args = ["--data", str(data), "--cache", str(tmp_path / "cache"), "--device", "cpu",
            "--model", "mednext", "--model-kwargs",
            json.dumps({"deep_supervision": True, "n_channels": 4}),
            "--deep-supervision", "--loss", "dice_ce", "--augment", "nnunet",
            "--optimizer", "sgd_nesterov", "--grad-clip", "12", "--lr", "1e-3",
            "--target-shape", "16", "--val", "1", "--run-dir", str(run), "--workers", "2"]
    before = dict(LAUNCHES)
    trainer = train.main(args + ["--epochs", "2"])
    assert trainer.step == 8 and len(trainer.history) == 8
    assert all(np.isfinite(r["loss"]) and not r["skipped"] for r in trainer.history)
    assert trainer.cfg.loss == "dice_ce" and trainer.cfg.deep_supervision
    assert trainer.cfg.augment == "nnunet" and trainer.cfg.grad_clip_norm == 12
    assert LAUNCHES == before
    log = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in log if "train_loss" in r] == [0, 1]
    assert all(np.isfinite(r["meandice"]) for r in log if "meandice" in r)
    saved = json.loads((run / "config.json").read_text())
    assert saved["train"]["extra_loss"] == "dice_ce" and saved["train"]["deep_supervision"]
    resumed = train.main(args + ["--epochs", "3", "--resume"])
    assert resumed.step == 12 and len(resumed.history) == 4
