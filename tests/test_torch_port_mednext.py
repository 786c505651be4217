"""The port's MedNeXt slice against the JAX package on the CPU: the depthwise
kernel's plain version and wrapper, MedNeXt's layers and block, the whole
model on converted weights, under sliding-window inference and in the serve
loop.

The JAX modules take channels-last [B, D, H, W, C] tensors and the port
channels-first [B, C, D, H, W]: every input is made with numpy in the JAX
layout and transposed for the port, and the port's output transposed back.
Weights are drawn with numpy (biases away from zero, norm scales away from
one), so that every term is exercised. All comparisons are f32 in eval
mode. The JAX package's MICFORMER_* flags are cleared before it is
imported, so it runs its default forms (stencil depthwise convs,
interleaved up blocks, no W packing, two-stage norm statistics).
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu.infer import sliding_window as jsw  # noqa: E402
from micformer_tpu.models import layers as jl  # noqa: E402
from micformer_tpu.models import mednext as jm  # noqa: E402
from micformer_tpu.ops.pallas.dw_stencil import dw_conv3_pallas  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.cli import serve  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.data.nifti import read_nifti  # noqa: E402
from micformer_tpu_torch.infer import sliding_window as tsw  # noqa: E402
from micformer_tpu_torch.kernels import LAUNCHES  # noqa: E402
from micformer_tpu_torch.kernels.dw_conv3 import dw_conv3, dw_conv3_reference  # noqa: E402
from micformer_tpu_torch.models import layers as tl  # noqa: E402
from micformer_tpu_torch.models import mednext as tm  # noqa: E402

# f32 sums of 27-125 taps, or of a block's few layers, in another order
ATOL = 1e-5


def _arr(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cf(a):
    """JAX channels-last numpy array -> the port's channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t):
    """The port's channels-first tensor -> channels-last numpy array."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _dw_weight(w):
    """flax depthwise kernel [k, k, k, 1, C] -> Conv3d weight [C, 1, k, k, k]."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


def _params(flax_mod, x, seed):
    """Random parameters for flax_mod on input x, drawn with numpy into the
    tree `init` would make (its shapes, from `jax.eval_shape`, with nothing
    compiled): kernels with variance 1/fan_in, biases around 0 and norm
    scales around 1, so that every term is exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(flax_mod.init, jax.random.key(0), x)["params"]
    flat = {}
    for key, sd in flatten_dict(shapes).items():
        z = rng.normal(size=sd.shape).astype(np.float32)
        if key[-1] == "kernel":
            flat[key] = z / np.sqrt(np.prod(sd.shape[:-1]))
        else:
            flat[key] = 0.1 * z + (1.0 if key[-1] == "scale" else 0.0)
    return unflatten_dict(flat)


def _port(flax_mod, torch_mod, x_cl):
    """Load random weights into flax_mod and torch_mod; returns (port
    output, JAX output), both channels-last numpy."""
    x = jnp.asarray(x_cl)
    params = _params(flax_mod, x, 1)
    torch_mod.load_state_dict(state_dict_from_flax(params, torch_mod))
    torch_mod.eval()
    ref = np.asarray(flax_mod.apply({"params": params}, x))
    with torch.no_grad():
        got = _cl(torch_mod(_cf(x_cl)))
    return got, ref


# -- the depthwise kernel's plain version and wrapper -------------------------

DW_CASES = [((2, 6, 8, 10, 5), 3), ((1, 4, 6, 6, 7), 5)]


@pytest.mark.parametrize("shape,k", DW_CASES)
def test_dw_conv3_reference_matches_jax_stencil(shape, k):
    x, w = _arr(0, shape), _arr(1, (k, k, k, 1, shape[-1]))
    ref = np.asarray(jl.dw_conv_stencil(jnp.asarray(x), jnp.asarray(w)))
    got = _cl(dw_conv3_reference(_cf(x), _dw_weight(w)))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_dw_conv3_reference_matches_pallas_kernel_in_interpret_mode():
    shape, k = DW_CASES[0]
    x, w = _arr(2, shape), _arr(3, (k, k, k, 1, shape[-1]))
    ref = np.asarray(dw_conv3_pallas(jnp.asarray(x), jnp.asarray(w), True))
    got = _cl(dw_conv3_reference(_cf(x), _dw_weight(w)))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_dw_conv3_on_cpu_is_the_plain_version_with_bias():
    x, w, b = (torch.from_numpy(_arr(4, (2, 3, 5, 4, 6))),
               torch.from_numpy(_arr(5, (3, 1, 3, 3, 3))), torch.from_numpy(_arr(6, (3,))))
    before = dict(LAUNCHES)
    got = dw_conv3(x, w, b)
    assert LAUNCHES == before
    torch.testing.assert_close(got, dw_conv3_reference(x, w, b), rtol=0, atol=0)
    ref = torch.nn.functional.conv3d(x, w, b, padding=1, groups=3)
    torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)
    xb, wb = x.bfloat16(), w.bfloat16()
    assert dw_conv3(xb, wb).dtype == torch.bfloat16


@pytest.mark.parametrize("case", [
    "x_4d", "w_k4", "w_channels", "bias_shape", "float16", "mixed_dtype",
    "x_channels_last", "w_strided", "meta_device",
])
def test_dw_conv3_raises_on_what_the_kernel_does_not_take(case):
    x, w = torch.zeros(1, 4, 5, 5, 5), torch.zeros(4, 1, 3, 3, 3)
    bias = None
    if case == "x_4d":
        x = x[0]
    elif case == "w_k4":
        w = torch.zeros(4, 1, 4, 4, 4)
    elif case == "w_channels":
        w = torch.zeros(3, 1, 3, 3, 3)
    elif case == "bias_shape":
        bias = torch.zeros(5)
    elif case == "float16":
        x, w = x.half(), w.half()
    elif case == "mixed_dtype":
        w = w.bfloat16()
    elif case == "x_channels_last":
        x = torch.zeros(1, 5, 5, 5, 4).permute(0, 4, 1, 2, 3)
    elif case == "w_strided":
        w = torch.zeros(4, 1, 3, 3, 6)[..., ::2]
    elif case == "meta_device":
        x, w = x.to("meta"), w.to("meta")
    with pytest.raises(ValueError):
        dw_conv3(x, w, bias)


# -- MedNeXt's layers ---------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(kernel=3, shape=(2, 5, 6, 7, 4)),                       # stride 1: the kernel
    dict(kernel=5, shape=(1, 6, 5, 4, 3)),
    dict(kernel=3, stride=2, shape=(2, 6, 7, 5, 4)),             # odd axes: ceil(n/2)
    dict(kernel=5, stride=2, shape=(1, 8, 6, 4, 3)),
    dict(kernel=3, transpose2=True, shape=(2, 3, 4, 5, 4)),
    dict(kernel=5, transpose2=True, shape=(1, 2, 3, 4, 3)),
    dict(kernel=3, pad=((2, 1),) * 3, shape=(1, 5, 7, 4, 4)),    # the up block's pad
    dict(kernel=3, pad=((1, 1),) * 3, shape=(1, 5, 7, 4, 4)),    # symmetric: the kernel
    dict(kernel=3, pad=((0, 2), (1, 0), (2, 2)), shape=(1, 5, 7, 4, 4)),
])
def test_depthwise_conv_matches_flax(case):
    case = dict(case)
    shape = case.pop("shape")
    C = shape[-1]
    got, ref = _port(jl.DepthwiseConv3D(C, **case), tl.DepthwiseConv3D(C, **case),
                     _arr(7, shape))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("stride,shape", [(1, (2, 3, 4, 5, 6)), (2, (2, 4, 6, 8, 6)),
                                          (2, (1, 5, 3, 7, 6))])
def test_pointwise_conv_matches_flax(stride, shape):
    got, ref = _port(jl.PointwiseConv(10, stride=stride),
                     tl.PointwiseConv(shape[-1], 10, stride=stride), _arr(8, shape))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_pointwise_transpose2_matches_flax():
    got, ref = _port(jl.PointwiseTranspose2(5), tl.PointwiseTranspose2(6, 5),
                     _arr(9, (2, 3, 4, 2, 6)))
    assert got.shape == ref.shape == (2, 6, 8, 4, 5)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_instance_norm_matches_flax():
    x = 3.0 + 2.0 * _arr(10, (2, 5, 6, 7, 4))
    got, ref = _port(jl.InstanceNorm(affine=True), tl.InstanceNorm(4), x)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("faithful_up,calls", [(False, 18), (True, 22)])
def test_every_stride1_same_depthwise_conv_goes_through_the_kernel(
        monkeypatch, faithful_up, calls):
    """18 same-mode blocks, plus the 4 faithful up blocks' symmetric-pad
    convs on the dilated input, call dw_conv3; no other path does."""
    seen = []

    def counting(x, w, bias=None):
        seen.append(tuple(x.shape))
        return dw_conv3(x, w, bias)

    monkeypatch.setattr(tl, "dw_conv3", counting)
    model = tm.MedNeXt(num_classes=8, n_channels=8, faithful_up=faithful_up)
    with torch.no_grad():
        model(torch.from_numpy(_arr(17, (1, 2, 16, 16, 16))))
    assert len(seen) == calls


def test_zero_dilate_matches_jax():
    x = _arr(11, (1, 3, 2, 4, 3))
    np.testing.assert_array_equal(_cl(tl.zero_dilate(_cf(x))),
                                  np.asarray(jl.zero_dilate(jnp.asarray(x))))


@pytest.mark.parametrize("mode,faithful_up,c_in,c_out", [
    ("same", False, 6, 6), ("down", False, 6, 12), ("up", False, 12, 6),
    ("up", True, 12, 6),
])
def test_mednext_block_matches_flax(mode, faithful_up, c_in, c_out):
    fm = jm.MedNeXtBlock(c_out, exp_r=2, kernel=3, mode=mode, faithful_up=faithful_up)
    tmod = tm.MedNeXtBlock(c_in, c_out, exp_r=2, kernel=3, mode=mode,
                           faithful_up=faithful_up)
    got, ref = _port(fm, tmod, _arr(12, (2, 4, 6, 4, c_in)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


# -- the whole model ------------------------------------------------------------

@pytest.fixture(scope="module")
def mednext_tree():
    """Random weights of an 8-channel MedNeXt-S with deep supervision,
    shared by the model tests."""
    model = jm.MedNeXt(num_classes=8, n_channels=8, deep_supervision=True)
    return _params(model, jnp.zeros((1, 2, 16, 16, 16)), 2)


def _without_ds(tree):
    return {k: v for k, v in tree.items() if not k.startswith("ds")}


def _small_pair(tree, deep_supervision):
    """(jitted JAX apply, the port's model) on the same weights."""
    jmodel = jm.MedNeXt(num_classes=8, n_channels=8, deep_supervision=deep_supervision)
    params = tree if deep_supervision else _without_ds(tree)
    tmodel = tm.MedNeXt(num_classes=8, n_channels=8, deep_supervision=deep_supervision)
    tmodel.load_state_dict(state_dict_from_flax(params, tmodel))
    return jax.jit(lambda v: jmodel.apply({"params": params}, v)), tmodel


def test_converter_fills_mednext_with_deep_supervision(mednext_tree):
    model = tm.MedNeXt(num_classes=8, n_channels=8, deep_supervision=True)
    sd = state_dict_from_flax(mednext_tree, model)
    leaves = flatten_dict(mednext_tree)
    assert len(sd) == len(leaves) == len(dict(model.named_parameters()))
    assert (sum(int(np.prod(a.shape)) for a in leaves.values())
            == sum(p.numel() for p in model.parameters()))
    model.load_state_dict(sd)  # strict: nothing missing, nothing unexpected
    with pytest.raises(KeyError):
        state_dict_from_flax(_without_ds(mednext_tree), model)


@pytest.mark.parametrize("deep_supervision", [False, True])
def test_mednext_matches_jax(mednext_tree, deep_supervision):
    apply, tmodel = _small_pair(mednext_tree, deep_supervision)
    x = _arr(13, (1, 2, 16, 16, 16))
    ref = apply(jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    if deep_supervision:
        assert len(got) == len(ref) == 5
    else:
        got, ref = [got], [ref]
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_mednext_sliding_window_matches_jax(mednext_tree):
    apply, tmodel = _small_pair(mednext_tree, False)
    vol = _arr(14, (1, 2, 24, 24, 24))
    kw = dict(num_classes=8, overlap=0.5, sw_batch_size=1, blend="gaussian")
    ref = np.asarray(jsw.sliding_window_inference(jnp.asarray(vol), (16,) * 3, apply,
                                                  tta_batched=False, **kw))
    got = tsw.sliding_window_inference(torch.from_numpy(vol), (16,) * 3, tmodel, **kw)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_serve_mednext_equals_sliding_window_argmax(tmp_path):
    """Full-width MedNeXt-S with deep supervision on a small volume."""
    kwargs = dict(deep_supervision=True)
    model = treg.build("mednext", device="cpu", num_classes=8,
                       generator=torch.Generator().manual_seed(5), **kwargs)
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    watch, out = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    vol = _arr(15, (2, 20, 24, 18))
    np.save(watch / "case.npy", vol)
    os.utime(watch / "case.npy", (time.time() - 5,) * 2)
    before = dict(LAUNCHES)
    served = serve.main(["--model", "mednext", "--weights", str(weights),
                         "--model-kwargs", json.dumps(kwargs), "--device", "cpu",
                         "--watch", str(watch), "--out", str(out), "--roi", "16",
                         "--sw-batch-size", "2", "--max-requests", "1", "--poll", "0.05"])
    assert len(served) == 1 and LAUNCHES == before
    # deep supervision: serve takes the full-resolution output
    logits = tsw.sliding_window_inference(torch.from_numpy(vol[None]), (16,) * 3,
                                          lambda t: model(t)[0], num_classes=8,
                                          sw_batch_size=2)
    seg = read_nifti(str(out / "case_seg.nii.gz"))
    assert seg.dtype == np.uint8 and seg.shape == vol.shape[1:]
    np.testing.assert_array_equal(seg, logits.argmax(dim=1)[0].numpy())
    done = json.loads((out / "case.done").read_text())
    assert done["launches"] == {k: 0 for k in LAUNCHES}


@pytest.mark.slow
def test_mednext_s_full_width_matches_jax():
    """registry "mednext" (MedNeXt-S k3, 32 channels) at 1x2x32³."""
    jmodel = jreg.build("mednext")
    x = _arr(16, (1, 2, 32, 32, 32))
    params = _params(jmodel, jnp.asarray(x), 3)
    tmodel = treg.build("mednext", device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(params, tmodel))
    ref = np.asarray(jax.jit(lambda v: jmodel.apply({"params": params}, v))(jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)
