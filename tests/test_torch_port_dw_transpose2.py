"""MedNeXt's stride-2 transposed depthwise conv and its gradient
(`kernels/dw_transpose2.py`): on the CPU the plain weight gradient against
torch's autograd of `F.conv_transpose3d`, the layer's gradients through the
autograd Function against the plain autograd path, the forward without a
gradient, the export graph, and the wrapper's checks; on the card the
weight-gradient kernel (`csrc/dw_transpose2_wgrad.cu`) against the plain
version and cuDNN's own wgrad at MedNeXt-S's b2 shapes.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_dw_transpose2.py

Without a card the tests marked `cuda` skip.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from micformer_tpu_torch import registry
from micformer_tpu_torch.convert import aot_export
from micformer_tpu_torch.kernels import LAUNCHES
from micformer_tpu_torch.kernels import dw_transpose2 as dwt2
from micformer_tpu_torch.models import layers as tl

# ([B, C, L_D, L_H, L_W], k): unequal extents, L = 1 on an axis, both k
CPU_CASES = [((2, 3, 1, 4, 3), 3), ((2, 2, 5, 2, 6), 3), ((2, 3, 3, 1, 4), 5),
             ((2, 2, 2, 5, 3), 5)]


def _plain(x, w, b):
    """The layer's plain path: the transposed conv on the flipped weight,
    cut to 2L per axis."""
    D, H, W = x.shape[2:]
    y = F.conv_transpose3d(x, w.flip((2, 3, 4)), b, stride=2, padding=w.shape[-1] // 2 - 1,
                           groups=x.shape[1])
    return y[:, :, :2 * D, :2 * H, :2 * W]


def _arrays(shape, k, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed + sum(shape) + k)
    B, C, D, H, W = shape
    x = rng.normal(size=shape)
    w = rng.normal(size=(C, 1, k, k, k)) / k ** 1.5
    b = rng.normal(size=C)
    g = rng.normal(size=(B, C, 2 * D, 2 * H, 2 * W))
    return tuple(torch.from_numpy(a).to(dtype) for a in (x, w, b, g))


@pytest.mark.parametrize("shape,k", CPU_CASES)
def test_wgrad_reference_matches_autograd_of_conv_transpose(shape, k):
    """dw and db of the plain version against torch's autograd of the
    plain path in f64 (1e-12); on bf16 inputs, summed in f32, against the
    f64 gradient of the same rounded inputs (1e-5 of the largest)."""
    x, w, b, g = _arrays(shape, k)
    wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
    _plain(x, wr, br).backward(g)
    dw, db = dwt2.dw_transpose2_wgrad_reference(x, g, k)
    assert dw.shape == (shape[1], 1, k, k, k) and dw.dtype == db.dtype == torch.float64
    torch.testing.assert_close(dw, wr.grad, rtol=0, atol=1e-12)
    torch.testing.assert_close(db, br.grad, rtol=0, atol=1e-12)

    xh, gh = x.bfloat16(), g.bfloat16()
    wr.grad = br.grad = None
    _plain(xh.double(), wr, br).backward(gh.double())
    dw, db = dwt2.dw_transpose2_wgrad(xh, gh, k)           # CPU: the plain version
    assert dw.dtype == db.dtype == torch.float32
    for got, want in ((dw, wr.grad), (db, br.grad)):
        torch.testing.assert_close(got.double(), want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("autocast", [False, True], ids=["f32", "bf16_autocast"])
@pytest.mark.parametrize("wants", ["x", "w", "b", "wb", "xwb"])
@pytest.mark.parametrize("shape,k", [CPU_CASES[1], CPU_CASES[2]])
def test_layer_gradients_through_the_function_match_plain_autograd(shape, k, wants, autocast):
    """DepthwiseConv3D(transpose2=True) with a gradient asked for runs the
    Function: its output and the gradients asked for equal the plain
    autograd path's (f32: 1e-5 of the largest; under CPU bf16 autocast,
    where both run the conv on bf16 casts and dw is rounded to bf16: 1e-2),
    the others stay None, and nothing launches on the CPU."""
    x, w, b, g = (t.float() for t in _arrays(shape, k, seed=1))
    layer = tl.DepthwiseConv3D(shape[1], k, transpose2=True)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    grads = {}
    for path in ("function", "plain"):
        xl = x.clone().requires_grad_("x" in wants)
        layer.weight.requires_grad_("w" in wants)
        layer.bias.requires_grad_("b" in wants)
        layer.zero_grad(set_to_none=True)
        before = dict(LAUNCHES)
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
            if path == "function":
                out = layer(xl)
                assert type(out.grad_fn).__name__ == "_DwTranspose2Backward"
            else:
                out = _plain(xl, layer.weight.to(xl.dtype), layer.bias.to(xl.dtype))
        assert out.dtype == (torch.bfloat16 if autocast else torch.float32)
        out.backward(g.to(out.dtype))
        assert LAUNCHES == before
        grads[path] = (out.detach().float(), xl.grad, layer.weight.grad, layer.bias.grad)
    tol = 1e-2 if autocast else 1e-5
    for name, got, want in zip(("out", "x", "w", "b"), grads["function"], grads["plain"]):
        asked = name == "out" or name in wants
        assert (got is not None) == asked and (want is not None) == asked, name
        if asked:
            assert got.dtype == want.dtype, name
            torch.testing.assert_close(got, want, rtol=0, atol=tol * want.abs().max().item(),
                                       msg=name)


def test_forward_without_gradient_never_enters_the_function(monkeypatch):
    """Serving's forward (no_grad), and a forward where nothing requires a
    gradient, run the plain call: the Function is never applied."""
    def refuse(*args):
        raise AssertionError("the Function was entered")

    monkeypatch.setattr(dwt2._DwTranspose2, "apply", refuse)
    x, w, b, _ = (t.float() for t in _arrays(*CPU_CASES[1]))
    layer = tl.DepthwiseConv3D(x.shape[1], 3, transpose2=True)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
        want = _plain(x, w, b)
        torch.testing.assert_close(layer(x), want, rtol=0, atol=0)
    layer.requires_grad_(False)
    out = layer(x)
    assert out.grad_fn is None
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_mednext_export_graph_holds_no_new_node(monkeypatch):
    """A MedNeXt export runs under no_grad, so its graph holds the four up
    blocks' transposed convs as aten nodes and nothing of the Function
    (whose entry is made to raise here)."""
    monkeypatch.setattr(tl, "dw_transpose2", lambda *a: pytest.fail("entered dw_transpose2"))
    model = registry.build("mednext", device="cpu", num_classes=8, n_channels=4,
                           generator=torch.Generator().manual_seed(3))
    program = aot_export._export_program(model, torch.zeros(1, 2, 16, 16, 16))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("aten.conv_transpose3d.input") == 4
    assert all(t.startswith("aten.") or t == "micformer_tpu_torch.dw_conv3.default"
               for t in targets)
    assert aot_export.op_nodes(program)["dw_conv3"] == 18


def test_wgrad_wrapper_checks_its_inputs():
    x, g = torch.zeros(1, 2, 3, 4, 4), torch.zeros(1, 2, 6, 8, 8)
    for bad in (dict(g=torch.zeros(1, 2, 6, 8, 7)), dict(g=g.bfloat16()),
                dict(g=g.transpose(3, 4).contiguous().transpose(3, 4)),
                dict(x=x.transpose(3, 4).contiguous().transpose(3, 4)), dict(k=4),
                dict(x=x.half(), g=g.half()), dict(x=x[0])):
        args = dict(dict(x=x, g=g, k=3), **bad)
        with pytest.raises(ValueError):
            dwt2.dw_transpose2_wgrad(args["x"], args["g"], args["k"])
    with pytest.raises(ValueError):
        dwt2.dw_transpose2(x, torch.zeros(2, 1, 4, 4, 4))


@pytest.mark.parametrize("shape,ptrs,route", [
    ((2, 64, 64, 64, 64), (0, 4096), "vector"),
    ((2, 512, 8, 8, 8), (16, 32), "vector"),
    ((2, 3, 5, 6, 6), (0, 0), "scalar"),           # L_W not a multiple of 4
    ((2, 3, 5, 6, 8), (0, 2), "scalar"),           # g off 16-byte alignment
])
def test_route_follows_shape_and_alignment(shape, ptrs, route):
    assert dwt2._dwt2_route(shape, *ptrs) == route


# -- on the card ------------------------------------------------------------------

# MedNeXt-S's up blocks in a b2 training step at roi 128 (input x), then
# ragged shapes: odd extents (the scalar route), k = 5, L = 1 on an axis
CARD_SHAPES = [((2, 512, 8, 8, 8), 3), ((2, 256, 16, 16, 16), 3), ((2, 128, 32, 32, 32), 3),
               ((2, 64, 64, 64, 64), 3), ((2, 5, 7, 9, 11), 3), ((1, 6, 5, 3, 8), 5),
               ((2, 4, 1, 6, 13), 5)]
# the kernel and the plain version both sum exact products in f32 (bf16
# products are exact too): 1e-4 of the largest; cuDNN's bf16 wgrad rounds
# dw to bf16 (1e-2), its f32 wgrad sums in another order (1e-4)
CUDNN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.device("cuda")


def _cudnn_wgrad(x, g, k):
    """cuDNN's own dw (of the module's weight) and db for the same conv."""
    D, H, W = x.shape[2:]
    gp = g.new_zeros(g.shape[:2] + (2 * D + 1, 2 * H + 1, 2 * W + 1))
    gp[:, :, :2 * D, :2 * H, :2 * W] = g
    wf = torch.zeros((x.shape[1], 1, k, k, k), dtype=x.dtype, device=x.device)
    _, dw, db = torch.ops.aten.convolution_backward(
        gp, x, wf, [x.shape[1]], [2] * 3, [k // 2 - 1] * 3, [1] * 3, True, [0] * 3,
        x.shape[1], [False, True, True])
    return dw.flip((2, 3, 4)), db


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", CARD_SHAPES)
def test_wgrad_kernel_matches_plain_and_cudnn_on_card(cuda_device, shape, k):
    """dw and db of the kernel against the plain version and cuDNN's
    wgrad, f32 and bf16, one launch each on the route `_dwt2_route` picks;
    the same dw, bit for bit, in a second run; the other route forced where
    the inputs allow it gives the same sums."""
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dt in (torch.float32, torch.bfloat16):
            x, _, _, g = (t.to(cuda_device, dt) for t in _arrays(shape, k, dtype=torch.float32))
            before = dict(LAUNCHES)
            dw, db = dwt2.dw_transpose2_wgrad(x, g, k)
            torch.cuda.synchronize()
            assert LAUNCHES["dw_transpose2_wgrad"] == before["dw_transpose2_wgrad"] + 1
            assert dw.dtype == db.dtype == torch.float32
            for got, want in zip((dw, db), dwt2.dw_transpose2_wgrad_reference(x, g, k)):
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=1e-4 * want.abs().max().item(), msg=str(dt))
            for got, want in zip((dw, db), _cudnn_wgrad(x, g, k)):
                torch.testing.assert_close(got, want.float(), rtol=0,
                                           atol=CUDNN_TOL[dt] * want.abs().max().item(),
                                           msg=f"cudnn {dt}")
            again = dwt2.dw_transpose2_wgrad(x, g, k)
            assert torch.equal(again[0], dw) and torch.equal(again[1], db)
            if dwt2._dwt2_route(x.shape, x.data_ptr(), g.data_ptr()) == "vector":
                scalar = dwt2._wgrad(x, g, k, route="scalar")
                for got, want in zip(scalar, (dw, db)):
                    torch.testing.assert_close(got, want, rtol=1e-6,
                                               atol=1e-6 * want.abs().max().item())
            else:
                with pytest.raises(RuntimeError):
                    dwt2._wgrad(x, g, k, route="vector")
    finally:
        torch.backends.cudnn.allow_tf32 = allow


@pytest.mark.cuda
def test_layer_trains_through_the_kernel_on_card(cuda_device):
    """DepthwiseConv3D(transpose2=True) under bf16 autocast on the card:
    one kernel launch a backward, on the vector route, gradients close to
    the plain autograd path's (f32 parameters, bf16 rounding: 1e-2)."""
    x, w, b, g = (t.to(cuda_device, torch.float32)
                  for t in _arrays((2, 16, 8, 8, 8), 3, seed=2))
    layer = tl.DepthwiseConv3D(16, 3, transpose2=True).to(cuda_device)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    grads = {}
    for path in ("function", "plain"):
        layer.zero_grad(set_to_none=True)
        xl = x.bfloat16().requires_grad_()
        before, routes = dict(LAUNCHES), dict(dwt2.ROUTES)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = (layer(xl) if path == "function" else
                   _plain(xl, layer.weight.to(xl.dtype), layer.bias.to(xl.dtype)))
        out.backward(g.bfloat16())
        torch.cuda.synchronize()
        launched = LAUNCHES["dw_transpose2_wgrad"] - before["dw_transpose2_wgrad"]
        assert launched == (1 if path == "function" else 0)
        if path == "function":
            assert dwt2.ROUTES["vector"] == routes["vector"] + 1
        grads[path] = (out.detach().float(), xl.grad.float(), layer.weight.grad,
                       layer.bias.grad)
    for name, got, want in zip(("out", "x", "w", "b"), grads["function"], grads["plain"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-2 * want.abs().max().item(),
                                   msg=name)
