"""The zoo's window machinery on the CPU against the JAX package.

`ops/windows.py` (shifted-window region ids, the relative-position index,
the cyclic shift) exactly, over shifted and unshifted grids, padded and
clamped windows; `multi_head_attention` with a relative-position bias, a
full mask, region ids and both, at T 8, 64 and 512 and Tq != Tk, within
1e-6 of JAX's (f32 sums in another order) and within the f32 rounding
bound of an f64 run (`torch_port_attn_ref`), and its gradients against
jax.grad within 1e-5 of each gradient's largest entry; which path each call
takes; the relative-position gather and its refusal of a window its table
was not built for; `ConvNormAct` (flax's "SAME" conv and transposed conv at
k3 s2, on even and odd extents) and `PReLU`, and the shifted, biased
`SwinBlock3D` (and SwinUnet3D's scramble), within 1e-5 of the largest
output (f32 sums in another order).
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu.models import layers as jl  # noqa: E402
from micformer_tpu.ops import attention as jattn  # noqa: E402
from micformer_tpu.ops import windows as jw  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.kernels import ATTENTION_PATHS, reset_launches  # noqa: E402
from micformer_tpu_torch.models import layers as tl  # noqa: E402
from micformer_tpu_torch.ops import attention as tattn  # noqa: E402
from micformer_tpu_torch.ops import windows as tw  # noqa: E402

from torch_port_attn_ref import chain_f64, f32_bound  # noqa: E402
from torch_port_oracle import flax_params  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (dims, configured window, configured shift): shifted and unshifted, a grid
# the window does not divide (padded), axes no longer than the window
# (clamped, their shift zeroed)
GRIDS = [((8, 8, 8), (4, 4, 4), (2, 2, 2)), ((8, 8, 8), (4, 4, 4), (0, 0, 0)),
         ((6, 10, 8), (4, 4, 4), (2, 2, 2)), ((4, 8, 2), (4, 4, 4), (2, 2, 2)),
         ((8, 4, 12), (2, 4, 4), (1, 2, 2))]


def _prepared(dims, window, shift):
    """(padded dims, clamped window, clamped shift), as SwinBlock3D has them."""
    ws, ss = jw.adjust_window_shift(dims, window, shift)
    return tuple(d + (-d) % w for d, w in zip(dims, ws)), ws, ss


@pytest.mark.parametrize("dims,window,shift", GRIDS)
def test_masks_and_region_ids_equal_jax(dims, window, shift):
    """The region ids, the compact form of the shifted-window mask (its 0 /
    -100 pairs are built in the attention), against both of JAX's forms."""
    dims, ws, ss = _prepared(dims, window, shift)
    want, got = jw.shifted_window_region_ids(dims, ws, ss), tw.shifted_window_region_ids(
        dims, ws, ss)
    if want is None:
        assert got is None and jw.shifted_window_mask(dims, ws, ss) is None
        return
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    pairs = np.where(got[:, None, :] != got[:, :, None], -100.0, 0.0).astype(np.float32)
    np.testing.assert_array_equal(pairs, jw.shifted_window_mask(dims, ws, ss))


@pytest.mark.parametrize("window", [(2, 2, 2), (4, 4, 4), (8, 8, 8), (2, 4, 8), (1, 1, 1)])
def test_relative_position_index_equals_jax(window):
    want, got = jw.relative_position_index(window), tw.relative_position_index(window)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dims,window,shift", GRIDS)
@pytest.mark.parametrize("reverse", [False, True])
def test_cyclic_shift_equals_jax(dims, window, shift, reverse):
    dims, ws, ss = _prepared(dims, window, shift)
    x = np.random.default_rng(0).normal(size=(2,) + dims + (3,)).astype(np.float32)
    want = np.asarray(jw.cyclic_shift(jnp.asarray(x), ss, reverse=reverse))
    np.testing.assert_array_equal(tw.cyclic_shift(torch.from_numpy(x), ss, reverse=reverse)
                                  .numpy(), want)


# ---- attention -------------------------------------------------------------

def _attn_inputs(N, Tq, Tk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(N, t, h, d)).astype(np.float32) for t in (Tq, Tk, Tk))
    bias = rng.normal(size=(h, Tq, Tk)).astype(np.float32)
    return q, k, v, bias


def _mask(kind, nW, Tq, Tk, seed=1):
    """A full [nW, Tq, Tk] 0 / -100 mask, or [nW, T] region ids."""
    rng = np.random.default_rng(seed)
    if kind == "ids":
        return rng.integers(0, 3, (nW, Tq)).astype(np.int32)
    return np.where(rng.random((nW, Tq, Tk)) < 0.3, -100.0, 0.0).astype(np.float32)


CASES = [  # (N, Tq, Tk, h, d, bias, mask kind, nW)
    (12, 8, 8, 3, 8, True, None, None),
    (12, 8, 8, 3, 8, False, "full", 4),
    (8, 64, 64, 2, 16, True, "ids", 4),
    (8, 64, 64, 2, 16, False, "ids", 2),
    (8, 64, 64, 2, 16, True, "full", 8),
    (2, 512, 512, 2, 8, True, None, None),
    (2, 512, 512, 2, 8, True, "ids", 1),
    (6, 8, 64, 2, 8, True, "full", 3),
    (6, 64, 8, 2, 8, True, None, None),
]


def _run_both(case, seed=0):
    N, Tq, Tk, h, d, use_bias, kind, nW = case
    q, k, v, bias = _attn_inputs(N, Tq, Tk, h, d, seed)
    bias = bias if use_bias else None
    mask = None if kind is None else _mask(kind, nW, Tq, Tk)
    return q, k, v, bias, mask


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"N{c[0]}-T{c[1]}x{c[2]}-"
                         f"{'bias' if c[5] else 'nobias'}-{c[6]}")
def test_multi_head_attention_equals_jax(case):
    q, k, v, bias, mask = _run_both(case)
    want = np.asarray(jattn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias),
        mask=None if mask is None else jnp.asarray(mask)))
    got = tattn.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=None if bias is None else torch.from_numpy(bias),
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[6]],
                         ids=["T8-bias", "T64-bias-ids", "T512-bias-ids"])
def test_attention_chain_within_f32_rounding_of_f64(case):
    """Every output element of the chain lies within the forward error
    bound of an f32 evaluation from the f64 result (the bound the card test
    holds the card's chain to)."""
    q, k, v, bias, mask = (None if a is None else torch.from_numpy(a)
                           for a in _run_both(case))
    got = tattn.multi_head_attention(q, k, v, bias=bias, mask=mask)
    err = (got.double() - chain_f64(q, k, v, bias, mask)[0]).abs()
    bound = f32_bound(q, k, v, bias, mask)
    assert (err <= bound).all(), f"{(err / bound).max().item():.3g} of the bound"


@pytest.mark.parametrize("case", [CASES[2], CASES[6], CASES[7]],
                         ids=["T64-bias-ids", "T512-bias-ids", "T8x64-bias-full"])
def test_attention_gradients_equal_jax_grad(case):
    q, k, v, bias, mask = _run_both(case)
    w = np.random.default_rng(5).normal(size=q.shape[:3] + (v.shape[3],)).astype(np.float32)

    def jloss(q_, k_, v_, b_):
        out = jattn.multi_head_attention(q_, k_, v_, bias=b_, mask=jnp.asarray(mask))
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    out = tattn.multi_head_attention(*ts[:3], bias=ts[3], mask=torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


def test_attention_paths_are_counted():
    """CPU tensors: unbiased, unmasked, T <= 16 is K1's regime (its plain
    version here); a bias, a mask or T > 16 takes the plain chain."""
    reset_launches()
    for case, path in [(CASES[0], "matmul"), (CASES[1], "matmul"), (CASES[5], "matmul")]:
        q, k, v, bias, mask = _run_both(case)
        tattn.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   bias=None if bias is None else torch.from_numpy(bias),
                                   mask=None if mask is None else torch.from_numpy(mask))
    q, k, v, _ = _attn_inputs(12, 8, 8, 3, 8)
    for fused in (False, True):
        tattn.multi_head_attention(*map(torch.from_numpy, (q, k, v)), fused=fused)
    q, k, v, _ = _attn_inputs(4, 64, 64, 2, 8)
    tattn.multi_head_attention(*map(torch.from_numpy, (q, k, v)))
    assert ATTENTION_PATHS == {"k1": 2, "k2": 0, "bwa": 0, "matmul": 4}


@pytest.mark.parametrize("window", [(4, 4, 4), (2, 4, 4), (1, 2, 2), (8, 8, 8)])
def test_rel_pos_gather_is_the_window_index(window):
    """A table built for `window` gathers at relative_position_index(window),
    JAX's `rel_pos_bias_cached` gather of the same table (its [:T, :T] slice
    takes the whole index, T being the window's token count)."""
    att = tl.WindowAttention3D(16, 2, window_size=window, rel_pos_bias=True)
    rows, T = att.rel_pos_bias_table.shape[0], int(np.prod(window))
    table = np.random.default_rng(0).normal(size=(rows, 2)).astype(np.float32)
    att.rel_pos_bias_table.data = torch.from_numpy(table)
    idx = jw.relative_position_index(window)[:T, :T]
    want = table[idx.reshape(-1)].reshape(T, T, 2).transpose(2, 0, 1)
    np.testing.assert_array_equal(tl.rel_pos_bias(att, window).detach().numpy(), want)


@pytest.mark.parametrize("built,dims", [((8, 8, 8), (8, 2, 8)), (None, (2, 4, 4)),
                                        ((2, 2, 2), (8, 8, 8)), ((8, 2, 8), (2, 8, 8))],
                         ids=["clamps-below", "unbuilt-clamps", "built-clamped", "transposed"])
def test_rel_pos_bias_refuses_a_window_its_table_is_not_for(built, dims):
    """A block whose input clamps the window otherwise than the input its
    table was built for raises, where the JAX block fails on the table's
    shape (or would gather another window's geometry)."""
    blk = tl.SwinBlock3D(16, 2, (4, 4, 4), rel_pos_bias=True, input_size=built).eval()
    with pytest.raises(ValueError, match="bias table is for window"):
        blk(torch.zeros((1,) + dims + (16,)))


# ---- conv blocks --------------------------------------------------------------

@pytest.mark.parametrize("stride,transpose", [(1, False), (2, False), (2, True), (1, True)])
@pytest.mark.parametrize("dims", [(6, 8, 10), (5, 7, 9), (1, 3, 4)])
def test_conv_norm_act_equals_jax(stride, transpose, dims):
    """UNet3D's unit (instance norm, PReLU): flax's "SAME" padding, even and
    odd extents (uneven pads at stride 2) and an extent of 1, the transposed
    conv's at k3 s2 included (output n·s, flax's (2, 1) padding of the
    dilated input)."""
    x = np.random.default_rng(0).normal(size=(2,) + dims + (3,)).astype(np.float32)
    jm = jl.ConvNormAct(5, kernel=3, stride=stride, transpose=transpose)
    params = flax_params(jm, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tl.ConvNormAct(3, 5, kernel=3, stride=stride, transpose=transpose)
    tm.load_state_dict(state_dict_from_flax(params, tm))
    got = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---- the Swin block -------------------------------------------------------------

SCRAMBLE = dict(qkv_bias=False, head_dim=8, swinunet_scramble=True)


@pytest.mark.parametrize("dims,window,shift,kw", [
    ((8, 8, 8), (4, 4, 4), (2, 2, 2), dict(rel_pos_bias=True)),  # shifted, a 2³ grid
    ((6, 10, 8), (4, 4, 4), (2, 2, 2), dict(rel_pos_bias=True)),  # padded
    ((8, 2, 8), (4, 4, 4), (2, 2, 2), dict(rel_pos_bias=True)),   # H clamped, unshifted
    ((8, 8, 8), (4, 4, 4), (2, 2, 2), dict(rel_pos_bias=True, head_dim=4)),
    ((8, 8, 8), (2, 2, 2), (1, 1, 1), SCRAMBLE),                  # the scramble, a 4³ grid
], ids=["shifted", "padded", "clamped", "head_dim", "scramble"])
def test_swin_block_equals_jax(dims, window, shift, kw):
    """Pre-norm block with a relative-position bias (a head_dim other than
    dim / heads; and no qkv bias under the scramble, as SwinUnet3D has it)."""
    x = np.random.default_rng(0).normal(size=(2,) + dims + (16,)).astype(np.float32)
    jm = jl.SwinBlock3D(16, 2, window, shift, **kw)
    params = flax_params(jm, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tl.SwinBlock3D(16, 2, window, shift_size=shift, input_size=dims, **kw).eval()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_swin_block_drop_path_draws_from_the_generator():
    """DropPath draws from the caller's generator in train mode: the same
    seed gives the same output, another seed another; eval mode is the
    deterministic block."""
    blk = tl.SwinBlock3D(16, 2, (2, 2, 2), drop_path=0.5)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 4, 4, 4, 16))
                         .astype(np.float32))
    blk.train()
    a, b, c = (blk(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    blk.eval()
    ref = blk(x)
    assert not torch.equal(a, ref) and torch.equal(ref, blk(x, torch.Generator()))
