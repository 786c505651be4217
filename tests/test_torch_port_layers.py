"""The port's layers and weight converter against the JAX package on the CPU.

Each flax module is initialised in JAX, its parameters go through
`convert.from_flax`, and both sides run the same numpy inputs in f32 and
eval mode. The JAX package's MICFORMER_* flags are cleared before it is
imported, so it runs its default forms.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from micformer_tpu.models import layers as jl  # noqa: E402
from micformer_tpu.models import micformer as jm  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.models import layers as tl  # noqa: E402
from micformer_tpu_torch.models import micformer as tm  # noqa: E402

ATOL = 1e-5


def _arr(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(flax_mod, torch_mod, *inputs):
    """Init flax_mod on inputs, load its weights into torch_mod, return both
    outputs as numpy."""
    jin = [jnp.asarray(a) for a in inputs]
    variables = jax.jit(flax_mod.init)(jax.random.key(0), *jin)
    params = jax.tree.map(np.asarray, variables["params"])
    torch_mod.load_state_dict(state_dict_from_flax(params, torch_mod))
    torch_mod.eval()
    ref = np.asarray(flax_mod.apply(variables, *jin))
    with torch.no_grad():
        got = torch_mod(*[torch.from_numpy(a) for a in inputs]).numpy()
    return got, ref


@pytest.fixture(scope="module")
def micformer_tree():
    """One JAX init of a 2-stage MicFormer, shared by the converter tests."""
    model = jm.MicFormer(num_classes=8, embed_dim=12, depths=(1, 1),
                         num_heads=(3, 6))
    x = jnp.zeros((1, 2, 16, 16, 16), jnp.float32)
    variables = jax.jit(model.init)(jax.random.key(0), x)
    return jax.tree.map(np.asarray, variables["params"])


def test_converter_consumes_every_leaf_and_fills_every_parameter(micformer_tree):
    model = tm.MicFormer(num_classes=8, embed_dim=12, depths=(1, 1), num_heads=(3, 6))
    sd = state_dict_from_flax(micformer_tree, model)
    leaves = flatten_dict(micformer_tree)
    assert len(sd) == len(leaves) == len(dict(model.named_parameters()))
    assert (sum(int(np.prod(a.shape)) for a in leaves.values())
            == sum(p.numel() for p in model.parameters()))
    model.load_state_dict(sd)  # strict: nothing missing, nothing unexpected


def test_converter_raises_on_unconsumed_leaf_and_unfilled_parameter(micformer_tree):
    model = tm.MicFormer(num_classes=8, embed_dim=12, depths=(1, 1), num_heads=(3, 6))
    extra = dict(micformer_tree, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        state_dict_from_flax(extra, model)
    short = {k: v for k, v in micformer_tree.items() if k != "norm2"}
    with pytest.raises(KeyError):
        state_dict_from_flax(short, model)


@pytest.mark.parametrize("cross,N", [(False, 40), (True, 40), (True, 200)])
def test_window_attention_matches_flax(cross, N):
    # N >= 128 takes the JAX lane-major projection path
    C, T, h = 12, 8, 3
    fm = jl.WindowAttention3D(C, (2, 2, 2), h, cross=cross)
    x = _arr(1, (N, T, C))
    if cross:
        got, ref = _port(fm, tl.WindowAttention3D(C, h, cross=True), x, _arr(2, (N, T, C)))
    else:
        got, ref = _port(fm, tl.WindowAttention3D(C, h), x)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 4, 6, 4, 12), (2, 3, 4, 5, 12)])
def test_swin_block_matches_flax(shape):
    # the second shape is padded up to the window and cropped back
    fm = jl.SwinBlock3D(12, 3, window_size=(2, 2, 2))
    tmod = tl.SwinBlock3D(12, 3, window_size=(2, 2, 2))
    got, ref = _port(fm, tmod, _arr(3, shape))
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 12), (2, 4, 3, 4, 12)])
def test_cross_block_matches_flax(shape):
    # 16³ takes the JAX lane-major offset tail; the second shape pads and
    # has a window-clamped axis
    fm = jm.CrossBlock3D(12, 3, window_size=(2, 2, 2))
    tmod = tm.CrossBlock3D(12, 3, window_size=(2, 2, 2))
    got, ref = _port(fm, tmod, _arr(4, shape), _arr(5, shape))
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("use_norm", [False, True])
def test_patch_embed_matches_flax(use_norm):
    fm = jl.PatchEmbed3D(12, (4, 4, 4), use_norm=use_norm)
    tmod = tl.PatchEmbed3D(1, 12, (4, 4, 4), use_norm=use_norm)
    got, ref = _port(fm, tmod, _arr(6, (2, 16, 8, 12, 1)))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_patch_merging_matches_flax():
    got, ref = _port(jl.PatchMergingConv(12), tl.PatchMergingConv(12),
                     _arr(7, (2, 4, 6, 8, 12)))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_patch_expand_matches_flax():
    got, ref = _port(jl.PatchExpandConv(24), tl.PatchExpandConv(24),
                     _arr(8, (2, 2, 3, 4, 24)))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_mlp_and_pad_to_multiple_match_jax():
    fm = jl.Mlp(48, 12)
    got, ref = _port(fm, tl.Mlp(12, 48, 12), _arr(9, (3, 5, 12)))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    x = _arr(10, (1, 3, 4, 5, 2))
    np.testing.assert_array_equal(
        tl.pad_to_multiple(torch.from_numpy(x), (2, 4, 2)).numpy(),
        np.asarray(jl.pad_to_multiple(jnp.asarray(x), (2, 4, 2))))


def test_drop_path_is_identity_in_eval_and_draws_from_generator_in_train():
    dp = tl.DropPath(0.5)
    x = torch.ones(64, 3, 2)
    assert dp.eval()(x) is x
    dp.train()
    a = dp(x, torch.Generator().manual_seed(1))
    b = dp(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a[:, 0, 0]
    assert set(kept.tolist()) <= {0.0, 2.0} and 0 < int((kept > 0).sum()) < 64
