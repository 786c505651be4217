"""The zoo's first five registry models on the CPU against the JAX package:
`unet3d`, `nnformer` (and its deep-supervision pyramid), `nnformer_singlemodal`,
`swinunet3d` (and its faithful window scramble) and `swinunet3d_pure`, at
`tests/test_model_zoo.py`'s small configs, f32, eval mode, on numpy-seeded
weights and inputs.

Tolerance: 1e-5 of the largest logit (f32 sums in another order). The
nnFormer cases clamp windows (1³ grids at 32³ with windows 2; the published
windows 4-4-8-4 clamp at the two deepest stages), so their bias tables take
the clamped windows' shapes, as the JAX model's do, and an input that
clamps otherwise is refused.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.models.layers import DepthwiseConv3D  # noqa: E402

from torch_port_oracle import flax_params  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SWIN = dict(hidden_dim=24, head_dim=8, window_size=2)
NNF = dict(embed_dim=24, window_sizes=(2, 2, 2, 2))
# (registry name, kwargs of both, kwargs of the port alone, input shape)
ZOO = {
    "unet3d": ("unet3d", {}, {}, (1, 2, 32, 32, 32)),
    "nnformer_pyramid": ("nnformer", dict(NNF, deep_supervision=True),
                         dict(input_size=32), (1, 2, 32, 32, 32)),
    "nnformer_singlemodal_published_windows": (
        "nnformer_singlemodal", dict(embed_dim=24), dict(input_size=(32, 32, 32)),
        (1, 1, 32, 32, 32)),
    "swinunet3d": ("swinunet3d", SWIN, {}, (1, 2, 32, 32, 32)),
    "swinunet3d_scramble": ("swinunet3d", dict(SWIN, faithful_scramble=True), {},
                            (1, 2, 32, 32, 32)),
    "swinunet3d_pure": ("swinunet3d_pure", SWIN, {}, (1, 2, 32, 32, 32)),
}


def port_model(name, kw, tkw, params):
    model = treg.build(name, device="cpu", **kw, **tkw)
    model.load_state_dict(state_dict_from_flax(params, model))
    return model


@pytest.mark.parametrize("case", list(ZOO))
def test_zoo_forward_equals_jax(case):
    name, kw, tkw, shape = ZOO[case]
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jm = jreg.build(name, **kw)
    params = flax_params(jm, x)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    model = port_model(name, kw, dict(tkw, in_channels=shape[1]), params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    if kw.get("deep_supervision"):
        assert len(got) == len(want) == 3
        assert [g.shape[2] for g in got] == [32, 16, 8]      # highest resolution first
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_bias_tables_take_the_clamped_windows():
    """nnFormer's published windows 4-4-8-4 at a 32³ patch (stages at 8³,
    4³, 2³, 1³): the deepest two clamp to 2³ and 1³; built for 128³ (None)
    they keep 8³ and 4³."""
    rows = {w: (2 * w - 1) ** 3 for w in (1, 2, 4, 8)}
    at32 = treg.build("nnformer", device="cpu", embed_dim=12, input_size=32)
    at128 = treg.build("nnformer", device="cpu", embed_dim=12)
    assert [at32.get_submodule(f"enc{i}_b0.attn").rel_pos_bias_table.shape[0]
            for i in range(4)] == [rows[4], rows[4], rows[2], rows[1]]
    assert [at128.get_submodule(f"enc{i}_b0.attn").rel_pos_bias_table.shape[0]
            for i in range(4)] == [rows[4], rows[4], rows[8], rows[4]]
    assert at32.dec0_kv.rel_pos_bias_table.shape[0] == rows[2]


@pytest.mark.parametrize("built,size", [(32, 16), (None, 32)], ids=["smaller", "unbuilt"])
def test_nnformer_refuses_an_input_its_tables_are_not_for(built, size):
    """An input that clamps the windows otherwise than the one the model was
    built for raises (the JAX model fails there on the tables' shapes)."""
    model = treg.build("nnformer", device="cpu", embed_dim=12, input_size=built)
    with torch.no_grad(), pytest.raises(ValueError, match="bias table is for window"):
        model(torch.zeros(1, 2, size, size, size))


def test_registry_marks_the_models_built_for_an_input():
    """The models whose parameter shapes follow their input register
    `input_size` (cli/train fills it in with the patch); no other does."""
    names = ("micformer", "mednext", "generic_unet", "unet3d", "nnformer",
             "nnformer_singlemodal", "swinunet3d", "swinunet3d_pure")
    assert {n for n in names if "input_size" in treg.defaults(n)} == {
        "nnformer", "nnformer_singlemodal"}


@pytest.mark.parametrize("name,convs", [("swinunet3d", 14), ("swinunet3d_pure", 0)])
def test_swinunet3d_gates_with_depthwise_convs(name, convs):
    """Seven stages, two depthwise k3 convs each (K3 on the card); the pure
    sibling has no conv path."""
    model = treg.build(name, device="cpu", **SWIN)
    dws = [m for m in model.modules() if isinstance(m, DepthwiseConv3D)]
    assert len(dws) == convs
    assert all(m.groups == m.in_channels == m.out_channels and m.kernel_size == (3,) * 3
               and m.stride == (1,) * 3 for m in dws)
