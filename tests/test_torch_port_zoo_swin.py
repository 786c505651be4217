"""The rest of the zoo's transformers on the CPU against the JAX package:
`vtunet` (true-3D merges and the reference's `faithful_2d_merge`; the
published 7³ window, whose deeper stages clamp) and `swinunetr`, at
`tests/test_model_zoo.py`'s small configs, f32, eval mode, on numpy-seeded
weights and inputs; the sinusoidal encodings of `ops/pe.py`; VT-UNet's bias
gather at a clamped window.

Tolerance: 1e-5 of the largest logit (f32 sums in another order). The
JAX SwinUNETR runs its full- and half-resolution conv blocks W-packed under
its defaults (32³ input: 4 slots), the port the plain convs.
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
from micformer_tpu.ops import pe as jpe  # noqa: E402
from micformer_tpu.ops.windows import relative_position_index  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.models.vtunet import VTWindowAttention, vt_rel_pos_bias  # noqa: E402
from micformer_tpu_torch.ops import pe as tpe  # noqa: E402

from torch_port_oracle import flax_params  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VT = dict(embed_dim=24, window_size=(2, 2, 2))
# (registry name, kwargs of both, kwargs of the port alone, input shape)
ZOO = {
    "vtunet": ("vtunet", VT, {}, (1, 2, 32, 32, 32)),
    "vtunet_faithful_2d_merge": ("vtunet", dict(VT, faithful_2d_merge=True), {},
                                 (1, 2, 32, 32, 32)),
    # window 7³ on grids 16-8-4-2: the two deepest stages clamp to 4³ and 2³
    "vtunet_published_window": ("vtunet", dict(embed_dim=12), {}, (1, 2, 64, 64, 64)),
    "swinunetr": ("swinunetr", dict(feature_size=4, num_heads=(1, 2, 4, 8),
                                    window_size=(2, 2, 2)), dict(input_size=32),
                  (1, 2, 32, 32, 32)),
}


@pytest.mark.parametrize("case", list(ZOO))
def test_forward_equals_jax(case):
    name, kw, tkw, shape = ZOO[case]
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jm = jreg.build(name, **kw)
    params = flax_params(jm, x)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    model = treg.build(name, device="cpu", in_channels=shape[1], **kw, **tkw)
    model.load_state_dict(state_dict_from_flax(params, model))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(3, 4, 5, 10), (2, 2, 2, 64), (4, 4, 4, 96), (8, 8, 8, 7)])
@pytest.mark.parametrize("layout", ["sinusoidal_pe_3d", "sinusoidal_pe_3d_interleaved"])
def test_positional_encodings_equal_jax(layout, shape):
    got = getattr(tpe, layout)(*shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, getattr(jpe, layout)(*shape))


@pytest.mark.parametrize("window", [(2, 2, 2), (4, 4, 4), (1, 2, 3)])
def test_vtunet_bias_takes_the_construction_index_sliced(window):
    """A window clamped from 7³ gathers rows [:T, :T] of the 7³ index, as
    the reference and the JAX model do, not the clamped window's own index."""
    T = int(np.prod(window))
    attn = VTWindowAttention(12, 3, (7, 7, 7))
    table = np.random.default_rng(1).normal(size=(13 ** 3, 3)).astype(np.float32)
    attn.rel_pos_bias_table.data = torch.from_numpy(table)
    got = vt_rel_pos_bias(attn, T).detach().numpy()
    idx = relative_position_index((7, 7, 7))[:T, :T]
    np.testing.assert_array_equal(got, table[idx].transpose(2, 0, 1))
    own = relative_position_index(window)
    assert not np.array_equal(idx, own)


def test_published_windows_clamp_without_rebuilding():
    """VT-UNet's tables are for its construction window whatever the input:
    nothing in it follows the input size, so it registers none."""
    model = treg.build("vtunet", device="cpu", embed_dim=12)
    assert "input_size" not in treg.defaults("vtunet")
    assert {m.rel_pos_bias_table.shape[0] for m in model.modules()
            if getattr(m, "rel_pos_bias_table", None) is not None} == {13 ** 3}
