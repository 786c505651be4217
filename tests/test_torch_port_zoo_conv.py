"""The rest of the zoo's conv-led models on the CPU against the JAX package:
`transbts` (probabilities, and logits with softmax_output=False),
`transunet`, `unet_conv`, `halfunet` and `unet_patchify`, at
`tests/test_model_zoo.py`'s small configs, f32, eval mode, on numpy-seeded
weights and inputs. Then: the port's registry builds every name the JAX
registry has, the models whose parameter shapes follow their input say so,
and refuse an input they were not built for.

Tolerance: 1e-5 of the largest output (f32 sums in another order; flax's
GroupNorm computes E[x²] − E[x]², as the port's does). The JAX TransUNet
family runs W-packed levels and matmul gates under its defaults (32³
input), the port the plain math. TransBTS's ViT at a 16³ input holds 2³ = 8
tokens, so the port's dispatch takes K1 (its plain version on the CPU) where
larger inputs take the plain chain: the same math.
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
from micformer_tpu_torch.kernels import ATTENTION_PATHS  # noqa: E402

from torch_port_oracle import flax_params  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BTS = dict(base_channels=4, embedding_dim=64, hidden_dim=128, num_layers=2)
TU = dict(num_channels_list=(4, 8, 16, 32, 48, 64))
# (registry name, kwargs of both, kwargs of the port alone, input shape)
ZOO = {
    "transbts": ("transbts", BTS, dict(input_size=16), (1, 2, 16, 16, 16)),
    "transbts_logits": ("transbts", dict(BTS, softmax_output=False), dict(input_size=16),
                        (1, 2, 16, 16, 16)),
    "transunet": ("transunet", dict(TU, embed_size=16), dict(input_size=32), (1, 2, 32, 32, 32)),
    "unet_conv": ("unet_conv", TU, {}, (1, 2, 32, 32, 32)),
    "halfunet": ("halfunet", TU, {}, (1, 2, 32, 32, 32)),
    "unet_patchify": ("unet_patchify", dict(num_channels_list=(4, 8, 16, 32),
                                            channel_embedding=8), {}, (1, 2, 32, 32, 32)),
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
    before = dict(ATTENTION_PATHS)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    if name == "transbts":
        assert ATTENTION_PATHS["k1"] - before["k1"] == BTS["num_layers"]
        sums = got.sum(1).numpy()
        if kw.get("softmax_output", True):
            np.testing.assert_allclose(sums, 1.0, atol=1e-5)   # probabilities, as JAX's
        else:
            assert np.abs(sums - 1.0).max() > 0.1                # logits


# narrow widths for the registry's wide defaults (each 1-5 s to draw)
SMALL = {"generic_unet": dict(base_num_features=4),
         "micformer": dict(embed_dim=12, depths=(1, 1), num_heads=(3, 6)),
         "nnformer": dict(embed_dim=12), "nnformer_singlemodal": dict(embed_dim=12),
         "swinunet3d": dict(hidden_dim=24, head_dim=8), "swinunet3d_pure": dict(hidden_dim=24,
                                                                                head_dim=8),
         "vtunet": dict(embed_dim=12), "transbts": dict(BTS, input_size=16),
         "transunet": dict(TU, input_size=32), "unet_conv": TU, "halfunet": TU,
         "unet_patchify": TU}


def test_registry_builds_every_jax_name():
    """Fifteen names in both registries, each built (narrow where the
    default is wide; TransBTS with the input_size it needs)."""
    from micformer_tpu_torch import models  # noqa: F401  (registers)

    names = jreg.available()
    assert names == sorted(treg._REGISTRY) and len(names) == 15
    for name in names:
        model = treg.build(name, device="cpu", **SMALL.get(name, {}))
        assert sum(p.numel() for p in model.parameters()) > 0, name


def test_registry_marks_the_zoos_models_built_for_an_input():
    """SwinUNETR's bias tables, TransBTS's pos_embed and TransUNet's gate
    patches follow the input: they register `input_size` (cli/train fills it
    in with the patch); VT-UNet and the three conv U-Nets do not."""
    names = ("vtunet", "swinunetr", "transbts", "transunet", "unet_conv", "halfunet",
             "unet_patchify")
    assert {n for n in names if "input_size" in treg.defaults(n)} == {
        "swinunetr", "transbts", "transunet"}


def test_transbts_needs_and_holds_to_its_input_size():
    with pytest.raises(ValueError, match="input_size"):
        treg.build("transbts", device="cpu", **BTS)
    model = treg.build("transbts", device="cpu", input_size=(16, 16, 32), **BTS)
    assert tuple(model.pos_embed.shape) == (1, 2 * 2 * 4, 64)
    with torch.no_grad(), pytest.raises(ValueError, match="input_size"):
        model(torch.zeros(1, 2, 16, 16, 16))


def test_transunet_gates_follow_their_input_size():
    """Gate patches are the skips' extents over 8 (at least 1): 4, 2, 1, 1,
    1 at 32³; 16, 8, 4, 2, 1 at the default 128³. An input with other
    patches raises (JAX's parameter shapes would not fit it)."""
    at32 = treg.build("transunet", device="cpu", input_size=32, **TU)
    at128 = treg.build("transunet", device="cpu", **TU)
    assert [at32.get_submodule(f"gate{j}").embed_skip.kernel_size[0] for j in range(5)] == [
        1, 1, 1, 2, 4]
    assert [at128.get_submodule(f"gate{j}").embed_skip.kernel_size[0] for j in range(5)] == [
        1, 2, 4, 8, 16]
    with torch.no_grad(), pytest.raises(ValueError, match="input_size"):
        at128(torch.zeros(1, 2, 32, 32, 32))
