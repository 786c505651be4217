"""The port's importers of reference PyTorch checkpoints
(`convert/torch_import.py`, `convert/zoo_import.py`) against the JAX
package's mappers, on the CPU.

Each case draws a port model's weights with numpy (`torch_port_oracle`),
writes them in the reference's names and layout (`torch_port_reference`,
which inverts the port's rules), and reads that state_dict twice: with the
port's importer, and with the JAX package's mapper followed by
`state_dict_from_flax`. The two must be equal tensor by tensor, exactly: a
wrong key fails the JAX mapper's lookup, a wrong pairing or transform gives
other values. Then the port's f32 forward on the imported weights is held
against the JAX model's apply on the mapper's params: 1e-5 of max |output|
(the zoo tests' bar), 1e-4 absolute for MicFormer (the slice test's bar).
nnFormer's tables are scaled by 20 so that their re-indexing carries
weight. The last test holds the importers against the reference's own
torch models, where the reference's code is present.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import re  # noqa: E402
import types  # noqa: E402
from functools import lru_cache  # noqa: E402
from typing import Callable, NamedTuple  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu.convert import torch_import as jti  # noqa: E402
from micformer_tpu.convert import zoo_import as jzi  # noqa: E402
from micformer_tpu.models import mednext as jm  # noqa: E402
from micformer_tpu.models import vtunet as jvt  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.convert import torch_import as tti  # noqa: E402
from micformer_tpu_torch.convert import zoo_import as tzi  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.models import mednext as tm  # noqa: E402
from micformer_tpu_torch.models import vtunet as tvt  # noqa: E402

from torch_port_oracle import flax_params  # noqa: E402
from torch_port_reference import reference_state_dict  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Case(NamedTuple):
    jax_model: Callable          # () -> flax module
    port_model: Callable         # (seed) -> the port's module
    shape: tuple                 # the input's
    jax_mapper: Callable         # reference state_dict -> flax params
    rules: Callable              # the port's rules for a model
    importer: Callable           # the port's importer
    extra: dict                  # reference keys no rule reads -> shape
    rel: float | None = 1e-5     # the forward's bar: of max |output|, or
    atol: float | None = None    # absolute
    table_scale: float = 1.0


def _built(name, **kw):
    return lambda seed: treg.build(name, device="cpu",
                                   generator=torch.Generator().manual_seed(seed), **kw)


def _seeded(cls, **kw):
    def build(seed):
        torch.manual_seed(seed)
        return cls(**kw).eval()
    return build


MIC = dict(num_classes=8, embed_dim=12, depths=(1, 1), num_heads=(3, 6))
BTS = dict(base_channels=4, embedding_dim=64, hidden_dim=128, num_layers=2)
NNF = dict(embed_dim=24, window_sizes=(2, 2, 2, 2))
SWIN = dict(hidden_dim=24, head_dim=8, window_size=2, faithful_scramble=True)
TU = dict(num_channels_list=(4, 8, 16), embed_size=16)
VT = dict(embed_dim=24, window_size=(2, 2, 2), faithful_2d_merge=True)
VT_BLOCK = dict(dim=24, num_heads=3, window_size=(2, 2, 2), shift=True)
CUBE32, CUBE16 = (1, 2, 32, 32, 32), (1, 2, 16, 16, 16)
BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _mednext(ds):
    kw = dict(num_classes=8, n_channels=8, deep_supervision=ds, faithful_up=True)
    return Case(lambda: jm.MedNeXt(**kw), _seeded(tm.MedNeXt, **kw), CUBE16,
                lambda sd: jzi.mednext_params_from_torch(sd, deep_supervision=ds),
                tzi.mednext_rules, tzi.mednext_state_from_torch, {})


def _nnformer(ds):
    kw = dict(NNF, deep_supervision=ds)
    return Case(lambda: jreg.build("nnformer", **kw),
                _built("nnformer", in_channels=2, input_size=32, **kw), CUBE32,
                lambda sd: jzi.nnformer_params_from_torch(
                    sd, crop_size=(32, 32, 32), window_sizes=NNF["window_sizes"],
                    deep_supervision=ds),
                tzi.nnformer_rules, tzi.nnformer_state_from_torch, {}, table_scale=20.0)


CASES = {
    # the reference Head builds concat_back_dim.0 and never uses it
    "micformer": Case(lambda: jreg.build("micformer", **MIC), _built("micformer", **MIC),
                      CUBE32, lambda sd: jti.micformer_params_from_torch(sd, depths=(1, 1)),
                      tti.micformer_rules, tti.micformer_state_from_torch,
                      {"swin.concat_back_dim.0.weight": (24, 48),
                       "swin.concat_back_dim.0.bias": (24,)}, rel=None, atol=1e-4),
    "mednext": _mednext(False),
    "mednext_deep_supervision": _mednext(True),
    "transbts": Case(lambda: jreg.build("transbts", **BTS),
                     _built("transbts", in_channels=2, input_size=16, **BTS), CUBE16,
                     lambda sd: jzi.transbts_params_from_torch(sd, num_layers=2),
                     tzi.transbts_rules, tzi.transbts_state_from_torch,
                     {**{f"bn.{s}": (32,) for s in BN_STATS},
                      "pre_head_ln.weight": (64,), "pre_head_ln.bias": (64,)}),
    "nnformer": _nnformer(False),
    "nnformer_deep_supervision": _nnformer(True),
    # the shifted-window masks are state in the reference, derived in the port
    "swinunet3d": Case(lambda: jreg.build("swinunet3d", **SWIN),
                       _built("swinunet3d", in_channels=2, **SWIN), CUBE32,
                       jzi.swinunet3d_params_from_torch,
                       tzi.swinunet3d_rules, tzi.swinunet3d_state_from_torch,
                       {"down_stage12.swin_layers.0.1.attention_block.fn.fn.upper_lower_mask":
                        (8, 8)}),
    "transunet": Case(lambda: jreg.build("transunet", **TU),
                      _built("transunet", in_channels=2, input_size=16, **TU), CUBE16,
                      lambda sd: jzi.transunet_params_from_torch(sd, TU["num_channels_list"]),
                      tzi.transunet_rules, tzi.transunet_state_from_torch,
                      {f"encoder.conv_blocks.0.conv_block_1.normalization.{s}": (4,)
                       for s in BN_STATS}),
    "vtunet": Case(lambda: jreg.build("vtunet", **VT), _built("vtunet", in_channels=2, **VT),
                   CUBE32, jzi.vtunet_params_from_torch,
                   tzi.vtunet_rules, tzi.vtunet_state_from_torch, {}),
    "vtunet_block": Case(lambda: jvt.VTBlock(**VT_BLOCK), _seeded(tvt.VTBlock, **VT_BLOCK),
                         (1, 8, 8, 8, 24),
                         lambda sd: jzi.vtunet_block_params_from_torch(
                             types.SimpleNamespace(state_dict=lambda: sd)),
                         tzi.vtunet_block_rules, tzi.vtunet_block_state_from_torch, {}),
}


def _input(case):
    return np.random.default_rng(0).normal(size=case.shape).astype(np.float32)


@lru_cache(maxsize=None)
def _reference(name):
    """(reference state_dict, the port model whose weights it holds)."""
    case = CASES[name]
    src = case.port_model(0)
    src.load_state_dict(state_dict_from_flax(flax_params(case.jax_model(), _input(case)), src))
    state = {k: v * case.table_scale if k.endswith("rel_pos_bias_table") else v
             for k, v in src.state_dict().items()}
    extra = {k: torch.from_numpy(np.random.default_rng(1).normal(size=s).astype(np.float32))
             for k, s in case.extra.items()}
    return reference_state_dict(state, case.rules(src), extra), src


@lru_cache(maxsize=None)
def _imported(name):
    """(the port's import into a freshly built model: state, unused keys;
    the JAX mapper's params; those params as a port state_dict)."""
    case = CASES[name]
    ref, _ = _reference(name)
    dst = case.port_model(1)
    state, unused = case.importer(ref, dst)
    params = case.jax_mapper(ref)
    return dst, state, unused, params, state_dict_from_flax(params, dst)


@pytest.mark.parametrize("name", list(CASES))
def test_import_equals_jax_mapper(name):
    _, state, _, _, want = _imported(name)
    assert sorted(state) == sorted(want)
    for k in want:
        assert state[k].dtype == torch.float32
        assert torch.equal(state[k], want[k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_imported_forward_equals_jax(name):
    case = CASES[name]
    dst, state, _, params, _ = _imported(name)
    dst.load_state_dict(state)
    x = _input(case)
    want = jax.jit(case.jax_model().apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = dst(torch.from_numpy(x))
    if name == "vtunet_block":                  # (x, v, k) of both; JAX adds a fourth
        got, want = got[:3], want[:3]
    elif not isinstance(got, (list, tuple)):
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        atol = case.atol if case.rel is None else case.rel * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_unread_keys_are_reported(name):
    """The dead keys a reference checkpoint holds are accepted and returned;
    a family without any leaves none unread."""
    _, _, unused, _, _ = _imported(name)
    assert unused == sorted(CASES[name].extra)


@pytest.mark.parametrize("name", list(CASES))
def test_missing_or_misshapen_reference_tensor_raises(name):
    case = CASES[name]
    ref, _ = _reference(name)
    dst = case.port_model(1)
    key = next(r.refs[0] for r in case.rules(dst).values() if r.refs)
    with pytest.raises(KeyError, match=re.escape(key)):
        case.importer({k: v for k, v in ref.items() if k != key}, dst)
    bad = dict(ref, **{key: torch.zeros((ref[key].shape[0] + 1,) + ref[key].shape[1:])})
    with pytest.raises(ValueError, match=re.escape(key)):
        case.importer(bad, dst)


def test_a_port_parameter_no_rule_fills_raises():
    ref, src = _reference("mednext")
    rules = tzi.mednext_rules(src)
    del rules["stem.bias"]
    with pytest.raises(KeyError, match="stem.bias"):
        tti.import_state(ref, src, rules)


def test_imported_tensors_take_the_models_dtype():
    ref, _ = _reference("mednext")
    dst = CASES["mednext"].port_model(1).to(torch.bfloat16)
    state, _ = tzi.mednext_state_from_torch(ref, dst)
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    dst.load_state_dict(state)


@pytest.mark.parametrize("window", [(1, 1, 1), (2, 2, 2), (4, 4, 4), (7, 7, 7)])
def test_rpe_remap_equals_jax(window):
    rows = np.prod([2 * w - 1 for w in window])
    table = np.random.default_rng(3).normal(size=(rows, 3)).astype(np.float32)
    want = jzi.nnformer_rpe_remap(table, window)
    got = tzi.nnformer_rpe_remap(torch.from_numpy(table), window)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the reference's own torch models, where its code is present -------------

def _reference_code(*parts):
    path = os.path.join(jzi.REFERENCE, *parts)
    if not os.path.isdir(path):
        pytest.skip(f"the reference's code is not at {path}")


def test_micformer_imported_from_the_reference_model():
    _reference_code("MicFormer", "models")
    torch.manual_seed(0)
    ref = jti.load_reference_micformer(jzi.REFERENCE, embed_dim=24, num_classes=8)
    model = treg.build("micformer", device="cpu", embed_dim=24, num_classes=8)
    state, unused = tti.micformer_state_from_torch(ref.state_dict(), model)
    model.load_state_dict(state)
    assert all(k.startswith("swin.concat_back_dim.0.") for k in unused), unused
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, 64, 64, 64)).astype(np.float32))
    with torch.no_grad():
        err = (model(x) - ref(x)).abs().max().item()
    assert err < 5e-4, err


@pytest.mark.parametrize("deep_supervision", [False, True])
def test_mednext_imported_from_the_reference_model(deep_supervision):
    _reference_code("MedNeXt")
    torch.manual_seed(0)
    ref = jzi.load_reference_mednext(jzi.REFERENCE, size="S", in_channels=2, num_classes=8,
                                     deep_supervision=deep_supervision)
    model = treg.build("mednext", device="cpu", faithful_up=True,
                       deep_supervision=deep_supervision)
    state, unused = tzi.mednext_state_from_torch(ref.state_dict(), model)
    model.load_state_dict(state)
    assert unused == []
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 2, 32, 32, 32)).astype(np.float32))
    with torch.no_grad():
        got, want = model(x), ref(x)
    if not deep_supervision:
        got, want = [got], [want]
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() < 5e-4
