"""Tensor parallelism (`parallel/tensor.py`) on the CPU against the JAX
package's `micformer_tpu/parallel/tensor.py`.

The plan: `tensor_parallel_plan` against `tensor_parallel_shardings` on a
'model' mesh of W of the 8 CPU devices (`tests/conftest.py`), leaf by leaf
through the converter's names, at W = 2 and 4: equal wherever heads divide
by W (MicFormer with heads (4, 8), TransBTS), and where they do not the port
replicates what JAX splits, which the test lists (MicFormer with heads (3, 6)
at W = 2: its 3-head stage; TransUNet's gates: JAX splits `q` alone).

The forward: two spawned gloo ranks (`tests/torch_port_ranks.py`), each on
its shard through `tensor_parallel_apply`, against the JAX model's
unsharded `apply` on the same numpy-seeded weights and input, within 1e-5
of the largest logit (f32 sums in another order, the row-parallel ones
split in two and all-reduced). Cases: MicFormer (4, 8) and (3, 6) (K1 on
each rank's heads: the plain version here); VT-UNet (split encoder K/V
saved for the decoder's cross path, bias tables read by the rank's heads,
its 3-head stage whole); TransBTS.
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
from jax.sharding import Mesh  # noqa: E402

from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu.parallel.tensor import tensor_parallel_shardings  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.convert.from_flax import flax_names, state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.parallel.tensor import (  # noqa: E402
    COLUMN, REPLICATED, ROW, replicated_modules, tensor_parallel_plan,
)

from torch_port_oracle import flax_params  # noqa: E402
from torch_port_ranks import run_ranks, tensor_parallel_worker  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (registry name, kwargs of both, kwargs of the port alone, input shape)
MODELS = {
    "micformer": ("micformer", dict(num_classes=4, embed_dim=24, depths=(1, 1),
                                    num_heads=(4, 8)), {}, (1, 2, 32, 32, 32)),
    "micformer_heads3": ("micformer", dict(num_classes=4, embed_dim=24, depths=(1, 1),
                                           num_heads=(3, 6)), {}, (1, 2, 32, 32, 32)),
    "transbts": ("transbts", dict(base_channels=4, embedding_dim=64, hidden_dim=128,
                                  num_layers=2), dict(input_size=16), (1, 2, 16, 16, 16)),
    "transunet": ("transunet", dict(num_channels_list=(4, 8, 16, 32), embed_size=16),
                  dict(input_size=32), (1, 2, 32, 32, 32)),
    "vtunet": ("vtunet", dict(embed_dim=24, window_size=(2, 2, 2)), {}, (1, 2, 32, 32, 32)),
}


def _setup(key):
    name, kw, tkw, shape = MODELS[key]
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jm = jreg.build(name, **kw)
    params = flax_params(jm, x)
    in_ch = {} if name == "micformer" else {"in_channels": shape[1]}
    model = treg.build(name, device="cpu", **kw, **tkw, **in_ch)
    return jm, params, x, model, dict(kw, **tkw, **in_ch)


def _jax_plan(params, world):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("model",))
    out = {}
    for k, s in flatten_dict(tensor_parallel_shardings(params, mesh)).items():
        spec = tuple(s.spec)
        out["/".join(map(str, k))] = (ROW if spec[:1] == ("model",) and len(spec) == 2 else
                                      COLUMN if "model" in spec else REPLICATED)
    return out


def _plans(key, world):
    """{torch name: (port's kind, JAX's kind)}."""
    _, params, _, model, _ = _setup(key)
    jplan = _jax_plan(params, world)
    plan = tensor_parallel_plan(model, world)
    names = flax_names(params, model)
    assert set(names) == set(plan)
    return {n: (plan[n], jplan[path]) for n, path in names.items()}, model


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", ["micformer", "transbts"])
def test_plan_equals_jax_shardings(key, world):
    plans, _ = _plans(key, world)
    assert all(a == b for a, b in plans.values()), {n: p for n, p in plans.items()
                                                     if p[0] != p[1]}
    kinds = [a for a, _ in plans.values()]
    assert kinds.count(COLUMN) and kinds.count(ROW)


@pytest.mark.parametrize("key,world,whole", [
    # MicFormer's 3-head stage: its two self blocks' and two cross blocks'
    # attention (encoder 0 and decoder 0, the latter's blocks named as the
    # JAX tree names them)
    ("micformer_heads3", 2, 8),
    # TransUNet's three gates (q, k, v and out: no qkv or q+kv with proj)
    ("transunet", 2, 0),
])
def test_plan_replicates_where_heads_do_not_split(key, world, whole):
    """Where the port and JAX differ: always a leaf JAX splits and the port
    replicates, and only in attention modules the port keeps whole."""
    plans, model = _plans(key, world)
    diff = {n: p for n, p in plans.items() if p[0] != p[1]}
    assert diff and all(p == REPLICATED and j in (COLUMN, ROW) for p, j in diff.values())
    kept = replicated_modules(model, world)
    assert len(kept) == whole
    if key == "transunet":
        assert sorted(diff) == sorted(f"gate{j}.q.{p}" for j in range(3)
                                      for p in ("weight", "bias"))
    else:
        assert {n.rsplit(".", 2)[0] for n in diff} == set(kept)


def test_tensor_parallel_apply_equals_jax(tmp_path):
    cases, want = {}, {}
    for key in ("micformer", "micformer_heads3", "vtunet", "transbts"):
        jm, params, x, model, kw = _setup(key)
        want[key] = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
        model.load_state_dict(state_dict_from_flax(params, model))
        cases[key] = (MODELS[key][0], kw, model.state_dict(), x)
    outs = run_ranks(2, tmp_path, tensor_parallel_worker, cases=cases)
    for key, w in want.items():
        for r in (0, 1):
            got, held, whole = outs[r][key]
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{key} rank {r}")
            assert held < whole, key
        np.testing.assert_array_equal(outs[0][key][0], outs[1][key][0])
