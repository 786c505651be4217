"""The port's serving artifact against the JAX package's serving program on
the CPU: MicFormer on weights converted from flax, the port's f32 logits
artifact (exported, saved and loaded) against JAX's live
`convert.aot_export.build_inference_fn` on the same volume.

The JAX package's MICFORMER_* flags are cleared before it is imported, so it
runs its default forms.
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
from micformer_tpu.convert.aot_export import build_inference_fn as jax_inference_fn  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.convert.aot_export import export_artifact, load_artifact  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402

TINY = dict(num_classes=8, embed_dim=12, depths=(1, 1), num_heads=(3, 6))
SHAPE = (32, 32, 40)
ROI = (32, 32, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The JAX MicFormer with its params, and the port's on them."""
    jmodel = jreg.build("micformer", **TINY)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 2, 16, 16, 16)))
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel = treg.build("micformer", device="cpu", **TINY)
    tmodel.load_state_dict(state_dict_from_flax(params, tmodel))
    return jmodel, params, tmodel


@pytest.mark.parametrize("step_mode", ["monai", "nnunet"])
def test_logits_artifact_equals_jax_build_inference_fn(tmp_path, pair, step_mode):
    """Logits within 1e-4; the argmax equal wherever JAX's top-two margin
    exceeds 1e-3."""
    jmodel, params, tmodel = pair
    kw = dict(roi=ROI, num_classes=8, overlap=0.5, sw_batch_size=2, step_mode=step_mode)
    x = np.random.default_rng(1).normal(size=(1, 2, *SHAPE)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_inference_fn(jmodel, params, argmax=False, **kw))(
        jnp.asarray(x)))

    export_artifact(str(tmp_path / "art"), tmodel, target_shape=SHAPE, argmax=False, **kw)
    fn, meta = load_artifact(str(tmp_path / "art"))
    assert meta["step_mode"] == step_mode and meta["output"] == "logits_f32"
    with torch.no_grad():
        got = fn(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 8, *SHAPE)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    top2 = np.sort(ref, axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 1e-3
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(1)[sure], ref.argmax(1)[sure])
