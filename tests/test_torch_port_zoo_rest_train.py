"""The rest of the zoo's training path on the CPU: one port `Trainer` step of
VT-UNet and of TransBTS against jax.value_and_grad of the same mdice loss on
the same numpy-seeded weights and batch (f32, no augmentation, drop_path 0
and dropout off: JAX draws its masks from its own PRNG, so parity holds in
deterministic mode only), the loss within 1e-5 relative and every gradient
leaf within 1e-3 of its own largest entry, as `test_torch_port_zoo_train.py`
holds nnFormer's and SwinUnet3D's.

TransBTS's gradient sums cancel strongly at several leaves, so two f32
runs whose loss gradients differ by an ulp here and there (two f32 mdice
implementations) differ by up to 1e-3 of such a leaf's largest entry,
and the JAX f32 backward of its full-resolution stem strays 2e-3 to 8e-3 of
its largest entry from an f64 run. So its step is checked in two halves:
the loss (1e-5 relative) and its gradient in the model's output against
jax.grad of the JAX mdice at the JAX model's output (1e-5 of its largest
entry); then the port's parameter gradients against the JAX model's
backward of that same output gradient (jax.vjp, the flax model in f64 under
jax.enable_x64), every leaf within 1e-3 of its own largest entry. A conv
bias that feeds an instance norm or a one-channel group straight away has
an exact gradient of zero, and every run's value there is rounding noise:
those leaves, the ones whose f64 gradient is below 1e-5 of the model's
largest entry, are held to zero within 1e-5 of that entry.

Dropout draws from the generator. Then
the seven names through `cli/train` (VT-UNet from both of its configs), the
models built for an input with the patch recorded, and TransBTS's run
through `cli/predict` and `cli/serve`, which rebuild it from config.json.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu.losses.dice import mdice_loss as jmdice  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from micformer_tpu_torch.models.layers import Dropout  # noqa: E402
from micformer_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

from torch_port_oracle import flax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BTS = dict(base_channels=4, embedding_dim=64, hidden_dim=128, num_layers=2)
MODELS = {"vtunet": (dict(embed_dim=24, window_size=(2, 2, 2), drop_path_rate=0.0), {}, 32),
          "transbts": (dict(BTS, dropout=0.0), dict(input_size=32), 32)}


def _batch(size):
    rng = np.random.default_rng(3)
    shape = (size,) * 3
    return (rng.uniform(0, 1, (1, 2) + shape).astype(np.float16),
            rng.integers(0, 8, (1,) + shape).astype(np.uint8))


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_gradients_equal_jax_grad(tmp_path, name):
    kw, tkw, size = MODELS[name]
    img, lab = _batch(size)
    x = img.astype(np.float32)
    jm = jreg.build(name, **kw)
    params = flax_params(jm, x)
    target = jnp.transpose(jax.nn.one_hot(jnp.asarray(lab), 8), (0, 4, 1, 2, 3))
    model = treg.build(name, device="cpu", **kw, **tkw)
    model.load_state_dict(state_dict_from_flax(params, model))
    for m in model.modules():       # TransBTS's stem dropout (0.2) is not a kwarg
        if isinstance(m, Dropout):
            m.rate = 0.0
    seen = {}

    def keep_output(mod, args, out):
        seen["out"] = out.detach()
        out.register_hook(lambda g: seen.setdefault("grad", g))

    model.register_forward_hook(keep_output)
    trainer = Trainer(model, TrainConfig(run_dir=str(tmp_path), optimizer="sgd_nesterov",
                                         lr=0.01, epochs=1, steps_per_epoch=1,
                                         augment="none", loss="mdice"))
    rec = trainer.train_step(torch.from_numpy(img), torch.from_numpy(lab))
    if name == "transbts":
        out = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
        loss, g_out = jax.value_and_grad(lambda o: jmdice(o, target))(out)
        for got, w in ((seen["out"], out), (seen["grad"], g_out)):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
        with jax.enable_x64(True):
            jm64 = jreg.build(name, dtype=jnp.float64, **kw)
            p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
            grads = jax.jit(lambda p, g: jax.vjp(lambda q: jm64.apply(
                {"params": q}, jnp.asarray(x, jnp.float64)), p)[1](g)[0])(
                p64, jnp.asarray(seen["grad"].numpy()))
    else:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jmdice(jm.apply({"params": p}, jnp.asarray(x)), target)))(params)
    assert rec["loss"] == pytest.approx(float(loss), rel=1e-5)
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads), model)
    assert set(want) == {n for n, _ in model.named_parameters()}
    top = max(w.abs().max().item() for w in want.values())
    zero = {n for n, w in want.items() if name == "transbts" and w.abs().max() < 1e-5 * top}
    assert len(zero) < len(want) // 4
    for n, p in model.named_parameters():
        if n in zero:
            assert p.grad.abs().max().item() <= 1e-5 * top, n
            continue
        scale = max(want[n].abs().max().item(), 1e-8)
        assert (p.grad - want[n]).abs().max().item() <= 1e-3 * scale, n


def test_dropout_draws_from_the_generator():
    """Train mode: the same generator seed draws the same masks (TransBTS's
    0.2 stem dropout and 0.1 in the ViT), another seed others; eval mode
    drops nothing."""
    model = treg.build("transbts", device="cpu", input_size=16, **BTS)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 2, 16, 16, 16))
                         .astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        model.train()
        a, b, c = (model(x, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ref)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    data = tmp_path_factory.mktemp("zoo_rest_data")
    write_synthetic_dataset(str(data), n_cases=6, shape=(34, 36, 32), seed=0)
    return data


SMALL_TU = {"num_channels_list": [4, 8, 16, 32], "embed_size": 16}
CLI = {  # case -> cli/train arguments (one CPU epoch of two steps)
    "vtunet_base": ["--cfg", os.path.join(REPO, "configs", "vtunet_base.yaml"),
                    "--model-kwargs", json.dumps({"embed_dim": 12, "window_size": [2, 2, 2]})],
    "vtunet_tiny": ["--cfg", os.path.join(REPO, "configs", "vtunet_tiny.yaml"),
                    "--model-kwargs", json.dumps({"embed_dim": 12})],
    "swinunetr": ["--model", "swinunetr", "--model-kwargs",
                  json.dumps({"feature_size": 4, "num_heads": [1, 2, 4, 8],
                              "window_size": [2, 2, 2]})],
    "transbts": ["--model", "transbts", "--model-kwargs", json.dumps(BTS)],
    "transunet": ["--model", "transunet", "--model-kwargs", json.dumps(SMALL_TU)],
    "unet_conv": ["--model", "unet_conv", "--model-kwargs",
                  json.dumps({"num_channels_list": [4, 8, 16]})],
    "halfunet": ["--model", "halfunet", "--model-kwargs",
                 json.dumps({"num_channels_list": [4, 8, 16], "channel_outputconv": 8})],
    "unet_patchify": ["--model", "unet_patchify", "--model-kwargs",
                      json.dumps({"num_channels_list": [4, 8, 16], "channel_embedding": 8})],
}


@pytest.mark.parametrize("case", list(CLI))
def test_cli_train_takes_the_zoo(root, tmp_path, case):
    from micformer_tpu_torch.cli import train

    run = tmp_path / "run"
    trainer = train.main(["--data", str(root), "--cache", str(root / "cache"), "--device",
                          "cpu", "--target-shape", "32", "--epochs", "1", "--val", "1",
                          "--batch-size", "2", "--run-dir", str(run), "--workers", "0",
                          *CLI[case]])
    assert trainer.step == 2 and all(np.isfinite(r["loss"]) for r in trainer.history)
    model = json.loads((run / "config.json").read_text())["model"]
    name = case.split("_")[0] if case.startswith("vtunet") else case
    assert model["name"] == name and model["extra"]["in_channels"] == 2
    if name in ("swinunetr", "transbts", "transunet"):
        assert model["extra"]["input_size"] == [32, 32, 32]
    else:
        assert "input_size" not in model["extra"]
    assert (run / "ckpt_best_dice.pt").exists()
    if name == "transbts":
        from micformer_tpu_torch.cli import predict, serve

        recs = predict.main(["--data", str(root), "--cache", str(root / "cache"),
                             "--device", "cpu", "--run-dirs", str(run), "--out",
                             str(tmp_path / "preds"), "--target-shape", "32", "--roi", "32"])
        assert len(recs) == 1 and (tmp_path / "preds" / f"{recs[0]['patient_id']}_pred.nii.gz"
                                   ).exists()
        (tmp_path / "in").mkdir()
        np.save(tmp_path / "in" / "req.npy",
                np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 32)).astype(np.float32))
        os.utime(tmp_path / "in" / "req.npy", (0, 0))
        serve.main(["--run-dir", str(run), "--device", "cpu", "--watch", str(tmp_path / "in"),
                    "--out", str(tmp_path / "out"), "--roi", "32", "--max-requests", "1"])
        assert (tmp_path / "out" / "req_seg.nii.gz").exists()
