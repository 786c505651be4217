"""The zoo's training path on the CPU: one port `Trainer` step of nnFormer
and of SwinUnet3D against jax.value_and_grad of the same mdice loss on the
same numpy-seeded weights and batch (f32, drop_path 0, no augmentation):
the loss within 1e-5 relative, every gradient leaf within 1e-3 of its own
largest entry (f32 sums over 32³ voxels in another order, through the
softmax chain). Then the five registry names through `cli/train` (nnFormer
from `configs/nnformer_mmwhs.yaml`), `cli/predict` from the nnFormer run and
`cli/serve` from the SwinUnet3D run, on a tiny synthetic root.
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
from micformer_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

from torch_port_oracle import flax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = {"nnformer": dict(embed_dim=24, window_sizes=(2, 2, 2, 2), drop_path_rate=0.0),
          "swinunet3d": dict(hidden_dim=24, head_dim=8, window_size=2)}
PORT_ONLY = {"nnformer": dict(input_size=32), "swinunet3d": {}}


def _batch(shape=(32, 32, 32)):
    rng = np.random.default_rng(3)
    return (rng.uniform(0, 1, (1, 2) + shape).astype(np.float16),
            rng.integers(0, 8, (1,) + shape).astype(np.uint8))


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_gradients_equal_jax_grad(tmp_path, name):
    img, lab = _batch()
    x = img.astype(np.float32)
    jm = jreg.build(name, **MODELS[name])
    params = flax_params(jm, x)
    target = jnp.transpose(jax.nn.one_hot(jnp.asarray(lab), 8), (0, 4, 1, 2, 3))

    def loss_fn(p):
        return jmdice(jm.apply({"params": p}, jnp.asarray(x)), target)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = treg.build(name, device="cpu", **MODELS[name], **PORT_ONLY[name])
    model.load_state_dict(state_dict_from_flax(params, model))
    trainer = Trainer(model, TrainConfig(run_dir=str(tmp_path), optimizer="sgd_nesterov",
                                         lr=0.01, epochs=1, steps_per_epoch=1,
                                         augment="none", loss="mdice"))
    rec = trainer.train_step(torch.from_numpy(img), torch.from_numpy(lab))
    assert rec["loss"] == pytest.approx(float(loss), rel=1e-5)
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads), model)
    assert set(want) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        scale = max(want[n].abs().max().item(), 1e-8)
        assert (p.grad - want[n]).abs().max().item() <= 1e-3 * scale, n


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    data = tmp_path_factory.mktemp("zoo_data")
    write_synthetic_dataset(str(data), n_cases=6, shape=(34, 36, 32), seed=0)
    return data


CLI = {  # registry name -> cli/train arguments (the five names, one CPU epoch)
    "nnformer": ["--cfg", os.path.join(REPO, "configs", "nnformer_mmwhs.yaml"),
                 "--model-kwargs", json.dumps({"embed_dim": 12, "window_sizes": [2, 2, 2, 2],
                                               "num_heads": [3, 3, 3, 3]})],
    "nnformer_singlemodal": ["--model", "nnformer_singlemodal", "--single-modal",
                             "--model-kwargs", json.dumps({"embed_dim": 6,
                                                           "num_heads": [3, 3, 3, 3]})],
    "swinunet3d": ["--model", "swinunet3d", "--model-kwargs", json.dumps(MODELS["swinunet3d"])],
    "swinunet3d_pure": ["--model", "swinunet3d_pure",
                        "--model-kwargs", json.dumps(MODELS["swinunet3d"])],
    "unet3d": ["--model", "unet3d"],
}


@pytest.mark.parametrize("name", list(CLI))
def test_cli_train_takes_the_zoo(root, tmp_path, name):
    from micformer_tpu_torch.cli import train

    run = tmp_path / "run"
    trainer = train.main(["--data", str(root), "--cache", str(root / "cache"), "--device",
                          "cpu", "--target-shape", "32", "--epochs", "1", "--val", "1",
                          "--batch-size", "2", "--run-dir", str(run), "--workers", "0",
                          *CLI[name]])
    assert trainer.step == 2 and all(np.isfinite(r["loss"]) for r in trainer.history)
    extra = json.loads((run / "config.json").read_text())["model"]
    assert extra["name"] == name
    assert extra["extra"]["in_channels"] == (1 if name.endswith("singlemodal") else 2)
    if name.startswith("nnformer"):
        assert extra["extra"]["input_size"] == [32, 32, 32]
    assert (run / "ckpt_best_dice.pt").exists()
    if name == "nnformer":
        from micformer_tpu_torch.cli import predict

        recs = predict.main(["--data", str(root), "--cache", str(root / "cache"),
                             "--device", "cpu", "--run-dirs", str(run), "--out",
                             str(tmp_path / "preds"), "--target-shape", "32", "--roi", "32"])
        assert len(recs) == 1 and (tmp_path / "preds" / f"{recs[0]['patient_id']}_pred.nii.gz"
                                   ).exists()
    if name == "swinunet3d":
        from micformer_tpu_torch.cli import serve

        (tmp_path / "in").mkdir()
        np.save(tmp_path / "in" / "req.npy",
                np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 32)).astype(np.float32))
        os.utime(tmp_path / "in" / "req.npy", (0, 0))
        serve.main(["--run-dir", str(run), "--device", "cpu", "--watch", str(tmp_path / "in"),
                    "--out", str(tmp_path / "out"), "--roi", "32", "--max-requests", "1"])
        assert (tmp_path / "out" / "req_seg.nii.gz").exists()
