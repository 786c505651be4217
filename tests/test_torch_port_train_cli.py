"""`cli/train.py --device cpu` with the flags of the rest of the trainer, on
a tiny synthetic MM-WHS root: every flag of the JAX training CLI parses into
the JAX config's field and each loss of the zoo into the trainer's; the
cascade run records 9 input channels in config.json, which `cli/predict
--cascade-prev-seg-dir` rebuilds and runs; `--single-modal` trains MedNeXt on
one channel with spawned process workers (MicFormer refuses it);
`--pretrained` seeds from another run's checkpoint; `--find-lr` prints its
line.

Each test runs torch on one thread: the models are tiny, and the test
workers share the machine's cores.
"""

import functools
import inspect
import json

import numpy as np
import pytest
import torch

from micformer_tpu import config as jcfg
from micformer_tpu.train.trainer import Trainer as JTrainer
from micformer_tpu_torch import config as tcfg
from micformer_tpu_torch import registry as treg
from micformer_tpu_torch.cli import predict, train
from micformer_tpu_torch.data.cascade import resize_seg_nearest
from micformer_tpu_torch.data.mmwhs import get_datasets
from micformer_tpu_torch.data.synthetic import write_synthetic_dataset
from micformer_tpu_torch.kernels import LAUNCHES
from micformer_tpu_torch.train.checkpoint import CheckpointManager
from micformer_tpu_torch.train.trainer import LOSSES, TrainConfig, Trainer

MICFORMER = ["--model", "micformer", "--model-kwargs",
             json.dumps({"embed_dim": 6, "depths": [1, 1], "num_heads": [3, 6]})]
MEDNEXT = ["--model", "mednext", "--model-kwargs", json.dumps({"n_channels": 4})]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A six-case root (four train, one validation, one test) and the
    previous stage's maps of every case at half the 16³ grid."""
    base = tmp_path_factory.mktemp("cli")
    data, prev = base / "data", base / "prev"
    write_synthetic_dataset(str(data), n_cases=6, shape=(20, 18, 22), seed=0)
    prev.mkdir()
    for ds in get_datasets(str(data), cache_dir=str(base / "cache"), target_shape=(16,) * 3):
        for i in range(len(ds)):
            s = ds[i]
            seg = np.argmax(s["label"], axis=0).astype(np.uint8)
            np.save(prev / f"{s['patient_id']}_segFromPrevStage.npy",
                    resize_seg_nearest(seg, (8, 8, 8)))
    return base


def _common(root):
    return ["--data", str(root / "data"), "--cache", str(root / "cache"), "--device", "cpu",
            "--target-shape", "16", "--val", "1", "--epochs", "1", "--workers", "2"]


def test_parser_takes_every_jax_train_flag():
    """Every option of the JAX parser exists in the port's and lands in the
    same config field."""
    jopts = {s for a in jcfg.build_argparser()._actions for s in a.option_strings}
    topts = {s for a in tcfg.build_argparser()._actions for s in a.option_strings}
    assert jopts <= topts, sorted(jopts - topts)
    for attr, target in jcfg._ARG_MAP.items():
        assert tcfg._ARG_MAP[attr] == target, attr
    args = tcfg.build_argparser().parse_args(
        ["--single-modal", "--worker-mode", "process", "--oversample-fg", "0.33",
         "--cascade-prev-seg-dir", "p", "--pretrained", "r:best_loss", "--loss", "mcc",
         "--find-lr"])
    cfg = tcfg.config_from_args(args)
    assert (cfg.data.single_modal, cfg.data.worker_mode, cfg.train.oversample_fg,
            cfg.train.cascade_prev_seg_dir, cfg.train.pretrained, cfg.train.extra_loss,
            args.find_lr) == (True, "process", 0.33, "p", "r:best_loss", "mcc", True)


@pytest.mark.parametrize("loss", ["mdice", "dice_ce", "gdl", "topk", "focal", "mcc",
                                  "dice_topk", "dice_bce"])
def test_cli_takes_each_loss(loss):
    """--loss reaches the trainer's config and its loss function (each loss
    is held against JAX in test_torch_port_losses.py; the runs below train
    with mcc, dice_bce and focal)."""
    cfg = tcfg.config_from_args(tcfg.build_argparser().parse_args(["--loss", loss]))
    assert TrainConfig(loss=cfg.train.extra_loss).loss == loss and loss in LOSSES


def test_cli_cascade_run_is_rebuilt_by_predict(root, tmp_path):
    """MedNeXt on 2 + 7 channels with oversampled patches (batch 2, one
    forced): config.json records in_channels 9, which cli/predict's
    run_model rebuilds; predict appends the same channels and runs."""
    run = tmp_path / "run"
    before = dict(LAUNCHES)
    trainer = train.main(_common(root) + MEDNEXT + [
        "--cascade-prev-seg-dir", str(root / "prev"), "--oversample-fg", "0.33",
        "--batch-size", "2", "--loss", "mcc", "--run-dir", str(run)])
    assert trainer.model.stem.weight.shape[1] == 9
    assert trainer.cfg.num_modalities == 2 and trainer.step == 2
    saved = json.loads((run / "config.json").read_text())
    assert saved["model"]["extra"]["in_channels"] == saved["model"]["in_channels"] == 9
    assert tcfg.run_model(str(run))[1]["in_channels"] == 9
    recs = predict.main(["--device", "cpu", "--data", str(root / "data"),
                         "--cache", str(root / "cache"), "--run-dirs", str(run),
                         "--out", str(tmp_path / "pred"), "--target-shape", "16", "--roi", "16",
                         "--cascade-prev-seg-dir", str(root / "prev")])
    assert len(recs) == 1
    assert (tmp_path / "pred" / f"{recs[0]['patient_id']}_pred.nii.gz").exists()
    assert LAUNCHES == before


def test_cli_single_modal_trains_on_one_channel(root, tmp_path):
    run = tmp_path / "run"
    trainer = train.main(_common(root) + MEDNEXT + [
        "--single-modal", "--worker-mode", "process", "--loss", "dice_bce",
        "--run-dir", str(run)])
    assert trainer.model.stem.weight.shape[1] == 1 and trainer.step == 4
    assert json.loads((run / "config.json").read_text())["model"]["extra"]["in_channels"] == 1
    with pytest.raises(SystemExit, match="MicFormer"):
        train.main(_common(root) + MICFORMER + ["--single-modal", "--run-dir", str(run)])


def test_cli_pretrained_seeds_from_another_run(root, tmp_path, capsys):
    src = treg.build("micformer", device="cpu", embed_dim=6, depths=(1, 1), num_heads=(3, 6))
    CheckpointManager(tmp_path / "a").save("best_dice", {"params": src.state_dict()})
    trainer = train.main(_common(root) + MICFORMER + [
        "--pretrained", f"{tmp_path / 'a'}:best_dice", "--loss", "focal",
        "--run-dir", str(tmp_path / "b")])
    n = len(trainer.model.state_dict())
    assert f"pretrained from {tmp_path / 'a'}: {n - 2} tensors loaded, 2 skipped, 0 missing" in (
        capsys.readouterr().out)
    log = (tmp_path / "b" / "log.jsonl").read_text()
    assert json.dumps({"pretrained": {"loaded": n - 2, "skipped": 2, "missing": 0}}) in log


def test_cli_find_lr_prints_its_line(root, tmp_path, capsys, monkeypatch):
    """JAX's default sweep is 100 iterations, as the port's; the CLI run
    sweeps 4 to keep the test short."""
    for fn in (JTrainer.find_lr, Trainer.find_lr):
        assert inspect.signature(fn).parameters["num_iters"].default == 100
    monkeypatch.setattr(Trainer, "find_lr", functools.partialmethod(Trainer.find_lr,
                                                                    num_iters=4))
    trainer = train.main(_common(root) + MICFORMER + ["--find-lr", "--run-dir",
                                                      str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert "find_lr: 4 points swept; min smoothed loss at lr=" in out
    assert trainer.step == 0 and trainer.history == []
    rec = json.loads((tmp_path / "run" / "log.jsonl").read_text().splitlines()[-1])
    assert len(rec["find_lr"]["lrs"]) == 4
    assert all(torch.isfinite(torch.tensor(rec["find_lr"]["losses"])))
