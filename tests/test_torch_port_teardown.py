"""Leaving a torch.distributed group: ranks that end cleanly, and groups
that are really freed.

A rank used to end with SIGABRT ("terminate called without an active
exception") after its work was done, and the FileStore file stayed behind:
`parallel/mesh.all_reduce_sum` called torch.distributed.nn.functional, whose
default `group=group.WORLD` is bound when that module is first imported, so
imported once a group existed it held the group past destroy_process_group,
until the interpreter tore it down. The port now has its own differentiable
all-reduce, and `distributed.shutdown` meets the ranks at a barrier first.
The ranks import no JAX (`torch_port_ranks`).
"""

import contextlib
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from micformer_tpu_torch.data.synthetic import write_synthetic_dataset
from micformer_tpu_torch.parallel import distributed
from micformer_tpu_torch.parallel.mesh import global_dice_sums

import torch_port_ranks as ranks


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_three_ranks_return_and_leave_no_store(tmp_path):
    """Every rank's result comes back with exit code 0 (run_ranks raises on
    any other), and the store file is gone: the ranks leave one at a time,
    so it goes exactly when every rank's group was freed."""
    out = ranks.run_ranks(3, tmp_path, ranks.grad_all_reduce_worker)
    for y, g in out:
        np.testing.assert_array_equal(y, np.full(3, 2.0 * (1 + 2 + 3), np.float32))
        np.testing.assert_array_equal(g, np.full(3, 2.0 * 3, np.float32))
    assert not (tmp_path / "store").exists()


@pytest.mark.parametrize("fails", [False, True], ids=["ends", "raises"])
def test_joined_frees_the_group_it_joined(tmp_path, fails):
    """A group joined by `joined` and used by the differentiable all-reduce
    is freed on the way out, after a normal end or an error: its one-rank
    FileStore deletes its file only when the group is destroyed."""
    store = tmp_path / "store"
    with pytest.raises(RuntimeError) if fails else contextlib.nullcontext():
        with distributed.joined("cpu", init_method=f"file://{store}", world_size=1, rank=0):
            probs = torch.sigmoid(torch.randn(2, 3, 4, 4, 4, requires_grad=True))
            sums = global_dice_sums(probs, torch.rand(2, 3, 4, 4, 4))
            sum(s.sum() for s in sums).backward()
            assert store.exists()
            if fails:
                raise RuntimeError("the body failed")
    assert not dist.is_initialized()
    assert not store.exists()


def test_joined_keeps_a_group_joined_before(tmp_path):
    store = tmp_path / "store"
    distributed.initialize("cpu", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        with distributed.joined("cpu"):
            pass
        assert dist.is_initialized()
    finally:
        distributed.shutdown()
    assert not dist.is_initialized() and not store.exists()


@pytest.mark.parametrize("entry", ["initialize", "joined"])
def test_bare_call_asks_for_the_card_and_joins_nothing_without_one(tmp_path, monkeypatch,
                                                                    entry):
    """With no device, initialize and joined ask for the card, as the JAX
    package's initialize() is called; without one they raise before any
    group is joined (the store a join would create never appears)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = tmp_path / "store"
    kw = dict(init_method=f"file://{store}", world_size=1, rank=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "initialize":
            distributed.initialize(**kw)
        else:
            with distributed.joined(**kw):
                pass
    assert not dist.is_initialized() and not store.exists()


def test_cli_train_rank_leaves_its_group(tmp_path):
    """cli/train.main --mesh data=2 on two spawned ranks that it joins
    itself (env://): the group is gone when main returns."""
    data = tmp_path / "data"
    write_synthetic_dataset(str(data), n_cases=6, shape=(12, 12, 12), seed=0)
    argv = ["--data", str(data), "--cache", str(tmp_path / "cache"), "--device", "cpu",
            "--model", "unet3d", "--model-kwargs", json.dumps({"channels": [2, 4]}),
            "--target-shape", "8", "--epochs", "1", "--val", "1", "--batch-size", "2",
            "--mesh", "data=2", "--run-dir", str(tmp_path / "run"), "--workers", "0"]
    out = ranks.run_cli_ranks(2, tmp_path, argv)
    assert [r["left"] for r in out] == [True, True]
    assert [r["step"] for r in out] == [2, 2]
    assert (tmp_path / "run" / "ckpt_latest.pt").exists()
