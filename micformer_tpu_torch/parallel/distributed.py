"""Process-group start-up: `torch.distributed.init_process_group` per rank.

Counterpart of `micformer_tpu/parallel/distributed.py`, whose
`jax.distributed.initialize` joins the host processes of a pod. Here each
rank is a process, started by `torchrun` (or any launcher that sets its
variables), and `initialize` joins it to the group:
  - `env://` as torchrun sets it: RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT;
  - else the JAX package's variables: COORDINATOR_ADDRESS (host:port, where
    rank 0 listens), NUM_PROCESSES and PROCESS_ID;
  - else an explicit `init_method` (a `file://` store in the tests), with
    its world size and rank;
  - else nothing: one process, world size 1, no group.
It is idempotent: a second call returns the rank's device and joins nothing.

Each rank's device is `cuda:{LOCAL_RANK % device_count}`, so `--device cuda`
keeps its meaning under torchrun. The backend follows one rule, and the
choice is printed: `nccl` when the device is a card and every rank of the
host has one of its own (LOCAL_WORLD_SIZE <= device_count); `gloo` on the
CPU, or when ranks share a card (NCCL refuses two ranks on one device).
Nothing retries on another backend after a failure.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

from micformer_tpu_torch.registry import resolve_device

# long enough for a rank that builds the kernels or saves a checkpoint while
# the others wait at a collective
TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(*names, default=None):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return default


def rank_device(device) -> torch.device:
    """The device of this rank: `cuda` becomes cuda:{LOCAL_RANK % count}
    (LOCAL_RANK, else the rank, else 0); any other device is returned as is."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = _env_int("LOCAL_RANK", default=dist.get_rank() if dist.is_initialized() else 0)
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def choose_backend(device, local_world_size: int) -> tuple[str, str]:
    """(backend, reason) by the rule of the module docstring."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", f"device {dev.type}"
    count = torch.cuda.device_count()
    if local_world_size > count:
        return "gloo", f"{local_world_size} ranks share {count} card(s)"
    return "nccl", f"{local_world_size} ranks, {count} card(s): one card a rank"


def initialize(device="cuda", init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None) -> torch.device:
    """Join this process to the group (see the module docstring) and return
    its device. `device` is the device the caller asked for ("cuda", the
    default, or "cpu"); CUDA asked for where there is none raises before
    anything is joined; on a card the rank's device becomes the current
    one."""
    resolve_device(device)
    if not dist.is_initialized():
        env = os.environ
        local_world = None
        if init_method is None and env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
            init_method = "env://"
            world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
            local_world = _env_int("LOCAL_WORLD_SIZE")
        elif init_method is None and env.get("COORDINATOR_ADDRESS"):
            init_method = f"tcp://{env['COORDINATOR_ADDRESS']}"
            world_size = _env_int("NUM_PROCESSES", default=1)
            rank = _env_int("PROCESS_ID", default=0)
        if init_method is not None:
            if world_size is None or rank is None:
                raise ValueError(f"init_method {init_method!r} needs world_size and rank")
            local_world = local_world or world_size
            dev = torch.device(device)
            backend, why = choose_backend(dev, local_world)
            if dev.type == "cuda":
                local = _env_int("LOCAL_RANK", default=rank)
                torch.cuda.set_device(local % torch.cuda.device_count())
            dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                    rank=rank, timeout=TIMEOUT)
            print(f"distributed: rank {rank} of {world_size}, backend {backend} ({why})",
                  flush=True)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier():
    """Wait for every rank; nothing without a group."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown(wait: bool = True):
    """Leave the group, if there is one.

    wait: first meet every rank at a barrier, so that every rank is done
    with the group and its store before any rank tears its own down. A rank
    leaving on an error passes False: peers that never reach the barrier
    would hold it up for TIMEOUT. The group is freed only when nothing else
    holds it (see `parallel/mesh.py`'s all-reduce)."""
    if dist.is_initialized():
        if wait:
            barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def joined(device="cuda", **kwargs):
    """`initialize(device, **kwargs)` for the body of a with statement,
    which gets the rank's device. A group that this call joined is left on
    the way out: after the barrier when the body ends, without it when the
    body raises. A group joined before is kept, for its owner to leave."""
    owner = not dist.is_initialized()
    dev = initialize(device, **kwargs)
    owner = owner and dist.is_initialized()
    try:
        yield dev
    except BaseException:
        if owner:
            shutdown(wait=False)
        raise
    if owner:
        shutdown()
