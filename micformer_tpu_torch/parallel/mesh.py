"""Data parallelism helpers: the mesh, rank rows, case sharding, the
differentiable global sums, and ZeRO-1.

Counterpart of `micformer_tpu/parallel/mesh.py`. JAX lays a ('data',
'space') mesh over devices and lets GSPMD place arrays; here each rank is a
process of a `torch.distributed` group (`parallel/distributed.py`), so:
  - `make_mesh` parses "data=N[,space=M]" and checks N·M against the world
    size; a rank's coordinates follow from its rank (data-major);
  - `shard_batch` and `replicate` place a batch over the 'data' axis or
    copy a tree to every device. A rank holds only its own rows, so their
    counterpart is `rank_rows`, the rows [r·b/W, (r+1)·b/W) of a global
    batch that `device_put` with P("data") gives device r; replication needs
    nothing (every rank builds the same weights from the seed, and
    DistributedDataParallel broadcasts rank 0's at wrap time).
    `spatial_sharding` (D over 'space') is, likewise, the rank's slab in
    `parallel/spatial.py`;
  - `global_dice_sums` all-reduces the Dice partial sums, differentiably;
  - `zero1` wraps the trainer's optimizer in `ZeroRedundancyOptimizer`,
    the counterpart of `zero1_shardings`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from micformer_tpu_torch.parallel.distributed import world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'space') grid over the ranks of the group, data-major."""
    data: int = 1
    space: int = 1
    rank: int = 0

    @property
    def data_index(self) -> int:
        return self.rank // self.space


def parse_mesh(spec: str) -> dict:
    """"data=N[,space=M]" -> {"data": N, "space": M}; refuses other axes."""
    out = {}
    for part in str(spec).split(","):
        key, sep, val = part.partition("=")
        key = key.strip()
        if not sep or key not in ("data", "space") or key in out:
            raise ValueError(f"mesh {spec!r}: want 'data=N[,space=M]'")
        out[key] = int(val)
        if out[key] < 1:
            raise ValueError(f"mesh {spec!r}: axis sizes must be positive")
    return out


def make_mesh(spec: str | None = None, data: int | None = None, space: int = 1) -> Mesh:
    """The mesh of `spec` ("data=N[,space=M]") or of the axis sizes, over
    this process group; `data` defaults to world // space. Raises when the
    mesh does not cover the world size."""
    if spec is not None:
        axes = parse_mesh(spec)
        data, space = axes.get("data"), axes.get("space", 1)
    rank, size = world()
    if data is None:
        data = size // space
    if data * space != size:
        raise ValueError(f"mesh data={data} x space={space} != world size {size}")
    return Mesh(data, space, rank)


def is_primary() -> bool:
    """The rank-0 guard: true in a single process."""
    return world()[0] == 0


def shard_cases(keys, rank: int | None = None, world_size: int | None = None) -> list:
    """Round-robin case sharding, keys[rank::world] (nnU-Net DDP's
    validation keys); this process's rank and world size by default."""
    r, w = world()
    r = r if rank is None else rank
    w = w if world_size is None else world_size
    return list(keys)[r::w]


def rank_rows(batch: int, rank: int, world_size: int) -> slice:
    """The rows of a global batch of `batch` that rank `rank` of
    `world_size` holds: [r·b/W, (r+1)·b/W). Raises when W does not divide b."""
    if batch % world_size:
        raise ValueError(f"a batch of {batch} does not split over {world_size} ranks")
    per = batch // world_size
    return slice(rank * per, (rank + 1) * per)


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks, whose backward sums the gradient over the ranks.

    torch.distributed.nn.functional.all_reduce computes the same, but its
    default `group=group.WORLD` is bound when that module is first imported:
    imported once a group exists, it holds the group past
    destroy_process_group, until the interpreter tears down, where gloo's
    group can end the process with SIGABRT and leave its FileStore file."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the group's ranks of x, differentiable: the backward sums the
    incoming gradient over the ranks too."""
    return _AllReduceSum.apply(x, group)


class _AllGather(torch.autograd.Function):
    """all_gather along a new leading axis, differentiable on any backend:
    the backward sums the gradient over the ranks (an all_reduce) and keeps
    this rank's slot (gloo has no reduce_scatter or all_to_all)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)], None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """[W, *x.shape]: every rank's x, in rank order, differentiable."""
    return _AllGather.apply(x, group)


def global_dice_sums(probs, targets, group=None):
    """Differentiable Dice sums over the global batch: the per-rank
    intersections and squared denominators [C] (reduced over batch and
    space), summed over the group."""
    axes = (0,) + tuple(range(2, probs.dim()))
    inter = all_reduce_sum((probs * targets).sum(axes), group)
    psum = all_reduce_sum((probs * probs).sum(axes), group)
    tsum = all_reduce_sum((targets * targets).sum(axes), group)
    return inter, psum, tsum


def zero1(params, optimizer_class, **defaults):
    """ZeRO-1: `optimizer_class(params, **defaults)` with its state split
    over the ranks (torch's ZeroRedundancyOptimizer): each rank updates its
    share of the parameters and broadcasts them."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(list(params), optimizer_class=optimizer_class, **defaults)
