"""Parallelism on torch.distributed: process-group start-up, the mesh and
data-parallel helpers, and spatial (halo-exchange) sharding."""

from micformer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, global_dice_sums, is_primary, make_mesh, rank_rows, shard_cases, zero1,
)
