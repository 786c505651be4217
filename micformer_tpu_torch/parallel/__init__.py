"""Parallelism on torch.distributed: process-group start-up, the mesh and
data-parallel helpers, spatial (halo-exchange) sharding and tensor
parallelism. The tensor-parallel names load on first use (`parallel/tensor.py`
imports the model zoo's layers)."""

from micformer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, global_dice_sums, is_primary, make_mesh, rank_rows, shard_cases, zero1,
)

_TENSOR = ("shard_tensor_parallel", "tensor_parallel_apply", "tensor_parallel_plan")
__all__ = ["Mesh", "global_dice_sums", "is_primary", "make_mesh", "rank_rows", "shard_cases",
           "zero1", "shard_tensor_parallel", "tensor_parallel_apply", "tensor_parallel_plan"]


def __getattr__(name):
    if name in _TENSOR:
        from micformer_tpu_torch.parallel import tensor

        return getattr(tensor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
