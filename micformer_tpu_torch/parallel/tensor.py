"""Tensor (model) parallelism: the Megatron split of attention heads and MLP
features over the ranks of a torch.distributed group.

Counterpart of `micformer_tpu/parallel/tensor.py`. JAX annotates the
weights with shardings and lets GSPMD insert the collectives; here each
rank holds its slices and runs its own heads, with one explicit all-reduce
after each row-parallel layer:
  - column-parallel: the qkv, q and kv projections and the MLP's first
    layer, weights and biases (output features: heads x head_dim, or the
    MLP's hidden features);
  - row-parallel: `proj` and the MLP's second layer (input features); their
    bias is replicated and added once, after the reduce;
  - everything else is replicated.
JAX's rule splits a kernel wherever its axis divides by the world size.
The port runs whole heads on each rank, so it is stricter: an attention
module splits when its head count divides by the world size and its
projections split together (qkv, or q and kv, with proj); an MLP splits
when its hidden width divides. Where JAX would split and the port keeps
the module whole (MicFormer's 3-head stage at W = 2; nnFormer's skip-K/V
block and TransUNet's gates, whose queries come from no q projection), the
plan says replicated. A relative-position bias table stays replicated and a
split module gathers its heads' columns (`bias_heads`).

Forward only, as the JAX function is: nothing trains or predicts through it.
"""

from __future__ import annotations

import contextvars
import copy

import torch
import torch.nn as nn
import torch.nn.functional as F

from micformer_tpu_torch.models.layers import Mlp
from micformer_tpu_torch.parallel.mesh import all_reduce_sum

COLUMN, ROW, REPLICATED = "column", "row", "replicated"
# an attention module's input projections and the head-major blocks
# (q, k, v thirds; kv halves) each one's output features hold
_PROJECTIONS = {"qkv": 3, "q": 1, "kv": 2}

# the group that row-parallel layers reduce over, inside tensor_parallel_apply
_GROUP = contextvars.ContextVar("tensor_parallel_group", default=None)


def _attention_parts(mod: nn.Module):
    """The input projections of an attention module that can run a subset
    of its heads, ("qkv",) or ("q", "kv") beside a `proj`; None otherwise."""
    if not (hasattr(mod, "num_heads") and isinstance(getattr(mod, "proj", None), nn.Linear)):
        return None
    if isinstance(getattr(mod, "qkv", None), nn.Linear):
        return ("qkv",)
    if all(isinstance(getattr(mod, p, None), nn.Linear) for p in ("q", "kv")):
        return ("q", "kv")
    return None


def _candidates(model: nn.Module):
    """(name, module, parts) of every attention module ((projection names))
    and MLP (None) of `model`, in module order."""
    for name, mod in model.named_modules():
        if isinstance(mod, Mlp):
            yield name, mod, None
        elif (parts := _attention_parts(mod)) is not None:
            yield name, mod, parts


def _splits(mod: nn.Module, parts, world: int) -> bool:
    if parts is None:
        return mod.fc1.out_features % world == 0
    return mod.num_heads % world == 0


def tensor_parallel_plan(model: nn.Module, world: int) -> dict[str, str]:
    """Parameter name -> COLUMN, ROW or REPLICATED for `world` ranks."""
    plan = {name: REPLICATED for name, _ in model.named_parameters()}
    for name, mod, parts in _candidates(model):
        if not _splits(mod, parts, world):
            continue
        pre = f"{name}." if name else ""
        cols, row = (("fc1",), "fc2") if parts is None else (parts, "proj")
        for c in cols:
            for p, _ in getattr(mod, c).named_parameters():
                plan[f"{pre}{c}.{p}"] = COLUMN
        plan[f"{pre}{row}.weight"] = ROW
    return plan


def replicated_modules(model: nn.Module, world: int) -> list[str]:
    """The attention modules and MLPs that stay whole at `world` ranks."""
    return [name for name, mod, parts in _candidates(model) if not _splits(mod, parts, world)]


class RowParallelLinear(nn.Module):
    """This rank's input columns of a Linear: x·W_rᵀ summed over the group
    (`parallel.mesh.all_reduce_sum`), then the whole bias, once."""

    def __init__(self, linear: nn.Linear, cols: slice):
        super().__init__()
        self.weight = nn.Parameter(linear.weight[:, cols].detach().clone())
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone())

    def forward(self, x):
        y = all_reduce_sum(F.linear(x, self.weight), _GROUP.get())
        return y if self.bias is None else y + self.bias


def _rows(linear: nn.Linear, rows: torch.Tensor) -> nn.Linear:
    """A Linear holding `rows` of `linear`'s output features."""
    w = linear.weight
    out = nn.Linear(linear.in_features, len(rows), bias=linear.bias is not None,
                    device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.copy_(w[rows])
        if out.bias is not None:
            out.bias.copy_(linear.bias[rows])
    return out


def _block_rows(features: int, blocks: int, part: int, parts: int) -> torch.Tensor:
    """Row indices of the `part`-th of `parts` equal pieces of each of
    `blocks` equal blocks of `features` rows."""
    size = features // blocks
    piece = size // parts
    return torch.cat([torch.arange(b * size + part * piece, b * size + (part + 1) * piece)
                      for b in range(blocks)])


def shard_tensor_parallel(model: nn.Module, rank: int, world: int) -> nn.Module:
    """A copy of `model` holding rank `rank`'s slices of every module that
    `tensor_parallel_plan` splits. A split attention module keeps the rows
    of q, of k and of v that belong to its heads [rank·h/W, (rank+1)·h/W)
    (for a fused qkv, rows out of each third, not a contiguous 1/W of the
    fused rows; for kv out of each half), runs those h/W heads, and its proj
    keeps their input columns; an MLP keeps its fc1 rows and fc2 columns."""
    model = copy.deepcopy(model)
    for _, mod, parts in list(_candidates(model)):
        if not _splits(mod, parts, world):
            continue
        if parts is None:
            n = mod.fc1.out_features // world
            mod.fc1 = _rows(mod.fc1, _block_rows(mod.fc1.out_features, 1, rank, world))
            mod.fc2 = RowParallelLinear(mod.fc2, slice(rank * n, (rank + 1) * n))
            continue
        inner = mod.proj.in_features            # heads x head_dim
        for p in parts:
            lin = getattr(mod, p)
            setattr(mod, p, _rows(lin, _block_rows(lin.out_features, _PROJECTIONS[p],
                                                   rank, world)))
        n = inner // world
        mod.proj = RowParallelLinear(mod.proj, slice(rank * n, (rank + 1) * n))
        h = mod.num_heads // world
        mod.num_heads = h
        if getattr(mod, "rel_pos_bias_table", None) is not None:
            mod.bias_heads = slice(rank * h, (rank + 1) * h)
    return model


def tensor_parallel_apply(model: nn.Module, x: torch.Tensor, group=None):
    """model(x) for a `shard_tensor_parallel` copy on each rank of `group`
    (default: the whole world): every row-parallel layer all-reduces its
    partial output, so the output is replicated."""
    token = _GROUP.set(group)
    try:
        return model(x)
    finally:
        _GROUP.reset(token)
