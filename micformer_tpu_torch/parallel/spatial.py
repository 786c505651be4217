"""Spatial (single-forward) model parallelism: one GenericUNet forward with
the depth axis D slabbed over the ranks.

Counterpart of `micformer_tpu/parallel/spatial.py`. Rank r holds the r-th
of W equal slabs of D and runs the model's own modules on it:
  - each conv first takes its D halo from the neighbouring slabs
    (`halo_exchange`, the edge ranks getting zeros, which is the SAME conv's
    zero padding) and pads H and W as the model does; the halo split is
    `_same_pads`: a stride-2 k3 conv takes (0, 1), not (1, 1);
  - InstanceNorm uses the global statistics: the per-slab sums and sums of
    squares are all-reduced;
  - strided convs, the k = s transposed convs and the 1³ head stay local,
    which holds when every slab's D is a multiple of the cumulative z-stride
    (a depth that is not is refused);
and the slabs' logits are gathered, so every rank returns the whole
volume's, equal to the single forward up to the order of the sums. It is
the exact model, not an overlap-blend of tiles (`infer/sharded.py`).

The halos move on `all_gather` of the edge planes rather than on
send/recv, so it runs on any backend (gloo has no CUDA send/recv).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from micformer_tpu_torch.models.layers import same_pads


def _group_rank(group):
    if dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def _gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's x, in rank order (x alone without a group)."""
    _, n = _group_rank(group)
    if n == 1:
        return [x]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


def halo_exchange(x: torch.Tensor, lo: int, hi: int, group=None) -> torch.Tensor:
    """x [B, C, D, H, W] padded along D with the neighbours' planes: rank i
    gets the last `lo` planes of rank i - 1 before its own and the first
    `hi` planes of rank i + 1 after them; the first and last ranks get
    zeros."""
    rank, n = _group_rank(group)
    parts = []
    if lo:
        left = _gather(x[:, :, -lo:], group)
        parts.append(left[rank - 1] if rank > 0 else torch.zeros_like(left[0]))
    parts.append(x)
    if hi:
        right = _gather(x[:, :, :hi], group)
        parts.append(right[rank + 1] if rank < n - 1 else torch.zeros_like(right[0]))
    return torch.cat(parts, dim=2) if len(parts) > 1 else x


def _same_pads(k: int, s: int) -> tuple[int, int]:
    """The SAME padding split of an extent the stride divides:
    total max(k - s, 0), the lower half first."""
    total = max(k - s, 0)
    return total // 2, total - total // 2


def _spatial_conv(conv, x, group):
    """SAME conv whose D padding is the neighbours' halo."""
    lo, hi = _same_pads(conv.kernel_size[0], conv.stride[0])
    x = halo_exchange(x, lo, hi, group)
    pads = []
    for n, k, s in reversed(list(zip(x.shape[3:], conv.kernel_size[1:], conv.stride[1:]))):
        pads += same_pads(n, k, s)
    return conv(F.pad(x, pads) if any(pads) else x)


def _spatial_instance_norm(norm, x, group):
    """InstanceNorm with the global statistics: the slabs' sums and sums
    of squares all-reduced (every slab holds as many voxels)."""
    _, n_ranks = _group_rank(group)
    dims = (2, 3, 4)
    xf = x.float()
    stats = torch.stack([xf.sum(dims), xf.square().sum(dims)])     # [2, B, C]
    if n_ranks > 1:
        dist.all_reduce(stats, group=group)
    n = math.prod(x.shape[2:]) * n_ranks
    mean = stats[0] / n
    var = (stats[1] / n - mean.square()).clamp_min(0.0)
    shape = mean.shape + (1, 1, 1)
    scale = torch.rsqrt(var + norm.eps).view(shape) * norm.weight.float().view(1, -1, 1, 1, 1)
    shift = norm.bias.float().view(1, -1, 1, 1, 1) - mean.view(shape) * scale
    return torch.addcmul(shift, xf, scale).to(x.dtype)


def _block(blk, x, group):
    x = _spatial_conv(blk.conv, x, group)
    return F.leaky_relu(_spatial_instance_norm(blk.norm, x, group), 0.01)


def _local_forward(model, x, group):
    """GenericUNet's forward on this rank's slab, with the collectives."""
    n_stages = len(model.conv_kernels)
    skips = []
    for i in range(n_stages):
        for c in range(model.conv_per_stage):
            x = _block(getattr(model, f"enc{i}_conv{c}"), x, group)
        if i < n_stages - 1:
            skips.append(x)
    for j in range(n_stages - 2, -1, -1):
        x = torch.cat([getattr(model, f"up{j}")(x), skips[j]], dim=1)
        for c in range(model.conv_per_stage):
            x = _block(getattr(model, f"dec{j}_conv{c}"), x, group)
    return model.seg0(x).float()


@torch.no_grad()
def spatial_sharded_apply(model, volume: torch.Tensor, group=None) -> torch.Tensor:
    """One forward of `model` (a 3D GenericUNet without deep supervision)
    on volume [B, C, D, H, W] (the same on every rank), D slabbed over
    `group`'s ranks (default: the whole process group). D must be a
    multiple of ranks × the cumulative z-stride. Returns [B, num_classes,
    D, H, W] f32 logits on every rank."""
    if model.deep_supervision or len(model.conv_kernels[0]) != 3:
        raise ValueError("the spatial engine runs a 3D GenericUNet without deep supervision")
    rank, n = _group_rank(group)
    D = volume.shape[2]
    zstride = math.prod(p[0] for p in model.pool_kernels)
    if D % (n * zstride):
        raise ValueError(f"D={D} must divide shards({n}) x cumulative z-stride({zstride})")
    d = D // n
    out = _local_forward(model, volume[:, :, rank * d:(rank + 1) * d], group)
    return torch.cat(_gather(out, group), dim=2)
