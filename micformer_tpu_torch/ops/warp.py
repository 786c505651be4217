"""3D trilinear sampling and the spatial-transformer warp of MicFormer.

Counterpart of `micformer_tpu/ops/warp.py`. Coordinates are absolute voxel
positions [B, 3(z, y, x), ...]; sampling is trilinear with zeros padding,
through `F.grid_sample` (align_corners=False), which is the operation the
reference STN used. Sampling runs in f32 and the result takes the source's
dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def trilinear_sample(src: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample `src` [B, D, H, W, C] at voxel coords [B, 3, Do, Ho, Wo] (axis
    order z, y, x); out-of-range corners contribute zero. -> [B, Do, Ho, Wo, C]."""
    B, D, H, W, C = src.shape
    # grid_sample's grid is [B, Do, Ho, Wo, 3] ordered (x, y, z), normalised
    # so that voxel v maps to (2v + 1) / S - 1 under align_corners=False.
    sizes = (D, H, W)
    norm = [(2.0 * coords[:, i].float() + 1.0) / sizes[i] - 1.0 for i in (2, 1, 0)]
    grid = torch.stack(norm, dim=-1)
    vol = src.permute(0, 4, 1, 2, 3).float()
    out = F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)                 # [B, C, Do, Ho, Wo]
    return out.permute(0, 2, 3, 4, 1).to(src.dtype)


def stn_absolute_coords(flow: torch.Tensor, sizes) -> torch.Tensor:
    """Reference-STN flow -> absolute voxel sampling coordinates [B, 3, D, H, W].

    The reference normalises grid + flow by 2*(locs/(S-1) - 0.5) and samples
    with align_corners=False, which composes to ((grid+flow)/(S-1))*S - 0.5.
    A size-1 axis samples its only plane (the reference divides by zero)."""
    D, H, W = sizes
    axes = [torch.arange(s, dtype=flow.dtype, device=flow.device) for s in sizes]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"))[None]
    locs = grid + flow
    return torch.stack(
        [locs[:, i] / (sizes[i] - 1) * sizes[i] - 0.5 if sizes[i] > 1
         else torch.zeros_like(locs[:, i]) for i in range(3)], dim=1)


def stn_warp(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp src [B, D, H, W, C] by a voxel-unit flow [B, 3, D, H, W] with the
    reference STN's semantics."""
    B, D, H, W, C = src.shape
    return trilinear_sample(src, stn_absolute_coords(flow, (D, H, W)))


def reference_points(D: int, H: int, W: int, faithful: bool = True,
                     device=None) -> torch.Tensor:
    """MicFormer's deformable reference grid, [1, 3, D, H, W] f32 (z, y, x).

    faithful=True keeps the reference's axis mix-up in the normalisation
    (z by H, y by W, x by D); faithful=False normalises each axis by its own
    extent."""
    lin = [torch.linspace(0.5, s - 0.5, s, device=device) for s in (D, H, W)]
    gz, gy, gx = torch.meshgrid(*lin, indexing="ij")
    nz, ny, nx = (H, W, D) if faithful else (D, H, W)
    return torch.stack([gz / nz * 2 - 1, gy / ny * 2 - 1, gx / nx * 2 - 1])[None]


def inverse_stn_warp(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The reference's Re_SpatialTransformer (STN.py:35-42): warp the flow by
    itself, negate it, then warp src [B, D, H, W, C] by the result, a
    first-order estimate of the inverse deformation. flow: [B, 3, D, H, W]."""
    warped_flow = stn_warp(flow.movedim(1, -1), flow)
    return stn_warp(src, -warped_flow.movedim(-1, 1))
