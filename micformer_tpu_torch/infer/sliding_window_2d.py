"""2D and pseudo-3D sliding-window inference over 3D volumes.

Counterpart of `micformer_tpu/infer/sliding_window_2d.py` (nnU-Net's
`_internal_predict_3D_2Dconv_tiled` and `predict_3D_pseudo3D_2Dconv`): a 2D
network predicts a [B, C, D, H, W] volume slice by slice along D. A slice is
a (1, rh, rw) roi of the 3D tile loop (`infer/sliding_window.py`), so D is
part of the tile grid and sw_batch_size batches slices; mirror TTA flips the
in-plane axes only.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from micformer_tpu_torch.infer.sliding_window import sliding_window_inference


def _lift_2d_predictor(predictor_2d: Callable) -> Callable:
    """[b, C, 1, rh, rw] -> [b, K, 1, rh, rw] from a 2D predictor."""

    def predictor_3d(x):
        return predictor_2d(x[:, :, 0])[:, :, None]

    return predictor_3d


def sliding_window_inference_2d(volume: torch.Tensor, roi_size_2d, predictor_2d: Callable,
                                **kwargs) -> torch.Tensor:
    """Slice-by-slice 2D tiled prediction of a [B, C, D, H, W] volume.

    predictor_2d: [b, C, rh, rw] -> [b, num_classes, rh, rw]; kwargs are
    sliding_window_inference's (num_classes, overlap, blend, step_mode,
    step_size, sw_batch_size, mirror_tta). Returns [B, num_classes, D, H, W]
    f32 blended logits."""
    return sliding_window_inference(volume, (1,) + tuple(roi_size_2d),
                                    _lift_2d_predictor(predictor_2d), mirror_axes=(1, 2),
                                    **kwargs)


def sliding_window_inference_pseudo3d(volume: torch.Tensor, roi_size_2d,
                                      predictor_2d: Callable, *, pseudo3d_slices: int = 5,
                                      **kwargs) -> torch.Tensor:
    """Each slice predicted from its (2p+1)-slice neighbourhood stacked into
    channels, channel-major (every slice of channel 0, then of channel 1,
    ...), with D zero-padded by p at both ends.

    predictor_2d: [b, C·(2p+1), rh, rw] -> [b, num_classes, rh, rw]."""
    if pseudo3d_slices % 2 != 1:
        raise ValueError(f"pseudo3d_slices must be odd, not {pseudo3d_slices}")
    p = (pseudo3d_slices - 1) // 2
    B, C, D, H, W = volume.shape
    padded = F.pad(volume, (0, 0, 0, 0, p, p))
    slabs = torch.stack([padded[:, :, i:i + D] for i in range(2 * p + 1)], dim=2)
    slabs = slabs.reshape(B, C * (2 * p + 1), D, H, W)
    return sliding_window_inference_2d(slabs, roi_size_2d, predictor_2d, **kwargs)
