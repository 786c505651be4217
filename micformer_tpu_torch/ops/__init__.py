"""Tensor operations of the port: windows, attention, warp."""

from micformer_tpu_torch.ops.attention import multi_head_attention  # noqa: F401
from micformer_tpu_torch.ops.warp import stn_warp, trilinear_sample  # noqa: F401
from micformer_tpu_torch.ops.windows import (  # noqa: F401
    relative_position_index, shifted_window_mask, window_partition, window_reverse,
)
