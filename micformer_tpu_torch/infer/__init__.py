"""Sliding-window inference."""

from micformer_tpu_torch.infer.sliding_window import sliding_window_inference  # noqa: F401
from micformer_tpu_torch.infer.sharded import sliding_window_inference_sharded  # noqa: F401
from micformer_tpu_torch.infer.sliding_window_2d import (  # noqa: F401
    sliding_window_inference_2d, sliding_window_inference_pseudo3d,
)
