"""Sliding-window inference."""

from micformer_tpu_torch.infer.sliding_window import sliding_window_inference  # noqa: F401
from micformer_tpu_torch.infer.sharded import sliding_window_inference_sharded  # noqa: F401
