"""Sliding-window inference."""

from micformer_tpu_torch.infer.sliding_window import sliding_window_inference  # noqa: F401
