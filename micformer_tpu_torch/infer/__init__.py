"""Sliding-window inference."""

from micformer_tpu_torch.infer.sharded import sliding_window_inference_sharded  # noqa: F401
from micformer_tpu_torch.infer.sliding_window import (  # noqa: F401
    compute_steps_monai, compute_steps_nnunet, gaussian_importance_map, sliding_window_inference,
)
from micformer_tpu_torch.infer.sliding_window_2d import (  # noqa: F401
    sliding_window_inference_2d, sliding_window_inference_pseudo3d,
)
