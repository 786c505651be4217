"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper adds one to its entry of `LAUNCHES` where it launches its kernel
and nowhere else, so a run can show that a path went through the kernel.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {"window_attention": 0, "window_attention_backward": 0,
                             "fused_window_attention": 0,
                             "fused_window_attention_backward": 0, "dw_conv3": 0,
                             "dw_conv3_wgrad": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
