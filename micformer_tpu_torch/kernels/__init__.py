"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper adds one to its entry of `LAUNCHES` where it launches its kernel
and nowhere else, so a run can show that a path went through the kernel.
`ATTENTION_PATHS` counts the calls of `ops.attention.multi_head_attention`
by the path it dispatched them to, on any device: "k1" (K1, or its plain
version on the CPU), "k2" (K2) or "matmul" (the plain chain).
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {"window_attention": 0, "window_attention_backward": 0,
                             "fused_window_attention": 0,
                             "fused_window_attention_backward": 0, "dw_conv3": 0,
                             "dw_conv3_wgrad": 0}
ATTENTION_PATHS: dict[str, int] = {"k1": 0, "k2": 0, "matmul": 0}


def reset_launches() -> None:
    """Zero LAUNCHES and ATTENTION_PATHS."""
    for counts in (LAUNCHES, ATTENTION_PATHS):
        for name in counts:
            counts[name] = 0
