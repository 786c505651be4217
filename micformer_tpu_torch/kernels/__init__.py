"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper adds one to its entry of `LAUNCHES` where it launches its kernel
and nowhere else, so a run can show that a path went through the kernel.
Importing this package registers the forward kernels as PyTorch custom ops
of the `micformer_tpu_torch` namespace (`window_attention`,
`fused_window_attention`, `biased_window_attention`, `dw_conv3`), which
loading an exported artifact needs. `CALLS` counts the forward wrappers'
calls, at trace time too, and `ATTENTION_PATHS` counts the calls of
`ops.attention.multi_head_attention` by the path it dispatched them to, on
any device: "k1" (K1, or its plain version on the CPU), "k2" (K2), "bwa"
(the biased window attention kernel) or "matmul" (the plain chain).
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {"window_attention": 0, "window_attention_backward": 0,
                             "fused_window_attention": 0,
                             "fused_window_attention_backward": 0,
                             "biased_window_attention": 0, "dw_conv3": 0,
                             "dw_conv3_wgrad": 0, "dw_transpose2_wgrad": 0}
ATTENTION_PATHS: dict[str, int] = {"k1": 0, "k2": 0, "bwa": 0, "matmul": 0}
# calls of each forward wrapper on any device, at trace time too: each call
# is one call of its op, so an exported graph holds one op node for each
CALLS: dict[str, int] = {"window_attention": 0, "fused_window_attention": 0,
                         "biased_window_attention": 0, "dw_conv3": 0}


def reset_launches() -> None:
    """Zero LAUNCHES, ATTENTION_PATHS and CALLS."""
    for counts in (LAUNCHES, ATTENTION_PATHS, CALLS):
        for name in counts:
            counts[name] = 0


# registers the custom ops (the modules read LAUNCHES above)
from micformer_tpu_torch.kernels import (  # noqa: E402,F401
    biased_window_attention, dw_conv3, fused_window_attention, window_attention,
)
