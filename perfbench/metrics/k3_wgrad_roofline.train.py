"""k3_wgrad_roofline.train (%): the least time of the traced training steps'
depthwise weight gradients (x and dy read, dw and db written) over the
device time of the wgrad kernels (`csrc/dw_conv3_wgrad.cu`: the tile and
volume kernels and their reduction)."""

import re

WGRAD = re.compile(r"dw_conv3_wgrad")


def read(ctx):
    seconds = sum(e.dur for e in ctx.kernels(WGRAD)) * 1e-6
    if seconds <= 0 or ctx.stretch_steps == 0:
        return None
    least = ctx.stretch_steps * ctx.work.wgrad_least_seconds(ctx.config, ctx.train_batch,
                                                             ctx.mix["side"])
    return 100.0 * least / seconds
