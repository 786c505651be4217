"""k3_roofline.train (%): the least time of the traced training steps'
stride-1 3³ depthwise convs and their dx (K3 on the flipped kernel) over
the device time of K3's kernels (`csrc/dw_conv3.cu`)."""

import re

K3 = re.compile(r"dw_conv3_(tile|volume)_kernel")


def read(ctx):
    seconds = sum(e.dur for e in ctx.kernels(K3)) * 1e-6
    if seconds <= 0 or ctx.stretch_steps == 0:
        return None
    least = ctx.stretch_steps * ctx.work.k3_least_seconds(ctx.config, ctx.train_batch,
                                                          ctx.mix["side"], dx=True)
    return 100.0 * least / seconds
