"""k3_roofline.infer (%): the least time of the traced serving calls'
stride-1 3³ depthwise convs (shapes from the config; bytes at the memory
rate, operations at the f32 CUDA-core peak) over the device time of K3's
kernels (`csrc/dw_conv3.cu`: `dw_conv3_tile_kernel`,
`dw_conv3_volume_kernel`)."""

import re

K3 = re.compile(r"dw_conv3_(tile|volume)_kernel")


def read(ctx):
    seconds = sum(e.dur for e in ctx.kernels(K3)) * 1e-6
    if seconds <= 0 or ctx.stretch_calls == 0:
        return None
    least = ctx.stretch_calls * sum(ctx.work.k3_least_seconds(ctx.config, b, ctx.mix["roi"])
                                    for b in ctx.forwards_per_call)
    return 100.0 * least / seconds
