"""k1_roofline.infer (%): the least time of the traced serving calls' window
attentions (shapes from the config; bytes at the memory rate, operations at
the bf16 peak) over the device time of K1's kernel
(`csrc/window_attention.cu`, `window_attention_kernel`)."""

import re

K1 = re.compile(r"(?<!fused_)window_attention_kernel")


def read(ctx):
    seconds = sum(e.dur for e in ctx.kernels(K1)) * 1e-6
    if seconds <= 0 or ctx.stretch_calls == 0:
        return None
    least = ctx.stretch_calls * sum(ctx.work.k1_least_seconds(ctx.config, b, ctx.mix["roi"])
                                    for b in ctx.forwards_per_call)
    return 100.0 * least / seconds
