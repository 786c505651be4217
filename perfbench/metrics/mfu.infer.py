"""mfu.infer (%): the model FLOPs of the window's serving calls (counted on
the plain reference at each forward's batch) over the window's seconds
times the bf16 peak."""


def read(ctx):
    if ctx.window_volumes == 0 or not ctx.forwards_per_call:
        return None
    flops = sum(ctx.work.model_flops(ctx.config, b, ctx.mix["roi"]) for b in ctx.forwards_per_call)
    return 100.0 * ctx.window_calls * flops / (ctx.window_s * ctx.work.PEAK_BF16_FLOPS)
