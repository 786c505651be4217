"""mfu.train (%): the model FLOPs of the window's training steps (forward and
backward, counted on the plain reference at the step's batch) over the
window's seconds times the bf16 peak."""


def read(ctx):
    if ctx.window_steps == 0 or not ctx.train_batch:
        return None
    flops = ctx.work.model_flops(ctx.config, ctx.train_batch, ctx.mix["side"], train=True)
    return 100.0 * ctx.window_steps * flops / (ctx.window_s * ctx.work.PEAK_BF16_FLOPS)
