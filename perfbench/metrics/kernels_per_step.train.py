"""kernels_per_step.train (kernels): device kernels launched in the traced
stretch over the training steps it holds."""


def read(ctx):
    if ctx.stretch_steps == 0 or not ctx.kernels():
        return None
    return len(ctx.kernels()) / ctx.stretch_steps
