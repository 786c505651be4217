"""kernels_per_volume.infer (kernels): device kernels launched in the traced
stretch over the volumes it served."""


def read(ctx):
    if ctx.stretch_volumes == 0 or not ctx.kernels():
        return None
    return len(ctx.kernels()) / ctx.stretch_volumes
