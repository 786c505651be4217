"""kernels_per_volume.host_paced (kernels): device kernels launched in the
traced stretch of a host-paced serving cell over the volumes it served."""


def read(ctx):
    if ctx.stretch_volumes == 0 or not ctx.kernels():
        return None
    return len(ctx.kernels()) / ctx.stretch_volumes
