"""device_idle.host_paced (%): the share of the traced stretch of a
host-paced serving cell's calls in which no kernel, copy or set ran on the
device."""


def read(ctx):
    if ctx.stretch_volumes == 0 or ctx.stretch_s <= 0 or not ctx.events:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.stretch_s)
