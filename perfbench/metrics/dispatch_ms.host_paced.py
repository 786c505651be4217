"""dispatch_ms.host_paced (ms): the host's seconds a serving call inside the
program's `sw.forward` spans (`infer/sliding_window.py`: the model called on
a chunk of tiles, as the host dispatches its launches) of a host-paced
cell."""

from perfbench import spans


def read(ctx):
    stretch = spans.of(ctx)
    if stretch is None or ctx.stretch_calls == 0:
        return None
    rows = stretch.named("sw.forward")
    if not rows:
        return None
    return 1e3 * spans.seconds(rows) / ctx.stretch_calls
