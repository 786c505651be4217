"""window_device_ms.infer (ms): the device's seconds a serving call of the
kernels, copies and sets launched (joined by correlation) under the
program's sliding-window spans without the model: `sw.prepare` (padding,
the weight map to the device, the accumulators), `sw.gather`, `sw.blend`,
`sw.normalize` and `serve.argmax`."""

from perfbench import spans

WINDOW = ("sw.prepare", "sw.gather", "sw.blend", "sw.normalize", "serve.argmax")


def read(ctx):
    stretch = spans.of(ctx)
    if stretch is None or ctx.stretch_calls == 0:
        return None
    if not all(stretch.named(name) for name in WINDOW):
        return None
    ops = stretch.launched_under(stretch.named(set(WINDOW)))
    if not ops:
        return None
    return 1e3 * spans.seconds(ops) / ctx.stretch_calls
