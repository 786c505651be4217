"""loop_idle_ms.train (ms): the device's idle seconds a training step in the
traced stretch that fall outside the program's `train.forward` and
`train.backward` spans (`train/trainer.py`): the idle time the train loop's
other phases leave (prep, augmentation, the read-back, the optimizer, the
schedule, the closing wait) and the time between steps."""

from perfbench import spans


def read(ctx):
    stretch = spans.of(ctx)
    if stretch is None or ctx.stretch_steps == 0 or not stretch.device:
        return None
    forward, backward = stretch.named("train.forward"), stretch.named("train.backward")
    if not forward or not backward:
        return None
    return 1e3 * stretch.idle_outside(forward + backward) / ctx.stretch_steps
