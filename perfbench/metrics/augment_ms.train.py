"""augment_ms.train (ms): the device's seconds a training step of the
kernels, copies and sets launched (joined by correlation) under the
program's `train.augment` span (`train/trainer.py`: the batched monai
augmentation on the device)."""

from perfbench import spans


def read(ctx):
    stretch = spans.of(ctx)
    if stretch is None or ctx.stretch_steps == 0:
        return None
    rows = stretch.named("train.augment")
    if not rows:
        return None
    ops = stretch.launched_under(rows)
    if not ops:
        return None
    return 1e3 * spans.seconds(ops) / ctx.stretch_steps
