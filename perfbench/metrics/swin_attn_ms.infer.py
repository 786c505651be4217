"""swin_attn_ms.infer (ms): the device's seconds a serving call of the
kernels, copies and sets launched (joined by correlation) under the
program's `swinunetr.swin<i>.b<b>.attn.core` spans (`models/layers.py`,
`WindowAttention3D`: the rel-pos bias lookup and `multi_head_attention`, with
the shifted blocks' region mask), whatever implements that core."""

import re

from perfbench import spans

CORE = re.compile(r"^swinunetr\.swin\d+\.b\d+\.attn\.core$")


def read(ctx):
    stretch = spans.of(ctx)
    if stretch is None or ctx.stretch_calls == 0:
        return None
    ops = stretch.launched_under(stretch.named(CORE))
    if not ops:
        return None
    return 1e3 * spans.seconds(ops) / ctx.stretch_calls
