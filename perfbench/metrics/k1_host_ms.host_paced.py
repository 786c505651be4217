"""k1_host_ms.host_paced (ms): the host's seconds a serving call inside the
program's `k1.forward.<route>` spans (`kernels/window_attention.py`: K1's
wrapper from the route's choice to the launch) of a host-paced cell."""

import re

from perfbench import spans

K1 = re.compile(r"^k1\.forward\.")


def read(ctx):
    stretch = spans.of(ctx)
    if stretch is None or ctx.stretch_calls == 0:
        return None
    rows = stretch.named(K1)
    if not rows:
        return None
    return 1e3 * spans.seconds(rows) / ctx.stretch_calls
