"""swin_attn_roofline.infer (%): the least time of the traced serving calls'
biased window-attention cores over the device seconds of what was launched
under the program's `swinunetr.swin<i>.b<b>.attn.core` spans (as
`swin_attn_ms.infer` reads them), whatever implements that core.

A core call on N windows of T tokens, h heads of size d, takes at least the
longest of: its bytes (q, k and v read and the output written in bf16, and
the [h, T, T] bias read once) at the memory rate; its matmul operations
(q·kᵀ and p·v, 2·T·T·d each per window and head) at the bf16 peak; its
exponentials (one per score) at the special-function rate. The shapes are
those of the reference model's `WindowAttention` calls in one forward at
each of a call's forward batches."""

import re

from perfbench import spans

CORE = re.compile(r"^swinunetr\.swin\d+\.b\d+\.attn\.core$")
# exponentials a second on one H100 SXM: its multi-function units' rate,
# 3.9 TFLOPS of special functions (FlashAttention-3, arXiv:2407.08608 §3)
EXP_PER_S = 3.9e12


def core_call(N: int, h: int, T: int, d: int, elem: int = 2) -> tuple[float, float, float]:
    """(bytes, matmul operations, exponentials) of one core call."""
    nbytes = 4 * N * T * h * d * elem + h * T * T * elem
    return float(nbytes), float(4 * N * h * T * T * d), float(N * h * T * T)


def _swin_cores(model):
    from perfbench.reference.swinunetr import WindowAttention

    return [m for m in model.modules() if isinstance(m, WindowAttention)]


def _shape(m, args, out):
    N, T, C = args[0].shape
    return N, m.heads, T, C // m.heads


def least_seconds(work, config: dict, batch: int, roi: int) -> float:
    """The least time of one forward's core calls on [batch, 2, roi³]."""
    total = 0.0
    for call in work._reference_calls(config, batch, roi, _swin_cores, _shape):
        nbytes, ops, exps = core_call(*call)
        total += max(nbytes / work.HBM_BYTES_PER_S, ops / work.PEAK_BF16_FLOPS,
                     exps / EXP_PER_S)
    return total


def read(ctx):
    stretch = spans.of(ctx)
    if stretch is None or ctx.stretch_calls == 0:
        return None
    seconds = spans.seconds(stretch.launched_under(stretch.named(CORE)))
    if seconds <= 0:
        return None
    least = ctx.stretch_calls * sum(least_seconds(ctx.work, ctx.config, b, ctx.mix["roi"])
                                    for b in ctx.forwards_per_call)
    return 100.0 * least / seconds
