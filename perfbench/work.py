"""The yardstick's arithmetic: the chip's peaks, model FLOPs counted on the
plain reference, and the operations and bytes of the hand-written kernels'
calls worked out from a configuration's shapes.

The bound arithmetic is `chip_smoke.py`'s (`bound`, `dw_bound` and the
per-call counts beside them): a call's least time is the larger of its
bytes over the memory rate and its operations over the peak rate. Bytes
count each input read once and each output written once.
"""

from __future__ import annotations

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import build_reference

# NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores, f32 on the CUDA
# cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_CUDA_CORE_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def model_flops(config: dict, batch: int, roi: int, train: bool = False) -> float:
    """FLOPs of one forward (train: forward, loss and backward) of the
    reference model of `config` on [batch, 2, roi³], counted by
    FlopCounterMode on the meta device: the count follows from the shapes,
    whatever implements the work."""
    model = build_reference(config, device="meta")
    x = torch.empty((batch, 2, roi, roi, roi), device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            model.train()
            out = model(x)
            out.float().square().mean().backward()
        else:
            with torch.no_grad():
                model(x)
    return float(counter.get_total_flops())


def _reference_calls(config: dict, batch: int, roi: int, targets, record) -> list[tuple]:
    """`record(module, inputs, output)` of each call, in call order, of the
    modules `targets(model)` picks in one forward of the reference model of
    `config` on [batch, 2, roi³], run on the meta device: the shapes the
    configuration gives, read where the model makes them."""
    key = (targets.__qualname__, json.dumps(config["kwargs"], sort_keys=True), batch, roi)
    if key not in _CALLS:
        model = build_reference(config, device="meta")
        calls = []
        for module in targets(model):
            module.register_forward_hook(lambda m, a, o: calls.append(record(m, a, o)))
        with torch.no_grad():
            model(torch.empty((batch, 2, roi, roi, roi), device="meta"))
        _CALLS[key] = calls
    return _CALLS[key]


_CALLS: dict = {}      # _reference_calls' readings, by model, batch and roi


def least_seconds(nbytes: float, ops: float, peak_ops: float) -> float:
    """The least time a call can take: bytes at the memory rate or
    operations at `peak_ops`, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_ops)


# -- K1: window attention ------------------------------------------------------

def k1_call(N: int, h: int, T: int, d: int, elem: int = BF16_BYTES) -> tuple[float, float]:
    """(bytes, operations) of one K1 call on N windows of T tokens, h heads
    of size d: q, k and v read, the output written; q·kᵀ and p·v (2·T·T·d
    multiply-adds each) and the softmax (3 per logit)."""
    nbytes = 4 * N * T * h * d * elem
    ops = 4 * N * h * T * T * d + 3 * N * h * T * T
    return float(nbytes), float(ops)


def k1_calls(config: dict, batch: int, roi: int) -> list[tuple]:
    """(N, h, T, d) of every window attention of one MicFormer forward on
    [batch, 2, roi³]: each attention module's input, N windows of T tokens,
    and its h heads of size d."""
    from perfbench.reference.micformer import Attention

    def attentions(model):
        return [m for m in model.modules() if isinstance(m, Attention)]

    def record(m, args, out):
        N, T, C = args[0].shape
        return (N, m.heads, T, C // m.heads)

    return _reference_calls(config, batch, roi, attentions, record)


def k1_least_seconds(config: dict, batch: int, roi: int) -> float:
    """Least time of one forward's K1 calls, at the bf16 tensor-core peak."""
    return sum(least_seconds(*k1_call(*c), PEAK_BF16_FLOPS)
               for c in k1_calls(config, batch, roi))


# -- K3: stride-1 depthwise conv, its dx and its weight gradient ---------------

def k3_calls(config: dict, batch: int, roi: int) -> list[tuple[int, int, int]]:
    """(batch, C, side) of every stride-1 depthwise conv of one MedNeXt
    forward on [batch, 2, roi³]: the output of the depthwise conv of each
    block that keeps its extent (the down blocks' stride-2 and the up
    blocks' transposed depthwise convs are cuDNN's, not K3's)."""
    from perfbench.reference.mednext import Block

    def depthwise(model):
        return [m.dw for m in model.modules() if isinstance(m, Block) and m.mode == "same"]

    def record(m, args, out):
        return (out.shape[0], out.shape[1], out.shape[2])

    return _reference_calls(config, batch, roi, depthwise, record)


def k3_call(B: int, C: int, side: int, k: int = 3, elem: int = BF16_BYTES,
            bias: bool = True) -> tuple[float, float]:
    """(bytes, operations) of one K3 call on [B, C, side³]: x read and y
    written, the weights (and the bias) read; 2·k³ per output. dx is the
    same call on the flipped kernel, without the bias."""
    n = B * C * side ** 3
    return float((2 * n + C * k ** 3 + C * bias) * elem), float(2 * k ** 3 * n)


def wgrad_call(B: int, C: int, side: int, k: int = 3,
               elem: int = BF16_BYTES) -> tuple[float, float]:
    """(bytes, operations) of one weight-gradient call: x and dy read, dw
    and db written in f32; 2·k³ per voxel for dw and one for db."""
    n = B * C * side ** 3
    return float(2 * n * elem + C * (k ** 3 + 1) * 4), float(2 * k ** 3 * n + n)


def k3_least_seconds(config: dict, batch: int, roi: int, dx: bool = False) -> float:
    """Least time of one forward's K3 calls (dx: and the backward's dx
    calls), at the f32 CUDA-core peak: a depthwise conv has no reduction
    over channels for the tensor cores."""
    k = config["kwargs"]["kernel"]
    total = 0.0
    for B, C, side in k3_calls(config, batch, roi):
        total += least_seconds(*k3_call(B, C, side, k), PEAK_F32_CUDA_CORE_FLOPS)
        if dx:
            total += least_seconds(*k3_call(B, C, side, k, bias=False),
                                   PEAK_F32_CUDA_CORE_FLOPS)
    return total


def wgrad_least_seconds(config: dict, batch: int, roi: int) -> float:
    """Least time of one training step's weight-gradient calls."""
    k = config["kwargs"]["kernel"]
    return sum(least_seconds(*wgrad_call(B, C, side, k), PEAK_F32_CUDA_CORE_FLOPS)
               for B, C, side in k3_calls(config, batch, roi))
