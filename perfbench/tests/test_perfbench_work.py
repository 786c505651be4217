"""The operation and byte counts of perfbench/work.py against hand counts."""

import json
import os

import pytest
from conftest import ROOT

from perfbench import work


def _config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_one_attention_call_by_hand():
    # 4096 windows of 8 tokens, 3 heads of 16, bf16: q, k, v and out are
    # 4096·8·3·16 = 1,572,864 elements each
    nbytes, ops = work.k1_call(4096, 3, 8, 16)
    assert nbytes == 4 * 1_572_864 * 2
    # q·kᵀ and p·v: 2 · (2·8·8·16) per window and head; softmax 3 per logit
    assert ops == 4096 * 3 * (2 * 2 * 8 * 8 * 16 + 3 * 8 * 8)
    assert work.least_seconds(nbytes, ops, work.PEAK_BF16_FLOPS) == pytest.approx(
        nbytes / 3.35e12)


def test_one_depthwise_conv_by_hand():
    # [4, 32, 128³] bf16, k 3: x read, y written, 27 weights and a bias per
    # channel; 2·27 per output voxel
    n = 4 * 32 * 128 ** 3
    nbytes, ops = work.k3_call(4, 32, 128)
    assert nbytes == (2 * n + 32 * 27 + 32) * 2 and ops == 2 * 27 * n
    assert work.k3_call(4, 32, 128, bias=False)[0] == (2 * n + 32 * 27) * 2
    nbytes, ops = work.wgrad_call(2, 32, 128)
    m = 2 * 32 * 128 ** 3
    assert nbytes == 2 * m * 2 + 32 * 28 * 4 and ops == 2 * 27 * m + m
    # bytes bound it: 0.46 ms at 3.35 TB/s against 0.14 ms of f32 operations
    assert work.least_seconds(*work.k3_call(4, 32, 128), work.PEAK_F32_CUDA_CORE_FLOPS) == (
        pytest.approx((2 * n + 32 * 28) * 2 / 3.35e12))


def test_the_forwards_launches_at_the_configs_shapes():
    mic = work.k1_calls(_config("micformer"), 4, 128)
    # 96 a forward: 8, 8, 24, 8 encoder and the same decoder launches
    assert len(mic) == 96
    assert mic[0] == (4 * 32 ** 3 // 8, 3, 8, 16) and (4 * 4 ** 3 // 8, 24, 8, 16) in mic
    assert sum(c == (4 * 8 ** 3 // 8, 12, 8, 16) for c in mic) == 6 * 4 * 2
    dw = work.k3_calls(_config("mednext_s"), 2, 128)
    # two blocks at each of 9 stages; 32 channels at 128³ down to 512 at 8³
    assert len(dw) == 18 and dw[0] == (2, 32, 128) and dw.count((2, 512, 8)) == 2


def test_model_flops_of_one_window():
    # FlopCounterMode on the reference at 1×2×128³: every matmul and conv,
    # attention and the depthwise convs included
    assert work.model_flops(_config("micformer"), 1, 128) == pytest.approx(136.63e9, rel=1e-3)
    assert work.model_flops(_config("mednext_s"), 1, 128) == pytest.approx(260.13e9, rel=1e-3)
