"""Route choice and tile plans of the two K1 kernels (window attention and
its backward), on the CPU: `_attn_route` picks "mma" or "ffma" from the
shapes, dtype and alignment alone; `_attn_plan` gives the tile plan the C
entry points check and launch one block a tile, sized by the shared-memory
formula they use (held equal to theirs on the card). The kernels themselves
run only on the card (tests/test_torch_port_kernels.py).
"""

import itertools

import numpy as np
import pytest
import torch

from micformer_tpu_torch.kernels import LAUNCHES
from micformer_tpu_torch.kernels.window_attention import (
    ROUTE_NAMES, ROUTES, _aligned, _attn_plan, _attn_route, _attn_smem, _attn_tiles,
    _pitch_bytes, reset_routes, window_attention, window_attention_backward,
)

BF16, F32 = torch.bfloat16, torch.float32
SMS = 132    # the H100's SMs
SMEM_BLOCK = 48 * 1024
# (N, T, h, d): the four stages of a b4 serving forward and of a b1 training
# step at 128³ (window 2³, head dim 16)
SERVE = [(16384, 8, 3, 16), (2048, 8, 6, 16), (256, 8, 12, 16), (32, 8, 24, 16)]
TRAIN = [(4096, 8, 3, 16), (512, 8, 6, 16), (64, 8, 12, 16), (8, 8, 24, 16)]
# the contract beyond the path: (N, Tq, Tk, h, d)
CORNERS = [(1000, 8, 8, 3, 16), (1000, 4, 4, 4, 8), (37, 4, 4, 2, 8), (64, 16, 8, 5, 32),
           (9, 8, 16, 1, 64), (50, 4, 12, 3, 16), (300, 16, 16, 24, 64), (1, 1, 1, 1, 8),
           (7, 8, 8, 24, 64), (5000, 16, 16, 1, 8)]


@pytest.mark.parametrize("N,T,h,d", SERVE + TRAIN)
def test_route_of_the_path_is_mma_in_bf16_and_ffma_in_f32(N, T, h, d):
    assert _attn_route(T, T, d, BF16, True) == "mma"
    assert _attn_route(T, T, d, F32, True) == "ffma"


@pytest.mark.parametrize("Tq,Tk,d,dtype,aligned,route", [
    (8, 8, 16, BF16, True, "mma"), (8, 8, 32, BF16, True, "mma"),
    (8, 8, 64, BF16, True, "mma"), (8, 8, 8, BF16, True, "ffma"),
    (4, 4, 16, BF16, True, "ffma"), (16, 16, 16, BF16, True, "ffma"),
    (8, 4, 16, BF16, True, "ffma"), (4, 8, 16, BF16, True, "ffma"),
    (8, 8, 16, BF16, False, "ffma"), (8, 8, 16, F32, True, "ffma"),
    (8, 8, 64, F32, True, "ffma"), (1, 16, 8, F32, False, "ffma"),
])
def test_route_corners(Tq, Tk, d, dtype, aligned, route):
    """mma only for bf16 with Tq = Tk = 8, d a multiple of 16 and aligned
    rows; T 4/16, Tq != Tk, d 8, f32 and misaligned rows take ffma."""
    assert _attn_route(Tq, Tk, d, dtype, aligned) == route


@pytest.mark.parametrize("Tq,Tk,d,dtype", [(8, 8, 16, torch.float16), (17, 8, 16, BF16),
                                           (8, 0, 16, BF16), (8, 8, 24, F32)])
def test_route_refuses_what_no_kernel_takes(Tq, Tk, d, dtype):
    with pytest.raises(ValueError):
        _attn_route(Tq, Tk, d, dtype, True)


def _check_plan(N, Tq, Tk, h, d, dtype, route, backward):
    W, Hg, warps = _attn_plan(N, Tq, Tk, h, d, dtype, route, backward, SMS)
    tiles = _attn_tiles(N, h, W, Hg)
    assert W >= 1 and h % Hg == 0 and 1 <= warps <= 4
    assert tiles == -(-N // W) * (h // Hg)
    assert _attn_smem(W, Hg, Tq, Tk, d, dtype, route, backward, warps) <= SMEM_BLOCK
    assert route != "mma" or W * Hg * Hg < 65536      # the kernels' 16-bit pair division
    return W, Hg, warps, tiles


@pytest.mark.parametrize("backward,dtype", itertools.product((False, True), (BF16, F32)))
def test_plans_fill_the_card_at_every_stage(backward, dtype):
    """Every stage of both paths gives a grid of at least 132 blocks, one a
    tile (the deep stages by cutting the tile to one window and then to fewer
    heads), within 48 KB of shared memory a block; a card with fewer SMs gets
    tiles at least as large."""
    for N, T, h, d in SERVE + TRAIN:
        route = _attn_route(T, T, d, dtype, True)
        W, Hg, warps, tiles = _check_plan(N, T, T, h, d, dtype, route, backward)
        assert tiles >= SMS, (N, h, W, Hg, tiles)
        if N < 2 * SMS:
            assert W == 1
        W2, Hg2, _ = _attn_plan(N, T, T, h, d, dtype, route, backward, 66)
        assert W2 * Hg2 >= W * Hg and _attn_tiles(N, h, W2, Hg2) >= min(66, tiles)


@pytest.mark.parametrize("backward", (False, True))
def test_plans_of_the_deep_stages_split_heads(backward):
    """Stage 3 ([32 or 8 windows, 24 heads]) and the training step's stage 2
    take fewer heads a tile; stage 0 takes all heads."""
    assert _attn_plan(8, 8, 8, 24, 16, BF16, "mma", backward, SMS)[:2] == (1, 1)
    assert _attn_plan(32, 8, 8, 24, 16, BF16, "mma", backward, SMS)[:2] == (1, 4)
    assert _attn_plan(64, 8, 8, 12, 16, BF16, "mma", backward, SMS)[:2] == (1, 4)
    assert _attn_plan(16384, 8, 8, 3, 16, BF16, "mma", backward, SMS)[1] == 3


def test_stage_zero_plans():
    """One tile a block of about twelve (window, head) pairs in the forward
    and six in the backward: stage 0 of the serving forward takes 4 windows
    of 3 heads (4 warps), of the training backward 2 windows (3 warps);
    stage 1 of the forward 2 windows of 6 heads. A forward tile of 2 windows
    stages 2 x 24 rows at a 112-byte pitch."""
    assert _attn_plan(16384, 8, 8, 3, 16, BF16, "mma", False, SMS) == (4, 3, 4)
    assert _attn_tiles(16384, 3, 4, 3) == 4096
    assert _attn_plan(4096, 8, 8, 3, 16, BF16, "mma", True, SMS) == (2, 3, 3)
    assert _attn_tiles(4096, 3, 2, 3) == 2048
    assert _attn_plan(2048, 8, 8, 6, 16, BF16, "mma", False, SMS) == (2, 6, 4)
    assert _attn_tiles(2048, 6, 2, 6) == 1024
    assert _attn_smem(2, 3, 8, 8, 16, BF16, "mma", False, 3) == 5376
    assert _attn_smem(2, 3, 8, 8, 16, BF16, "mma", True, 3) == 2 * 32 * 112 + 3 * 1024


@pytest.mark.parametrize("N,Tq,Tk,h,d", CORNERS)
def test_plans_of_the_contract_corners(N, Tq, Tk, h, d):
    for dtype, backward, aligned in itertools.product((BF16, F32), (False, True),
                                                      (False, True)):
        route = _attn_route(Tq, Tk, d, dtype, aligned)
        _check_plan(N, Tq, Tk, h, d, dtype, route, backward)


@pytest.mark.parametrize("Hg,d,es,pitch", [(3, 16, 2, 112), (6, 16, 2, 208), (12, 16, 2, 400),
                                           (24, 16, 2, 784), (1, 8, 2, 16), (1, 16, 2, 48),
                                           (3, 16, 4, 208), (1, 64, 4, 272)])
def test_pitch_is_an_odd_count_of_16_bytes(Hg, d, es, pitch):
    """Eight staged rows fall on eight different 16-byte bank groups."""
    assert _pitch_bytes(Hg, d, es) == pitch
    assert len({(r * pitch // 16) % 8 for r in range(8)}) == 8


def test_plan_refuses_an_unknown_route():
    with pytest.raises(ValueError):
        _attn_plan(64, 8, 8, 3, 16, BF16, "wgmma", False, SMS)


def test_aligned_looks_at_every_address_and_stride():
    base = torch.zeros(4, 8, 3 * 48)
    q, k, v = (t.view(4, 8, 3, 16) for t in base.chunk(3, dim=-1))
    assert _aligned(q, k, v)
    odd = torch.zeros(4 * 8 * 48 + 1)[1:].view(4, 8, 3, 16)
    assert not _aligned(q, odd)
    assert not _aligned(torch.zeros(4, 8, 3, 5)[..., :4])     # head stride of 20 bytes


def test_cpu_calls_count_no_launch_and_no_route():
    """On the CPU both functions compute the plain versions: no launch and
    no route is counted."""
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(6, 8, 3, 16)).astype(np.float32))
                  for _ in range(4))
    reset_routes()
    before = dict(LAUNCHES)
    window_attention(q, k, v)
    window_attention_backward(q, k, v, g)
    assert dict(LAUNCHES) == before
    assert ROUTES == {name: dict.fromkeys(ROUTE_NAMES, 0)
                      for name in ("window_attention", "window_attention_backward",
                                   "fused_window_attention",
                                   "fused_window_attention_backward")}
