"""Route choice, staged widths and tile plans of the two K2 kernels (fused
window attention and its backward), and the wrapper's refusals, on the CPU.
K2 runs K1's window-tile kernels through entries of its own: `_fused_route`
picks "mma" or "ffma" from the shapes, dtype and alignment alone,
`_fused_width` the compiled width a head dimension is staged in, and
`_fused_plan` the tile plan the C entries check and launch one block a tile,
sized by the shared-memory formula they use (held equal to theirs on the
card). The kernels themselves run only on the card
(tests/test_torch_port_kernels.py).
"""

import itertools

import numpy as np
import pytest
import torch

from micformer_tpu_torch.kernels import LAUNCHES
from micformer_tpu_torch.kernels.fused_window_attention import (
    MAX_D, WIDTHS, _check, _check_card, _empty_like_layout, _fused_aligned,
    _fused_plan, _fused_route, _fused_smem, _fused_width, fused_window_attention,
    fused_window_attention_backward, should_use_fused,
)
from micformer_tpu_torch.kernels.window_attention import (
    ROUTE_NAMES, ROUTES, _attn_plan, _attn_smem, _attn_tiles, reset_routes,
)

BF16, F32 = torch.bfloat16, torch.float32
SMS = 132    # the H100's SMs
SMEM_BLOCK = 48 * 1024
SMEM_OPT_IN = 232448    # the most a block may opt in to on the H100 (227 KB)
TOKENS = (1, 2, 4, 8, 16, 32)     # T <= 32 with 128 % T == 0
# (N, h, T, d): the four stages of a b1 training step and of a b4 serving
# forward at 128³ (window 2³, head dim 16), as K2's [N, h, T, d] views
TRAIN = [(4096, 3, 8, 16), (512, 6, 8, 16), (64, 12, 8, 16), (8, 24, 8, 16)]
SERVE = [(16384, 3, 8, 16), (2048, 6, 8, 16), (256, 12, 8, 16), (32, 24, 8, 16)]
# the contract beyond the path: T 1-32, odd and uncompiled widths, ragged N
CORNERS = [(1000, 4, 4, 8), (300, 3, 16, 64), (77, 2, 32, 128), (13, 5, 32, 16),
           (33, 2, 16, 24), (3, 2, 8, 6), (9, 5, 2, 64), (11, 3, 32, 128), (5, 1, 4, 8),
           (40, 7, 1, 100), (20, 3, 8, 48)]


@pytest.mark.parametrize("T,dtype", itertools.product(TOKENS, (BF16, F32)))
def test_route_for_every_width_and_alignment(T, dtype):
    """mma exactly for bf16 with T = 8, d a multiple of 16 and aligned
    operands; every other (T, d, dtype, alignment) of the contract takes
    ffma."""
    for d, aligned in itertools.product(range(1, MAX_D + 1), (False, True)):
        want = "mma" if (dtype == BF16 and T == 8 and d % 16 == 0 and aligned) else "ffma"
        assert _fused_route(T, d, dtype, aligned) == want, (T, d, dtype, aligned)


@pytest.mark.parametrize("T,d,dtype", [(3, 16, BF16), (12, 16, F32), (64, 16, BF16),
                                       (0, 16, F32), (8, 0, BF16), (8, 129, F32),
                                       (8, 16, torch.float16)])
def test_route_refuses_what_no_kernel_takes(T, d, dtype):
    with pytest.raises(ValueError):
        _fused_route(T, d, dtype, True)


def test_widths_round_up_to_the_compiled_ones():
    """Each d <= 128 is staged in the least compiled width that holds it;
    the card tests' odd widths d = 6 and 24 take 8 and 32."""
    for d in range(1, MAX_D + 1):
        w = _fused_width(d)
        assert w in WIDTHS and w >= d and all(x < d for x in WIDTHS if x < w)
    assert (_fused_width(6), _fused_width(24), _fused_width(16), _fused_width(100)) == (
        8, 32, 16, 128)


@pytest.mark.parametrize("d,dtype,offset,aligned", [
    (16, BF16, 0, True), (8, BF16, 0, True), (6, BF16, 0, False), (24, BF16, 0, True),
    (24, F32, 0, True), (6, F32, 0, False), (16, F32, 1, False), (16, BF16, 8, True)])
def test_fused_aligned_needs_whole_chunks_and_aligned_rows(d, dtype, offset, aligned):
    """cp.async staging needs d whole 16-byte chunks and every address and
    stride a multiple of 16 bytes."""
    x = torch.zeros(4 * 3 * 8 * d + offset, dtype=dtype)[offset:].view(4, 3, 8, d)
    assert _fused_aligned(d, x, x) == aligned


def _check_plan(N, h, T, d, dtype, route, backward, sms=SMS):
    W, Hg, warps = _fused_plan(N, T, h, d, dtype, route, backward, sms)
    smem = _fused_smem(W, Hg, T, d, dtype, route, backward, warps)
    assert W >= 1 and h % Hg == 0 and 1 <= warps <= 4
    # the entries take 48 KB a block, and more (opting in, up to 227 KB) only
    # where one pair needs it
    assert smem <= SMEM_BLOCK or ((W, Hg) == (1, 1) and smem <= SMEM_OPT_IN), (W, Hg, smem)
    assert route != "mma" or W * Hg * Hg < 65536      # the kernels' 16-bit pair division
    return W, Hg, warps, _attn_tiles(N, h, W, Hg)


@pytest.mark.parametrize("backward,dtype", itertools.product((False, True), (BF16, F32)))
def test_plans_fill_the_card_at_every_stage(backward, dtype):
    """Every stage of the training step and of the serving forward gives a
    grid of at least 132 blocks, one a tile, and at T = 8, d = 16 the very
    plan of K1 at the same shape (the two share the device code)."""
    for N, h, T, d in TRAIN + SERVE:
        route = _fused_route(T, d, dtype, True)
        W, Hg, warps, tiles = _check_plan(N, h, T, d, dtype, route, backward)
        assert tiles >= SMS, (N, h, W, Hg, tiles)
        assert (W, Hg, warps) == _attn_plan(N, T, T, h, d, dtype, route, backward, SMS)


@pytest.mark.parametrize("N,h,T,d", CORNERS)
def test_plans_of_the_contract_corners(N, h, T, d):
    """Every corner, dtype, direction and alignment gets a plan the entries
    take; a corner with at least 132 pairs covers the card."""
    for dtype, backward, aligned in itertools.product((BF16, F32), (False, True),
                                                      (False, True)):
        route = _fused_route(T, d, dtype, aligned)
        _, _, _, tiles = _check_plan(N, h, T, d, dtype, route, backward)
        assert tiles >= min(SMS, N * h)


def test_one_pair_plans_opt_in_to_more_shared_memory():
    """T = 32, d = 128 in f32: one pair's q, k, v rows (96 rows at a 528-byte
    pitch) take 50688 bytes, with g and its P and dS rows (33 floats apart)
    76032: each is a tile of its own, above 48 KB, asking the entry to opt
    in. In bf16 the same pair fits 48 KB."""
    for backward, want in ((False, 96 * 528), (True, 128 * 528 + 32 * 33 * 8)):
        W, Hg, warps = _fused_plan(77, 32, 2, 128, F32, "ffma", backward, SMS)
        assert (W, Hg, warps) == (1, 1, 1)
        assert _fused_smem(W, Hg, 32, 128, F32, "ffma", backward, warps) == want > SMEM_BLOCK
        W, Hg, warps = _fused_plan(77, 32, 2, 128, BF16, "ffma", backward, SMS)
        assert _fused_smem(W, Hg, 32, 128, BF16, "ffma", backward, warps) <= SMEM_BLOCK


def test_tiles_hold_about_eight_over_t_of_k1s_pairs():
    """K1's tiles hold about 12 (forward) or 6 (backward) pairs of 8 tokens;
    K2 keeps the rows a tile about the same at other T."""
    assert _fused_plan(100000, 4, 1, 8, BF16, "ffma", False, SMS)[:2] == (24, 1)
    assert _fused_plan(100000, 16, 1, 8, BF16, "ffma", False, SMS)[:2] == (6, 1)
    assert _fused_plan(100000, 32, 1, 8, BF16, "ffma", False, SMS)[:2] == (3, 1)
    assert _fused_plan(100000, 32, 1, 8, BF16, "ffma", True, SMS)[:2] == (1, 1)


def test_smem_is_k1s_formula_at_the_staged_width():
    """The rows of the staged width; the ffma backward's P and dS rows at an
    odd pitch; the mma backward's per-warp tiles as K1's."""
    assert _fused_smem(2, 3, 8, 16, BF16, "mma", False, 4) == _attn_smem(
        2, 3, 8, 8, 16, BF16, "mma", False, 4)
    assert _fused_smem(2, 3, 8, 16, BF16, "mma", True, 3) == _attn_smem(
        2, 3, 8, 8, 16, BF16, "mma", True, 3)
    assert _fused_smem(1, 2, 16, 24, F32, "ffma", False, 1) == _attn_smem(
        1, 2, 16, 16, 32, F32, "ffma", False, 1)
    assert _fused_smem(1, 1, 8, 6, F32, "ffma", True, 1) == 32 * 48 + 8 * 9 * 8


@pytest.mark.parametrize("T,d,dtype,strided", [(12, 16, F32, False), (64, 16, F32, False),
                                               (8, 160, F32, False), (8, 16, torch.float16,
                                                                      False),
                                               (8, 16, F32, True)])
def test_card_check_refuses_what_the_kernels_do_not_take(T, d, dtype, strided):
    """T not dividing 128 or above 32, d above 128, fp16 and a strided
    feature axis are refused before any launch."""
    x = torch.zeros(4, 2, T, d, dtype=dtype)
    if strided:
        x = torch.zeros(4, 2, d, T, dtype=dtype).transpose(2, 3)
    with pytest.raises(ValueError):
        _check_card(x, x, x)


def test_card_check_takes_the_contract():
    for T, d, dtype in itertools.product(TOKENS, (1, 6, 24, 128), (BF16, F32)):
        x = torch.zeros(2, 3, T, d, dtype=dtype)
        _check_card(x, x.transpose(1, 2).contiguous().transpose(1, 2), x)


def test_wrapper_refuses_mismatched_operands():
    x = torch.zeros(4, 2, 8, 16)
    with pytest.raises(ValueError):
        _check(x, x[:3], x)
    with pytest.raises(ValueError):
        _check(x, x.bfloat16(), x)
    with pytest.raises(ValueError):
        fused_window_attention(x, x, x[..., :8])
    with pytest.raises(ValueError):
        fused_window_attention_backward(x, x, x, x[:, :1])
    with pytest.raises(ValueError):
        fused_window_attention_backward(x, x, x, x.bfloat16())


def test_should_use_fused_only_on_the_card():
    assert not should_use_fused(8, 16, None, None, "cpu")
    assert should_use_fused(8, 16, None, None, "cuda")
    assert not should_use_fused(12, 16, None, None, "cuda")
    assert not should_use_fused(8, 16, torch.zeros(1), None, "cuda")


def test_outputs_follow_the_inputs_layout():
    """A head-inside-token view ([N, T, h, d] underneath) gets a
    token-major output, so the transpose back is contiguous; a dense [N, h,
    T, d] input a dense output."""
    tok = torch.zeros(5, 8, 3, 16).transpose(1, 2)
    assert _empty_like_layout(tok).transpose(1, 2).is_contiguous()
    assert _empty_like_layout(torch.zeros(5, 3, 8, 16)).is_contiguous()


def test_cpu_calls_count_no_launch_and_no_route():
    """On the CPU both functions compute the plain versions: no launch and
    no route is counted."""
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(6, 3, 8, 16)).astype(np.float32))
                  for _ in range(4))
    reset_routes()
    before = dict(LAUNCHES)
    fused_window_attention(q, k, v)
    fused_window_attention_backward(q, k, v, g)
    assert dict(LAUNCHES) == before
    assert all(n == 0 for counts in ROUTES.values() for n in counts.values())
    assert set(ROUTES["fused_window_attention"]) == set(ROUTE_NAMES)
