"""Route choice and launch plans of the depthwise k³ kernels (K3 and its
weight gradient), on the CPU: `_dw_route` picks "tma", "volume" or
"cp_async" from the shape, dtype and addresses alone; `_dw_plan` gives the
launch geometry the C entry points check; the weight gradient's scratch
follows the plan. The kernels themselves run only on the card
(tests/test_torch_port_kernels.py).
"""

import itertools

import pytest
import torch

from micformer_tpu_torch.kernels import LAUNCHES
from micformer_tpu_torch.kernels.dw_conv3 import (
    ROUTE_NAMES, ROUTES, _dw_plan, _dw_route, _wgrad_scratch_size, dw_conv3,
    dw_conv3_wgrad, reset_routes,
)

BF16, F32 = torch.bfloat16, torch.float32
SMS = 132
# MedNeXt-S's serving (b4) and training (b2) shapes, and ragged ones
PATH_SHAPES = [(b, c, s, s, s) for b in (4, 2)
               for c, s in ((32, 128), (64, 64), (128, 32), (256, 16), (512, 8))]
RAGGED = [(2, 24, 37, 45, 51), (1, 16, 19, 23, 70), (2, 3, 6, 5, 7), (1, 4, 37, 40, 128),
          (3, 5, 11, 16, 8), (1, 1, 300, 2, 8), (1, 2, 3, 250, 40)]


@pytest.mark.parametrize("W,dtype,route", [
    (8, BF16, "volume"), (16, BF16, "volume"), (12, BF16, "cp_async"), (4, BF16, "cp_async"),
    (4, F32, "volume"), (12, F32, "volume"), (6, F32, "cp_async"), (13, F32, "cp_async"),
])
def test_route_needs_rows_of_16_bytes(W, dtype, route):
    """TMA needs W * element size to be a multiple of 16 bytes: W % 8 in
    bf16, W % 4 in f32."""
    assert _dw_route((2, 4, 8, 8, W), dtype, 3, 0) == route


@pytest.mark.parametrize("dhw,route", [
    ((16, 16, 16), "volume"), ((8, 8, 8), "volume"), ((1, 16, 8), "volume"),
    ((17, 16, 16), "tma"), ((16, 17, 16), "tma"), ((16, 16, 24), "tma"),
    ((128, 128, 128), "tma"),
])
def test_route_takes_whole_volumes_up_to_16_cubed(dhw, route):
    for dtype, k in itertools.product((F32, BF16), (3, 5)):
        assert _dw_route((1, 3, *dhw), dtype, k, 1024) == route


@pytest.mark.parametrize("ptrs", [(2,), (8,), (1024, 2), (2, 1024), (4096 + 4,)])
def test_route_falls_to_cp_async_for_a_misaligned_pointer(ptrs):
    """Any tensor off 16-byte alignment (x, or g for the weight gradient)
    takes the cp.async route, whatever the shape."""
    for shape in ((2, 32, 128, 128, 128), (2, 512, 8, 8, 8)):
        assert _dw_route(shape, BF16, 3, *ptrs) == "cp_async"
        assert _dw_route(shape, BF16, 3, 4096, 1 << 20) != "cp_async"


def test_route_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        _dw_route((1, 2, 8, 8, 8), torch.float16, 3, 0)
    with pytest.raises(ValueError):
        _dw_route((1, 2, 8, 8, 8), F32, 7, 0)
    with pytest.raises(ValueError):
        _dw_route((2, 8, 8, 8), F32, 3, 0)
    with pytest.raises(ValueError):
        _dw_plan((1, 2, 8, 8, 8), F32, 3, "cuda")


def _tile_checks(shape, dtype, k, plan):
    B, C, D, H, W = shape
    bx, by, chunk = plan
    vh, p, es = (2 if k == 3 else 1), k // 2, (4 if dtype == F32 else 2)
    assert bx * by <= 256 and (bx * by) % 32 == 0 and by <= 64
    assert chunk in (32, 16, 8) or chunk == D
    assert chunk <= max(D, 1)
    # the TMA box: each dimension at most 256 elements, rows of 16 bytes
    # from 16 bytes left of the tile
    a = 16 // es
    box_w = -(-(a + bx * 8 + p) // a) * a
    assert box_w <= 256 and by * vh + 2 * p <= 256
    # a tile spans the volume's width rounded up to a power of two of
    # 8-column groups, at most 128 columns
    assert bx == min(1 << (-(-W // 8) - 1).bit_length(), 16)
    return -(-H // (by * vh)) * -(-W // (bx * 8)) * -(-D // chunk)


@pytest.mark.parametrize("shape", PATH_SHAPES + RAGGED)
def test_tile_plans_are_launchable(shape):
    for dtype, k in itertools.product((F32, BF16), (3, 5)):
        for route in ("tma", "cp_async"):
            plan = _dw_plan(shape, dtype, k, route)
            parts = _tile_checks(shape, dtype, k, plan)
            assert (_wgrad_scratch_size(shape, k, route, plan)
                    == shape[0] * shape[1] * parts * (k ** 3 + 1))


@pytest.mark.parametrize("shape", [(4, 256, 16, 16, 16), (2, 256, 16, 16, 16),
                                   (4, 512, 8, 8, 8), (2, 512, 8, 8, 8), (3, 5, 11, 16, 8),
                                   (1, 1, 1, 1, 8), (64, 64, 4, 4, 8)])
def test_volume_plans_fill_the_card(shape):
    """Volumes per block are cut until the grid has 2 blocks per SM (where
    there are volumes enough), a block has at most 256 threads and its box
    fits 96 KB; the scratch holds one partial per volume."""
    B, C, D, H, W = shape
    n_vol = B * C
    for dtype, k in itertools.product((F32, BF16), (3, 5)):
        tpv, g, zero = _dw_plan(shape, dtype, k, "volume")
        assert zero == 0 and tpv & (tpv - 1) == 0 and 1 <= tpv <= 256 and g * tpv <= 256
        if n_vol >= 2 * SMS:
            assert -(-n_vol // g) >= 2 * SMS
        assert _wgrad_scratch_size(shape, k, "volume", (tpv, g, 0)) == n_vol * (k ** 3 + 1)


def test_path_plans():
    """The plans of MedNeXt-S's path shapes in bf16: stage 0 in 32-row
    tiles of 128 columns, 32-plane chunks; the bottleneck at b2 in blocks of
    3 volumes (342 blocks, more than 2 per SM)."""
    assert _dw_plan((4, 32, 128, 128, 128), BF16, 3, "tma") == (16, 16, 32)
    assert _dw_plan((2, 32, 128, 128, 128), BF16, 3, "tma") == (16, 16, 32)
    assert _dw_plan((2, 512, 8, 8, 8), BF16, 3, "volume") == (32, 3, 0)
    assert _dw_plan((2, 256, 16, 16, 16), BF16, 3, "volume") == (256, 1, 0)
    for shape in PATH_SHAPES:
        assert _dw_route(shape, BF16, 3, 1 << 20) == ("volume" if shape[-1] <= 16 else "tma")
    # [2, 32, 128³]: 64 volumes x 4 tiles x 4 chunks, 28 sums each
    assert _wgrad_scratch_size((2, 32, 128, 128, 128), 3, "tma",
                                 (16, 16, 32)) == 64 * 4 * 4 * 28


def test_routes_count_only_card_launches():
    """The CPU path is the plain version: no launch and no route is
    counted; reset_routes zeroes every count."""
    ROUTES["dw_conv3"]["tma"] += 1
    reset_routes()
    assert all(n == 0 for counts in ROUTES.values() for n in counts.values())
    assert set(ROUTES) == {"dw_conv3", "dw_conv3_wgrad"}
    assert all(tuple(c) == ROUTE_NAMES for c in ROUTES.values())
    before = dict(LAUNCHES)
    x = torch.randn(1, 2, 5, 6, 7)
    dw_conv3(x, torch.randn(2, 1, 3, 3, 3))
    dw_conv3_wgrad(x, torch.randn(1, 2, 5, 6, 7), 3)
    assert dict(LAUNCHES) == before
    assert all(n == 0 for counts in ROUTES.values() for n in counts.values())
