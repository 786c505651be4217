"""The biased window attention kernel (`kernels/biased_window_attention.py`,
`csrc/biased_window_attention.cu`) and its route in
`ops.attention.multi_head_attention`.

On the CPU: the plain version against `attention_chain` in f64, the route's
predicate (fake CUDA tensors stand in for the card's), the wrapper's
refusals, the tile plan and the custom op. On the card (marked `cuda`): the
kernel against its plain version at SwinUNETR's four stage shapes, the same
bits twice, the shared-memory formula against the C entry's, and a served
SwinUNETR call through the kernel.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_biased_attention.py

Without a card its `cuda` tests skip.
"""

import ctypes

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from micformer_tpu_torch.kernels import ATTENTION_PATHS, CALLS, LAUNCHES, _build
from micformer_tpu_torch.kernels.biased_window_attention import (
    MAX_T, ROUTES, _bwa_groups, _bwa_plan, _bwa_smem, _SMEM_OPT_IN,
    biased_window_attention, biased_window_attention_op, biased_window_attention_reference,
    reset_routes, should_use_bwa,
)
from micformer_tpu_torch.ops.attention import attention_chain, multi_head_attention
from micformer_tpu_torch.ops.windows import shifted_window_region_ids

BF16 = torch.bfloat16
SMS = 132    # the H100's SMs
# (N, T, h, d) of SwinUNETR's attention at its four stages in a forward of 4
# tiles of 128³ (feature 48, window 7³): 4 x 10³, 5³, 3³ and 2³ windows of the
# padded 70³, 35³, 21³ and 14³ grids
SWIN = [(4000, 343, 3, 16), (500, 343, 6, 16), (108, 343, 12, 16), (32, 343, 24, 16)]
# the padded grid of each stage, whose shifted windows give the region ids
SWIN_GRIDS = [70, 35, 21, 14]


def _inputs(seed, N, T, h, d, nW, dtype=torch.float64, device="cpu"):
    """q, k, v [N, T, h, d] as slices of one fused qkv projection (the
    callers' layout), a bias [h, T, T], region ids [nW, T] and an additive
    mask [nW, T, T] of 0 and -100 with some other values."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(N, T, 3 * h * d, generator=g, dtype=torch.float64)
    q, k, v = (t.reshape(N, T, h, d) for t in qkv.chunk(3, dim=-1))
    bias = torch.randn(h, T, T, generator=g, dtype=torch.float64)
    ids = torch.randint(0, 4, (nW, T), generator=g, dtype=torch.int32)
    add = torch.where(torch.rand(nW, T, T, generator=g) < 0.5, 0.0, -100.0).double()
    add += torch.randn(nW, T, T, generator=g, dtype=torch.float64)
    to = dict(dtype=dtype, device=device)
    return (*(t.to(**to) for t in (q, k, v)), bias.to(**to), ids.to(device), add.to(**to))


@pytest.mark.parametrize("T", [343, 11])
@pytest.mark.parametrize("kind", ["bias", "ids", "additive", "bias+ids", "bias+additive"])
def test_plain_version_matches_the_chain_in_f64(T, kind):
    """The plain version and `attention_chain` compute the same function. In
    f64 they differ only by the chain's row sums, which it takes in f32: at
    most T f32 roundings of sums up to T, so T * 2^-24 of max |v|."""
    q, k, v, bias, ids, add = _inputs(T, 6, T, 2, 16, 3)
    bias = bias if "bias" in kind else None
    mask = ids if "ids" in kind else add if "additive" in kind else None
    got = biased_window_attention_reference(q, k, v, bias, mask)
    want = attention_chain(q, k, v, bias=bias, mask=mask)
    assert got.dtype == torch.float64 and got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=T * 2.0 ** -24 * v.abs().max().item())


def test_region_ids_are_the_pairwise_mask():
    """Ids of a shifted-window grid give what their pairwise -100 mask gives."""
    ids = torch.from_numpy(shifted_window_region_ids((14, 14, 14), (7, 7, 7), (3, 3, 3)))
    pair = torch.where(ids[:, :, None] == ids[:, None, :], 0.0, -100.0).double()
    q, k, v, bias, _, _ = _inputs(1, 16, 343, 2, 16, 8)
    torch.testing.assert_close(biased_window_attention_reference(q, k, v, bias, ids),
                               biased_window_attention_reference(q, k, v, bias, pair),
                               rtol=0, atol=1e-12)


def _fake(shape, dtype=BF16, device="cuda", requires_grad=False):
    return torch.empty(shape, dtype=dtype, device=device, requires_grad=requires_grad)


@pytest.mark.parametrize("case,want", [
    (dict(), True), (dict(dtype=torch.float16), True), (dict(d=32), True),
    (dict(T=512), True), (dict(T=64), True), (dict(T=11), True),
    (dict(no_grad=True, requires_grad=True), True), (dict(grad=True), True),
    (dict(device="cpu"), False), (dict(dtype=torch.float32), False),
    (dict(grad=True, requires_grad=True), False), (dict(grad=True, bias_grad=True), False),
    (dict(T=513), False), (dict(Tk=342), False), (dict(d=8), False), (dict(d=64), False),
])
def test_route_predicate(case, want):
    """A CUDA tensor in bf16 or f16, no gradient asked for, Tq == Tk <= 512
    and d 16 or 32; fake CUDA tensors stand in for the card's."""
    T, d = case.get("T", 343), case.get("d", 16)
    with FakeTensorMode():
        dev, dt = case.get("device", "cuda"), case.get("dtype", BF16)
        rg = case.get("requires_grad", False)
        q = _fake((8, T, 3, d), dt, dev, rg)
        k = _fake((8, case.get("Tk", T), 3, d), dt, dev)
        bias = _fake((3, T, T), dt, dev, case.get("bias_grad", False))
        with torch.set_grad_enabled(not case.get("no_grad", False)):
            assert should_use_bwa(q, k, k, bias, None) is want


@pytest.mark.parametrize("mask", [None, "ids", "additive"])
def test_a_card_call_takes_the_route_and_the_op(mask):
    """multi_head_attention on (fake) CUDA bf16 tensors with a bias: the
    "bwa" path and one call of the op, whose fake kernel gives the shape;
    nothing launches. An unbiased, unmasked call of T <= 16 stays on K1."""
    before, calls, launches = dict(ATTENTION_PATHS), dict(CALLS), dict(LAUNCHES)
    with FakeTensorMode(), torch.no_grad():
        q = _fake((8, 343, 3, 16))
        m = (None if mask is None else _fake((2, 343), torch.int32) if mask == "ids"
             else _fake((2, 343, 343)))
        out = multi_head_attention(q, q, q, bias=_fake((3, 343, 343)), mask=m)
        assert out.shape == q.shape and out.dtype == BF16 and out.device.type == "cuda"
        multi_head_attention(*(_fake((8, 8, 3, 16)),) * 3)
    assert ATTENTION_PATHS["bwa"] == before["bwa"] + 1
    assert ATTENTION_PATHS["k1"] == before["k1"] + 1
    assert ATTENTION_PATHS["matmul"] == before["matmul"]
    assert CALLS["biased_window_attention"] == calls["biased_window_attention"] + 1
    assert LAUNCHES == launches


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_cpu_calls_take_the_chain_and_launch_nothing(dtype):
    q, k, v, bias, ids, _ = _inputs(2, 4, 343, 2, 16, 2, dtype=dtype)
    before, calls, launches = dict(ATTENTION_PATHS), dict(CALLS), dict(LAUNCHES)
    with torch.no_grad():
        out = multi_head_attention(q, k, v, bias=bias, mask=ids)
    torch.testing.assert_close(out, attention_chain(q, k, v, bias=bias, mask=ids), rtol=0,
                               atol=0)
    assert ATTENTION_PATHS["matmul"] == before["matmul"] + 1
    assert ATTENTION_PATHS["bwa"] == before["bwa"]
    assert CALLS == calls and LAUNCHES == launches


@pytest.mark.parametrize("case", ["windows", "tokens", "head8", "head64", "long", "grad",
                                  "bias"])
def test_wrapper_refuses(case):
    """N not divisible by the mask's windows, Tq != Tk, a head size or a
    token count the kernel does not take, a gradient, a misshapen bias."""
    q, k, v, bias, ids, _ = _inputs(3, 6, 11, 2, 16, 3, dtype=torch.float32)
    args = dict(q=q, k=k, v=v, bias=bias, mask=ids)
    if case == "windows":
        args["mask"] = ids[:4].repeat(2, 1)[:4]
    elif case == "tokens":
        args["k"] = k[:, :10]
    elif case in ("head8", "head64"):
        d = 8 if case == "head8" else 64
        args.update(q=q[..., :1].expand(6, 11, 2, d), k=k[..., :1].expand(6, 11, 2, d),
                    v=v[..., :1].expand(6, 11, 2, d))
    elif case == "long":
        args = dict(q=torch.zeros(1, MAX_T + 1, 1, 16), k=torch.zeros(1, MAX_T + 1, 1, 16),
                    v=torch.zeros(1, MAX_T + 1, 1, 16))
    elif case == "grad":
        args["q"] = q.clone().requires_grad_()
    elif case == "bias":
        args["bias"] = bias[:, :10]
    with pytest.raises(ValueError):
        biased_window_attention(**args)


@pytest.mark.parametrize("mask", ["ids", "additive"])
def test_custom_op_opcheck(mask):
    """Schema, fake tensor and AOT dispatch of the op on CPU tensors."""
    q, k, v, bias, ids, add = _inputs(4, 4, 11, 2, 16, 2, dtype=torch.float32)
    res = torch.library.opcheck(biased_window_attention_op,
                                (q, k, v, bias, ids if mask == "ids" else add, None))
    assert all(r == "SUCCESS" for r in res.values()), res


@pytest.mark.parametrize("T,d,want", [(343, 16, (11, 2, 2)), (343, 32, (11, 2, 1)),
                                      (64, 32, (4, 1, 2)), (512, 32, (8, 4, 1)),
                                      (8, 16, (1, 1, 2)), (11, 32, (1, 1, 2))])
def test_plan(T, d, want):
    """The most warps (16 rows each) whose bias rows and buffers fit a
    block's 227 KB, two window buffers before one; SwinUNETR's 343 tokens in
    two tiles of 176 rows (9 rows past T), double-buffered at d = 16."""
    warps, tiles, bufs = _bwa_plan(T, d)
    assert (warps, tiles, bufs) == want
    assert 16 * warps * tiles >= T > 16 * warps * (tiles - 1)
    assert _bwa_smem(T, d, warps, bufs) <= _SMEM_OPT_IN


def test_grid_covers_the_card():
    """At SwinUNETR's stage shapes the blocks (one an SM at 214 KB) cover the
    132 SMs: stages 0 and 1 in one whole wave (22 and 11 window groups),
    stage 2 in two, stage 3 in three of 4 windows a block."""
    assert _bwa_smem(343, 16, 11, 2) == 214016
    for (N, T, h, d), (G, waves) in zip(SWIN, ((22, 1), (11, 1), (11, 2), (8, 3))):
        _, tiles, _ = _bwa_plan(T, d)
        assert _bwa_groups(N, h, T, d, SMS) == G
        assert -(-h * tiles * G // SMS) == waves and h * tiles * G >= SMS


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.device("cuda")


def _swin_inputs(i, seed=0, dtype=BF16):
    """Stage i's q, k, v (slices of a fused qkv), bias and region ids on the card."""
    N, T, h, d = SWIN[i]
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(N, T, 3 * h * d, generator=g, device="cuda").to(dtype)
    q, k, v = (t.reshape(N, T, h, d) for t in qkv.chunk(3, dim=-1))
    bias = torch.randn(h, T, T, generator=g, device="cuda").to(dtype)
    grid = SWIN_GRIDS[i]
    ids = torch.from_numpy(shifted_window_region_ids((grid,) * 3, (7, 7, 7), (3, 3, 3)))
    return q, k, v, bias, ids.to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain_at_swinunetr_stages(cuda_device, stage, masked):
    """bf16 at each stage shape, with and without the shifted blocks' region
    ids. Both round P once to bf16 (the kernel against the running max, the
    plain version against the row max) and the output once: at most
    2^-9 max |v| each, 2^-7 max |v| in all. Same bits on a second launch."""
    q, k, v, bias, ids = _swin_inputs(stage)
    mask = ids if masked else None
    reset_routes()
    before = LAUNCHES["biased_window_attention"]
    got = biased_window_attention(q, k, v, bias, mask)
    again = biased_window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert LAUNCHES["biased_window_attention"] == before + 2
    assert ROUTES["ids" if masked else "none"] == 2
    want = biased_window_attention_reference(q, k, v, bias, mask)
    assert got.shape == q.shape and got.dtype == BF16 and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2.0 ** -7 * v.abs().max().item())
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f16", "additive", "additive_inf", "d32", "t64", "t11",
                                  "nobias", "t64d32", "t512d32", "scale"])
def test_kernel_contract_corners(cuda_device, case):
    """f16, an additive mask (one with -inf on every key of some rows' first
    chunk), d = 32, T = 64 and 11, no bias, and the other models' shapes:
    nnFormer's and SwinUnet3D's T = 64 and nnFormer's T = 512 at d = 32 (a
    plan of 8 warps, 4 query tiles and one buffer), VT-UNet's scale of 1/d.
    Against the plain version within 2^-7 max |v| (f16 rounds finer)."""
    dtype = torch.float16 if case == "f16" else BF16
    T = {"t64": 64, "t11": 11, "t64d32": 64, "t512d32": 512}.get(case, 343)
    d = 32 if case in ("d32", "t64d32", "t512d32", "scale") else 16
    q, k, v, bias, ids, add = _inputs(5, 24, T, 3, d, 4, dtype=dtype, device="cuda")
    if case == "additive_inf":
        add[:, :40, :32] = float("-inf")
    mask = add if case.startswith("additive") else None if case == "nobias" else ids
    bias = None if case == "nobias" else bias
    scale = 1.0 / d if case == "scale" else None
    got = biased_window_attention(q, k, v, bias, mask, scale=scale)
    want = biased_window_attention_reference(q, k, v, bias, mask, scale=scale)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2.0 ** -7 * v.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("T,d", [(343, 16), (343, 32), (64, 32), (512, 32), (11, 16)])
def test_smem_formula_matches_the_c_entry(cuda_device, T, d):
    fn = _build.load("biased_window_attention").biased_window_attention_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    for warps in (1, 4, 11, 16):
        for bufs in (1, 2):
            assert fn(T, d, warps, bufs) == _bwa_smem(T, d, warps, bufs)


@pytest.mark.cuda
def test_served_swinunetr_call_runs_the_kernel(cuda_device):
    """One served call of the benchmark's SwinUNETR (feature 48, depths
    2-2-2-2, heads 3-6-12-24, input 128, bf16) on a 160³ volume: two forwards of 4 tiles, 8 window attentions
    each, all through the kernel (8 with the shifted blocks' ids)."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.convert.aot_export import build_inference_fn

    model = registry.build("swinunetr", dtype=BF16, device=cuda_device, num_classes=8,
                           feature_size=48, depths=[2, 2, 2, 2], num_heads=[3, 6, 12, 24],
                           window_size=[7, 7, 7], in_channels=2, input_size=128)
    infer = build_inference_fn(model, roi=(128,) * 3, num_classes=8, sw_batch_size=4)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 2, 160, 160, 160),
                                                         dtype=np.float32)).to(cuda_device)
    before, launches = dict(ATTENTION_PATHS), LAUNCHES["biased_window_attention"]
    reset_routes()
    with torch.no_grad():
        seg = infer(x)
    torch.cuda.synchronize()
    paths = {k: ATTENTION_PATHS[k] - before[k] for k in before}
    assert paths == {"k1": 0, "k2": 0, "bwa": 16, "matmul": 0}
    assert LAUNCHES["biased_window_attention"] - launches == 16
    assert ROUTES == {"none": 8, "ids": 8, "additive": 0}
    assert seg.shape == (1, 160, 160, 160) and int(seg.max()) < 8
