#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (micformer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any error in any of them fails the run (non-zero exit, no result line):
  1. device  - CUDA must be available; prints nvidia-smi's name and power limit.
  2. build   - nvcc builds every kernel source of the serving and training
               paths from csrc/, one nvcc per source, all started together.
  3. kernels - each kernel against its plain PyTorch version on the card at its
               paths' shapes, f32 and bf16, with kernel, plain-version,
               library-call and bound times:
               K1 window attention in the layouts the MicFormer path hands it
               (contiguous, and q/k/v as slices of the fused qkv or kv
               projection); K1's backward at the training stage shapes (b1,
               128³) in the self and cross layouts; K2 fused window attention,
               forward and backward, on the [N, h, T, d] views of the same
               layouts and at its contract's corners (T 4-32, d 8-128, tails);
               K3 depthwise k³ conv at MedNeXt-S's five stage shapes and two
               ragged ones, with the bias the path adds.
  4. slice   - per model, full width with seeded random weights, f32 with TF32
               off, on one 1x2x64³ input: the card (kernels) against the CPU
               (plain versions). MicFormer: embed 48, depths 2-2-6-2, heads
               3-6-12-24. MedNeXt-S: kernel 3, 32 channels, 2 blocks a stage.
               Then MicFormer's training step there (mdice loss on a seeded
               one-hot label, backward) with fused attention off and on,
               against one CPU reference: loss and every gradient leaf.
  5. serve   - per model, the same weights in bf16 through the port's serve
               loop: one cold warm-up request, then three [2, 160³] requests,
               roi 128, overlap 0.5, gaussian, sw_batch 4. Launch counts and
               peak memory are reset just before the three and read just after.
  6. train   - cli/train.main at full width in bf16 on a synthetic MM-WHS root
               (six cases preprocessed to 128³: four train, one validation):
               two epochs with validation, then --resume for a third, then one
               epoch with --fused-attention. Launch counts and peak memory are
               reset just before each run and read just after.
  7. lines   - a {"kernels": [...]} line, then the {"ok": true, ...} line last.
"""

from __future__ import annotations

import concurrent.futures
import copy
import itertools
import json
import os
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense, no TF32
# K3 multiplies and adds in f32 on the CUDA cores whatever its input type: a
# depthwise conv has no reduction over channels for the tensor cores
CUDA_CORE_F32_OPS_PER_S = 67e12
KERNELS = {
    "window_attention": {
        "route": "cuda",
        "source": "micformer_tpu_torch/csrc/window_attention.cu",
        "replaces": "micformer_tpu/ops/pallas/window_attention_v2.py:95",
    },
    "window_attention_backward": {
        "route": "cuda",
        "source": "micformer_tpu_torch/csrc/window_attention_backward.cu",
        "replaces": "micformer_tpu/ops/pallas/window_attention_v2.py:112",
    },
    "fused_window_attention": {
        "route": "cuda",
        "source": "micformer_tpu_torch/csrc/fused_window_attention.cu",
        "replaces": "micformer_tpu/ops/pallas/window_attention.py:69",
    },
    "fused_window_attention_backward": {
        "route": "cuda",
        "source": "micformer_tpu_torch/csrc/window_attention_backward.cu",
        "replaces": "micformer_tpu/ops/pallas/window_attention.py:100",
    },
    "dw_conv3": {
        "route": "cuda",
        "source": "micformer_tpu_torch/csrc/dw_conv3.cu",
        "replaces": "micformer_tpu/ops/pallas/dw_stencil.py:80",
    },
}
# (N, T, h, d): stages 0-3 of a 128³ forward at sw_batch 4, then two ragged cases
ATTN_SHAPES = [(16384, 8, 3, 16), (2048, 8, 6, 16), (256, 8, 12, 16),
               (32, 8, 24, 16), (1000, 8, 3, 16), (1000, 4, 4, 8)]
# how q, k, v reach the kernel: dense, or as slices of the serving path's
# fused projections (self: qkv split in thirds; cross: q alone, kv in halves)
ATTN_LAYOUTS = ("contiguous", "self", "cross")
ATTN_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# ([B, C, D, H, W], k): MedNeXt-S's stride-1 depthwise convs at sw_batch 4,
# roi 128 (stages 0-3, each run by 2 encoder and 2 decoder blocks, then the
# bottleneck), then two ragged cases whose D, H, W are not tile multiples
DW_SHAPES = [((4, 32, 128, 128, 128), 3), ((4, 64, 64, 64, 64), 3),
             ((4, 128, 32, 32, 32), 3), ((4, 256, 16, 16, 16), 3),
             ((4, 512, 8, 8, 8), 3), ((2, 24, 37, 45, 51), 3),
             ((1, 16, 19, 23, 70), 5)]
# f32: 27-125 f32 terms summed in another order; bf16: one rounding of
# outputs up to about 10
DW_TOL = {torch.float32: dict(rtol=0.0, atol=1e-4),
          torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}
# (N, T, h, d): MicFormer's attention at the four stages of a b1 128³
# training step (window 2³, head dim 16)
TRAIN_SHAPES = [(4096, 8, 3, 16), (512, 8, 6, 16), (64, 8, 12, 16), (8, 8, 24, 16)]
# K2's contract beyond the path: T 4, 16 and 32, d 8, 64 and 128, pair
# counts that are not multiples of 128 / T (tails); (N, T, h, d)
FUSED_CORNERS = [(1000, 4, 4, 8), (300, 16, 3, 64), (77, 32, 2, 128), (13, 32, 5, 16)]
# the backward kernels and the plain versions both compute in f32: sums in
# another order (f32), one rounding of gradients up to about 10 (bf16)
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def expect(**counts):
    """A launch-count dict over every kernel: the given ones, the rest 0."""
    return {k: counts.get(k, 0) for k in KERNELS}


# the serving paths: kernel launches expected in one full-width forward at
# 1x2x64³ and in one request (two forwards at sw_batch 4)
PATHS = {
    "micformer": {"slice": expect(window_attention=96),
                  "request": expect(window_attention=192)},
    "mednext": {"slice": expect(dw_conv3=18), "request": expect(dw_conv3=36)},
}
# the training path: launches per MicFormer training step (forward, backward)
TRAIN_STEP = {False: expect(window_attention=96, window_attention_backward=96),
              True: expect(fused_window_attention=96, fused_window_attention_backward=96)}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=20):
    """Mean device time of fn() over reps, each launch after an L2 flush,
    timed with CUDA events. A spin kernel of about 0.5 ms queued after the
    flush keeps the device busy while the host runs fn's Python wrapper, so
    the events bracket device work only, not the host's launch overhead."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build():
    from micformer_tpu_torch.kernels import _build

    sources = sorted({os.path.basename(k["source"])[:-3] for k in KERNELS.values()})
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        results = dict(zip(sources, pool.map(_build.build, sources)))
    for name, r in results.items():
        log(f"build: {name} {r['seconds']:.2f} s\n{r['log'].strip()}")
    log(f"build: all kernels in {time.perf_counter() - t0:.2f} s")


def attn_inputs(gen, layout, N, T, h, d, dt):
    """q, k, v [N, T, h, d] of dtype dt in one of ATTN_LAYOUTS; the sliced
    layouts are views with a token-row stride of 3·h·d or 2·h·d."""
    def rand(width):
        return torch.randn((N, T, width), generator=gen, device="cuda").to(dt)

    C = h * d
    if layout == "self":
        return tuple(t.view(N, T, h, d) for t in rand(3 * C).chunk(3, dim=-1))
    if layout == "cross":
        k, v = (t.view(N, T, h, d) for t in rand(2 * C).chunk(2, dim=-1))
        return rand(C).view(N, T, h, d), k, v
    return tuple(rand(C).view(N, T, h, d) for _ in range(3))


def phase_attention_kernel():
    from micformer_tpu_torch.kernels.window_attention import (
        window_attention, window_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (N, T, h, d), layout, dt in itertools.product(
            ATTN_SHAPES, ATTN_LAYOUTS, (torch.float32, torch.bfloat16)):
        q, k, v = attn_inputs(gen, layout, N, T, h, d, dt)
        if layout != "contiguous" and k.is_contiguous():
            raise AssertionError(f"{layout} inputs should be strided views")
        got = window_attention(q, k, v)
        torch.cuda.synchronize()
        ref = window_attention_reference(q, k, v)
        err = (got.float() - ref.float()).abs().max().item()
        if not (err <= ATTN_ATOL[dt]):
            raise AssertionError(f"window_attention {(N, T, h, d)} {layout} {dt}: "
                                 f"max err {err} > {ATTN_ATOL[dt]}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        nbytes = 4 * q.numel() * q.element_size()
        ops = 4 * N * h * T * T * d + 3 * N * h * T * T
        row = {"shape": [N, T, h, d], "layout": layout,
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
               "ms": time_ms(lambda: window_attention(q, k, v)),
               "plain_ms": time_ms(lambda: window_attention_reference(q, k, v)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dt]),
               "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                            >= ops / PEAK_OPS_PER_S[dt] else "operations")}
        rows.append(row)
        log(f"kernel window_attention {row['shape']} {layout} {row['dtype']}: err "
            f"{err:.3g}, kernel {1e3 * row['ms']:.2f} us, plain "
            f"{1e3 * row['plain_ms']:.2f} us, sdpa {1e3 * row['library_ms']:.2f} us, "
            f"bound {1e3 * row['bound_ms']:.2f} us ({row['bound_by']})")
    return rows


def bound(nbytes, ops, dt):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate of the input type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dt]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_backward(qt, kt, vt, gt):
    """One SDPA forward and backward under autograd on [N, h, T, d] leaves:
    the library yardstick of the attention backwards."""
    out = F.scaled_dot_product_attention(qt, kt, vt)
    out.backward(gt)


def leaves(*ts):
    return [t.detach().contiguous().requires_grad_() for t in ts]


def check_grads(name, got, ref, dt):
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dt], msg=name)
    return err


def phase_attention_backward_kernel():
    """K1's backward at the training stage shapes, self and cross layouts."""
    from micformer_tpu_torch.kernels.window_attention import (
        window_attention_backward, window_attention_backward_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for (N, T, h, d), layout, dt in itertools.product(
            TRAIN_SHAPES, ("self", "cross"), (torch.float32, torch.bfloat16)):
        q, k, v = attn_inputs(gen, layout, N, T, h, d, dt)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        got = window_attention_backward(q, k, v, g)
        torch.cuda.synchronize()
        err = check_grads(f"window_attention_backward {(N, T, h, d)} {layout} {dt}", got,
                          window_attention_backward_reference(q, k, v, g), dt)
        lib = leaves(*(t.transpose(1, 2) for t in (q, k, v))) + [g.transpose(1, 2).contiguous()]
        ms, bound_by = bound(7 * q.numel() * q.element_size(),
                             N * h * (10 * T * T * d + 5 * T * T), dt)
        row = {"shape": [N, T, h, d], "layout": layout,
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
               "ms": time_ms(lambda: window_attention_backward(q, k, v, g)),
               "plain_ms": time_ms(lambda: window_attention_backward_reference(q, k, v, g)),
               "library_ms": time_ms(lambda: sdpa_backward(*lib)),
               "bound_ms": ms, "bound_by": bound_by}
        rows.append(row)
        log(f"kernel window_attention_backward {row['shape']} {layout} {row['dtype']}: err "
            f"{err:.3g}, kernel {1e3 * row['ms']:.2f} us, plain {1e3 * row['plain_ms']:.2f} us, "
            f"sdpa fwd+bwd {1e3 * row['library_ms']:.2f} us, bound "
            f"{1e3 * row['bound_ms']:.2f} us ({bound_by})")
    return rows


def phase_fused_kernel():
    """K2 forward and backward on the [N, h, T, d] views the path hands it
    (the training stage shapes, self and cross layouts) and at the corners of
    its contract (dense)."""
    from micformer_tpu_torch.kernels.fused_window_attention import (
        fused_window_attention, fused_window_attention_backward,
        fused_window_attention_backward_reference, fused_window_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = ([(s, lay) for s in TRAIN_SHAPES for lay in ("self", "cross")]
             + [(s, "contiguous") for s in FUSED_CORNERS])
    fwd, bwd = [], []
    for ((N, T, h, d), layout), dt in itertools.product(cases, (torch.float32, torch.bfloat16)):
        q, k, v = (t.transpose(1, 2) for t in attn_inputs(gen, layout, N, T, h, d, dt))
        g = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        got = fused_window_attention(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - fused_window_attention_reference(q, k, v).float()).abs().max().item()
        if not (err <= ATTN_ATOL[dt]):
            raise AssertionError(f"fused_window_attention {(N, h, T, d)} {layout} {dt}: "
                                 f"max err {err} > {ATTN_ATOL[dt]}")
        grads = fused_window_attention_backward(q, k, v, g)
        torch.cuda.synchronize()
        berr = check_grads(f"fused_window_attention_backward {(N, h, T, d)} {layout} {dt}",
                           grads, fused_window_attention_backward_reference(q, k, v, g), dt)
        dense = leaves(q, k, v)
        gd = g.contiguous()
        base = {"shape": [N, h, T, d], "layout": layout, "dtype": str(dt).replace("torch.", "")}
        ms, by = bound(4 * q.numel() * q.element_size(), N * h * (4 * T * T * d + 5 * T * T), dt)
        f_row = {**base, "max_abs_err": err,
                 "ms": time_ms(lambda: fused_window_attention(q, k, v)),
                 "plain_ms": time_ms(lambda: fused_window_attention_reference(q, k, v)),
                 "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                     *(t.detach() for t in dense))),
                 "bound_ms": ms, "bound_by": by}
        ms, by = bound(7 * q.numel() * q.element_size(), N * h * (10 * T * T * d + 5 * T * T), dt)
        b_row = {**base, "max_abs_err": berr,
                 "ms": time_ms(lambda: fused_window_attention_backward(q, k, v, g)),
                 "plain_ms": time_ms(lambda: fused_window_attention_backward_reference(q, k, v, g)),
                 "library_ms": time_ms(lambda: sdpa_backward(*dense, gd)),
                 "bound_ms": ms, "bound_by": by}
        fwd.append(f_row)
        bwd.append(b_row)
        for name, r in (("fused_window_attention", f_row),
                        ("fused_window_attention_backward", b_row)):
            log(f"kernel {name} {r['shape']} {layout} {r['dtype']}: err "
                f"{r['max_abs_err']:.3g}, kernel {1e3 * r['ms']:.2f} us, plain "
                f"{1e3 * r['plain_ms']:.2f} us, sdpa {1e3 * r['library_ms']:.2f} us, bound "
                f"{1e3 * r['bound_ms']:.2f} us ({r['bound_by']})")
    return fwd, bwd


def phase_dw_kernel():
    from micformer_tpu_torch.kernels.dw_conv3 import dw_conv3, dw_conv3_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for ((B, C, D, H, W), k), dt in itertools.product(
            DW_SHAPES, (torch.float32, torch.bfloat16)):
        x = torch.randn((B, C, D, H, W), generator=gen, device="cuda").to(dt)
        w = (torch.randn((C, 1, k, k, k), generator=gen, device="cuda")
             / k ** 1.5).to(dt)
        b = torch.randn((C,), generator=gen, device="cuda").to(dt)
        got = dw_conv3(x, w, b)
        torch.cuda.synchronize()
        ref = dw_conv3_reference(x, w, b)
        err = (got.float() - ref.float()).abs().max().item()
        tol = DW_TOL[dt]
        if not bool(((got.float() - ref.float()).abs()
                     <= tol["atol"] + tol["rtol"] * ref.float().abs()).all()):
            raise AssertionError(f"dw_conv3 {[B, C, D, H, W]} k {k} {dt}: max err "
                                 f"{err} beyond {tol}")
        del got, ref
        nbytes = (2 * x.numel() + w.numel() + C) * x.element_size()
        ops = 2 * k ** 3 * x.numel()
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_F32_OPS_PER_S
        row = {"shape": [B, C, D, H, W], "k": k, "dtype": str(dt).replace("torch.", ""),
               "max_abs_err": err,
               "ms": time_ms(lambda: dw_conv3(x, w, b)),
               "plain_ms": time_ms(lambda: dw_conv3_reference(x, w, b), reps=5),
               "library_ms": time_ms(lambda: F.conv3d(x, w, b, padding=k // 2, groups=C)),
               "bound_ms": 1e3 * max(t_bytes, t_ops), "bytes_bound_ms": 1e3 * t_bytes,
               "ops_bound_ms": 1e3 * t_ops,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows.append(row)
        log(f"kernel dw_conv3 {row['shape']} k {k} {row['dtype']}: err {err:.3g}, "
            f"kernel {1e3 * row['ms']:.2f} us, plain {1e3 * row['plain_ms']:.2f} us, "
            f"cudnn {1e3 * row['library_ms']:.2f} us, bound "
            f"{1e3 * row['bound_ms']:.2f} us ({row['bound_by']}; bytes "
            f"{1e3 * row['bytes_bound_ms']:.2f} us, ops {1e3 * row['ops_bound_ms']:.2f} us)")
        del x, w, b
    return rows


def phase_slice(name, model_cpu):
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches

    # f32 on both sides: cuDNN convs and cuBLAS matmuls without TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model_gpu = copy.deepcopy(model_cpu).to("cuda")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, 64, 64, 64)).astype(np.float32))
    with torch.no_grad():
        reset_launches()
        out_gpu = model_gpu(x.cuda()).cpu()
        launches = dict(LAUNCHES)
        out_cpu = model_cpu(x)
    if out_gpu.shape != (1, 8, 64, 64, 64) or not torch.isfinite(out_gpu).all():
        raise AssertionError(f"slice {name}: bad output {tuple(out_gpu.shape)}")
    err = (out_gpu - out_cpu).abs().max().item()
    scale = out_cpu.abs().max().item()
    log(f"slice: full-width {name} 1x2x64³ f32, card vs CPU max |d| {err:.3g} "
        f"(output max |y| {scale:.3g}), kernel launches {launches}")
    if not (err <= 1e-3) or launches != PATHS[name]["slice"] or scale == 0.0:
        raise AssertionError(f"slice {name}: max |d| {err} (limit 1e-3), launches "
                             f"{launches} (want {PATHS[name]['slice']})")
    del model_gpu
    torch.backends.cudnn.allow_tf32 = True


def phase_train_slice(model_cpu):
    """One MicFormer training step's loss and gradients, f32 with TF32 off,
    drop path off, on the card with fused attention off and on against the
    CPU."""
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from micformer_tpu_torch.losses.dice import mdice_loss, one_hot
    from micformer_tpu_torch.models.layers import DropPath

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(1, 2, 64, 64, 64)).astype(np.float32))
    y = one_hot(torch.from_numpy(rng.integers(0, 8, (1, 64, 64, 64))), 8)

    def step(model, dev):
        model.train()
        model.zero_grad(set_to_none=True)
        loss = mdice_loss(model(x.to(dev)), y.to(dev))
        loss.backward()
        return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    def copy_of(model, fused):
        """model with drop path off (deterministic in train mode) and the
        given attention option"""
        model = copy.deepcopy(model)
        for m in model.modules():
            if hasattr(m, "fused_attention"):
                m.fused_attention = fused
            if isinstance(m, DropPath):
                m.rate = 0.0
        return model

    ref_loss, ref_grads = step(copy_of(model_cpu, False), "cpu")
    res = {}
    for fused in (False, True):
        model = copy_of(model_cpu, fused).to("cuda")
        reset_launches()
        loss, grads = step(model, "cuda")
        launches = dict(LAUNCHES)
        worst = max((grads[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-8)
                    for n, g in ref_grads.items())
        log(f"train slice: full-width micformer 1x2x64³ f32, fused attention {fused}: loss "
            f"card {loss:.7f} cpu {ref_loss:.7f}, max over leaves of max|dg|/max|g_cpu| "
            f"{worst:.3g}, kernel launches {launches}")
        if not (abs(loss - ref_loss) <= 1e-5 and worst <= 1e-3) or launches != TRAIN_STEP[fused]:
            raise AssertionError(f"train slice fused={fused}: loss {loss} vs {ref_loss}, grad "
                                 f"err {worst} (limit 1e-3), launches {launches} "
                                 f"(want {TRAIN_STEP[fused]})")
        res[fused] = {"loss": loss, "cpu_loss": ref_loss, "max_rel_grad_err": worst,
                      "launches": launches}
        del model
    torch.backends.cudnn.allow_tf32 = True
    return res


def phase_train(work):
    """cli/train.main on the card: two epochs, --resume for a third, then one
    epoch with --fused-attention; every step's loss finite, every step's
    launches as TRAIN_STEP says."""
    from micformer_tpu_torch.cli import train
    from micformer_tpu_torch.data.synthetic import write_synthetic_dataset
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches

    data = os.path.join(work, "mmwhs")
    t0 = time.perf_counter()
    write_synthetic_dataset(data, n_cases=6, shape=(48, 48, 48), seed=0)
    log(f"train: synthetic MM-WHS root, 6 cases of 48³, {time.perf_counter() - t0:.2f} s")
    common = ["--data", data, "--cache", os.path.join(work, "cache"), "--model", "micformer",
              "--target-shape", "128", "--bf16", "--val", "1", "--workers", "2"]
    runs = {}
    for name, extra, fused in (
            ("two epochs", ["--epochs", "2", "--run-dir", os.path.join(work, "run")], False),
            ("resume", ["--epochs", "3", "--resume", "--run-dir", os.path.join(work, "run")],
             False),
            ("fused", ["--epochs", "1", "--fused-attention",
                       "--run-dir", os.path.join(work, "run_fused")], True)):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        trainer = train.main(common + extra)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        hist = trainer.history
        losses = [r["loss"] for r in hist]
        warm = [r["seconds"] for r in hist[1:]]
        res = {"steps": len(hist), "final_step": trainer.step, "losses": losses,
               "first_step_s": hist[0]["seconds"] if hist else None,
               "warm_ms_per_step": 1e3 * statistics.mean(warm) if warm else None,
               "warm_vol_per_s": len(warm) / sum(warm) if warm else None,
               "max_memory_allocated": peak, "launches": launches, "wall_s": wall,
               "launches_per_step": hist[0]["launches"] if hist else None}
        runs[name] = res
        log(f"train {name}: {len(hist)} steps (to step {trainer.step}) in {wall:.2f} s, first "
            f"step {res['first_step_s']:.3f} s, warm {res['warm_ms_per_step']:.2f} ms/step, "
            f"{res['warm_vol_per_s']:.3f} vol/s, peak {peak / 2 ** 30:.2f} GiB, losses "
            f"{losses}, launches {launches}, per step {res['launches_per_step']}")
        want_steps = {"two epochs": (8, 8), "resume": (4, 12), "fused": (4, 4)}[name]
        if ((len(hist), trainer.step) != want_steps
                or not all(np.isfinite(v) and not r["skipped"] for v, r in zip(losses, hist))
                or any(r["launches"] != TRAIN_STEP[fused] for r in hist)
                or any(launches[k] < n * len(hist) for k, n in TRAIN_STEP[fused].items())):
            raise AssertionError(f"train {name}: steps {len(hist)} to {trainer.step} (want "
                                 f"{want_steps}), losses {losses}, launches per step "
                                 f"{[r['launches'] for r in hist]} (want {TRAIN_STEP[fused]})")
        del trainer
        torch.cuda.empty_cache()
    return runs


def phase_serve(name, model_cpu, work):
    from micformer_tpu_torch.cli import serve
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches

    weights = os.path.join(work, f"{name}_bf16.pt")
    torch.save({k: v.bfloat16() for k, v in model_cpu.state_dict().items()}, weights)
    rng = np.random.default_rng(1)

    def serve_dir(sub, names):
        """Write one [2, 160³] request per name into a watch directory and
        serve them all; returns (latencies, out directory)."""
        watch = os.path.join(work, f"{name}_{sub}")
        out = f"{watch}_out"
        os.makedirs(watch)
        for vol in names:
            path = os.path.join(watch, f"{vol}.npy")
            np.save(path, rng.normal(size=(2, 160, 160, 160)).astype(np.float32))
            os.utime(path, (time.time() - 5,) * 2)
        lat = serve.main(["--model", name, "--weights", weights,
                          "--watch", watch, "--out", out,
                          "--roi", "128", "--overlap", "0.5", "--sw-batch-size", "4",
                          "--bf16", "--max-requests", str(len(names)),
                          "--poll", "0.05", "--idle-exit", "300"])
        return lat, out

    # one cold request first (cuDNN set-up), kept as its own number
    (cold,), _ = serve_dir("warm", ["warm"])
    names = [f"vol{i}" for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    lat, out = serve_dir("in", names)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    per_request = []
    for vol in names:
        seg = read_nifti(os.path.join(out, f"{vol}_seg.nii.gz"))
        if seg.shape != (160, 160, 160) or seg.max() >= 8:
            raise AssertionError(f"serve {name}: bad segmentation for {vol}: {seg.shape}")
        with open(os.path.join(out, f"{vol}.done")) as f:
            per_request.append(json.load(f)["launches"])
    want = PATHS[name]["request"]
    res = {"model": name, "requests": len(lat), "cold_latency_s": cold,
           "latency_s": lat, "p50_s": statistics.median(lat),
           "vol_per_s": len(lat) / sum(lat), "wall_s": wall,
           "max_memory_allocated": peak, "launches": launches,
           "launches_per_request": per_request}
    log(f"serve: {name} {len(lat)} warm volumes 2x160³ bf16 roi 128 sw_batch 4: p50 "
        f"{res['p50_s']:.4f} s, {res['vol_per_s']:.3f} vol/s, latencies {lat}, "
        f"cold first request {cold:.4f} s, peak {peak / 2 ** 30:.2f} GiB, "
        f"launches {launches}, per request {per_request}")
    if (len(lat) != 3 or per_request != [want] * 3
            or launches != {k: 3 * n for k, n in want.items()}):
        raise AssertionError(f"serve {name}: {len(lat)} requests, launches {launches}, "
                             f"per request {per_request} (want 3 requests of {want})")
    return res


def main():
    smi = phase_device()
    phase_build()
    attn = phase_attention_kernel()
    attn_bwd = phase_attention_backward_kernel()
    fused_fwd, fused_bwd = phase_fused_kernel()
    dw = phase_dw_kernel()
    from micformer_tpu_torch import registry

    work = os.path.join(ROOT, ".chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    serve = {}
    try:
        for name in PATHS:
            model_cpu = registry.build(name, device="cpu",
                                       generator=torch.Generator().manual_seed(0))
            log(f"model: {name} {sum(p.numel() for p in model_cpu.parameters())} "
                "parameters")
            phase_slice(name, model_cpu)
            if name == "micformer":
                phase_train_slice(model_cpu)
            serve[name] = phase_serve(name, model_cpu, work)
            del model_cpu
        train = phase_train(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # each kernel's line times its path's stage-0 call in bf16, q/k/v in the
    # layout of the path's self attention (sliced from the fused qkv
    # projection): K1 at serving's [16384, 8, 3, 16], its backward and K2 at
    # training's [4096, 8, 3, 16]; K3 on MedNeXt-S's [4, 32, 128³]. Launches
    # are each path's: K1 and K3 from the serve phase's three volumes, the
    # backwards and K2 from the train phase's runs that use them
    def stage0(rows, shape):
        return next(r for r in rows if r["shape"] == list(shape)
                    and r.get("layout", "self") == "self" and r["dtype"] == "bfloat16")

    n0, t0_, h0, d0 = TRAIN_SHAPES[0]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "dtype")
    lines = [("window_attention", stage0(attn, ATTN_SHAPES[0]), attn,
              serve["micformer"]["launches"]),
             ("window_attention_backward", stage0(attn_bwd, TRAIN_SHAPES[0]), attn_bwd,
              train["two epochs"]["launches"]),
             ("fused_window_attention", stage0(fused_fwd, (n0, h0, t0_, d0)), fused_fwd,
              train["fused"]["launches"]),
             ("fused_window_attention_backward", stage0(fused_bwd, (n0, h0, t0_, d0)),
              fused_bwd, train["fused"]["launches"]),
             ("dw_conv3", stage0(dw, DW_SHAPES[0][0]), dw, serve["mednext"]["launches"])]
    kernels = [{"name": name, **KERNELS[name], "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{k: row[k] for k in timed + ("layout", "k") if k in row}}
               for name, row, rows, launches in lines]
    for kern in kernels:
        if not kern["launches"] > 0:
            raise AssertionError(f"{kern['name']} was not launched on its path")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
