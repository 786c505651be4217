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
               ragged ones, with the bias the path adds; K3's backward at
               MedNeXt-S's five training stage shapes (b2, 128³) and the two
               ragged ones: dx (K3 on the flipped weight) and dw, db (the
               weight-gradient kernel) against the plain version, with
               cuDNN's conv3d_input / conv3d_weight and F.conv3d forward and
               backward as the library times.
  4. slice   - per model, full width with seeded random weights, f32 with TF32
               off, on one 1x2x64³ input: the card (kernels) against the CPU
               (plain versions). MicFormer: embed 48, depths 2-2-6-2, heads
               3-6-12-24. MedNeXt-S: kernel 3, 32 channels, 2 blocks a stage.
               Then MicFormer's training step there (mdice loss on a seeded
               one-hot label, backward) with fused attention off and on,
               against one CPU reference: loss and every gradient leaf; and
               MedNeXt-S's, once with mdice and once with dice_ce on its
               deep-supervision pyramid, 36 K3 and 18 wgrad launches each.
  5. serve   - per model, the same weights in bf16 through the port's serve
               loop: one cold warm-up request, then three [2, 160³] requests,
               roi 128, overlap 0.5, gaussian, sw_batch 4. Launch counts and
               peak memory are reset just before the three and read just after.
  6. train   - cli/train.main at full width in bf16 on a synthetic MM-WHS root
               (six cases preprocessed to 128³: four train, one validation).
               MicFormer: two epochs with validation, then --resume for a
               third, then one epoch with --fused-attention. MedNeXt-S:
               --cfg configs/mednext_s_mmwhs.yaml (batch 2) for two epochs
               with validation, --resume for a third, then three epochs of
               the nnU-Net preset (deep supervision, dice_ce, the nnunet
               augmentation, SGD-Nesterov, clipping 12); every step 36 K3 and
               18 wgrad launches. Launch counts and peak memory are reset just
               before each run and read just after.
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
    "dw_conv3_wgrad": {
        "route": "cuda",
        "source": "micformer_tpu_torch/csrc/dw_conv3_wgrad.cu",
        "replaces": "micformer_tpu/ops/pallas/dw_stencil.py:97",
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
# ([B, C, D, H, W], k): MedNeXt-S's stride-1 depthwise convs in a b2 128³
# training step (stages 0-3 and the bottleneck), then DW_SHAPES' ragged cases
DW_TRAIN_SHAPES = [((2, 32, 128, 128, 128), 3), ((2, 64, 64, 64, 64), 3),
                   ((2, 128, 32, 32, 32), 3), ((2, 256, 16, 16, 16), 3),
                   ((2, 512, 8, 8, 8), 3)] + DW_SHAPES[5:]
# dw and db: sums of up to 8.4 M exact f32 products in another order (f32),
# then one rounding to bf16 (bf16)
DW_WGRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-3),
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
# the training paths: launches per MicFormer training step (forward, backward)
# with fused attention off and on, and per MedNeXt-S step (18 K3 forwards,
# 18 K3 launches for dx and 18 wgrad launches)
TRAIN_STEP = {False: expect(window_attention=96, window_attention_backward=96),
              True: expect(fused_window_attention=96, fused_window_attention_backward=96),
              "mednext": expect(dw_conv3=36, dw_conv3_wgrad=18)}


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


def dw_bound(nbytes, ops):
    """(bound ms, by, bytes ms, ops ms) of a K3-family call: bytes at the
    memory rate against f32 operations on the CUDA cores."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            1e3 * t_bytes, 1e3 * t_ops)


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
        ms, by, b_ms, o_ms = dw_bound((2 * x.numel() + w.numel() + C) * x.element_size(),
                                      2 * k ** 3 * x.numel())
        row = {"shape": [B, C, D, H, W], "k": k, "dtype": str(dt).replace("torch.", ""),
               "max_abs_err": err,
               "ms": time_ms(lambda: dw_conv3(x, w, b)),
               "plain_ms": time_ms(lambda: dw_conv3_reference(x, w, b), reps=5),
               "library_ms": time_ms(lambda: F.conv3d(x, w, b, padding=k // 2, groups=C)),
               "bound_ms": ms, "bytes_bound_ms": b_ms, "ops_bound_ms": o_ms, "bound_by": by}
        rows.append(row)
        log(f"kernel dw_conv3 {row['shape']} k {k} {row['dtype']}: err {err:.3g}, "
            f"kernel {1e3 * row['ms']:.2f} us, plain {1e3 * row['plain_ms']:.2f} us, "
            f"cudnn {1e3 * row['library_ms']:.2f} us, bound "
            f"{1e3 * row['bound_ms']:.2f} us ({row['bound_by']}; bytes "
            f"{1e3 * row['bytes_bound_ms']:.2f} us, ops {1e3 * row['ops_bound_ms']:.2f} us)")
        del x, w, b
    return rows


def autograd_conv3d(x, w, g, k, C):
    """F.conv3d forward and backward under autograd (dx and dw): the
    library's whole depthwise training conv."""
    torch.autograd.grad(F.conv3d(x, w, padding=k // 2, groups=C), (x, w), g)


def phase_dw_backward_kernel():
    """K3's backward at MedNeXt-S's training stage shapes and the ragged
    ones: dx (K3 on the flipped weight) and dw, db (the weight-gradient
    kernel), each row timed on its own against its plain version and
    cuDNN's."""
    from micformer_tpu_torch.kernels.dw_conv3 import (
        dw_conv3, dw_conv3_backward, dw_conv3_backward_reference, dw_conv3_reference,
        dw_conv3_wgrad, dw_conv3_wgrad_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    dx_rows, wgrad_rows = [], []
    for ((B, C, D, H, W), k), dt in itertools.product(
            DW_TRAIN_SHAPES, (torch.float32, torch.bfloat16)):
        x, g = (torch.randn((B, C, D, H, W), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        w = (torch.randn((C, 1, k, k, k), generator=gen, device="cuda") / k ** 1.5).to(dt)
        got = dw_conv3_backward(x, w, g)
        torch.cuda.synchronize()
        errs = {}
        for name, a, r in zip(("dx", "dw", "db"), got, dw_conv3_backward_reference(x, w, g)):
            tol = DW_TOL[dt] if name == "dx" else DW_WGRAD_TOL[dt]
            errs[name] = (a.float() - r.float()).abs().max().item()
            if not bool(((a.float() - r.float()).abs()
                         <= tol["atol"] + tol["rtol"] * r.float().abs()).all()):
                raise AssertionError(f"dw_conv3 backward {name} {[B, C, D, H, W]} k {k} {dt}: "
                                     f"max err {errs[name]} beyond {tol}")
        del got
        wf = w.flip((2, 3, 4)).contiguous()
        base = {"shape": [B, C, D, H, W], "k": k, "dtype": str(dt).replace("torch.", "")}
        n, es = x.numel(), x.element_size()
        lib = [t.detach().requires_grad_() for t in (x, w)]
        autograd_ms = time_ms(lambda: autograd_conv3d(*lib, g, k, C), reps=5)
        ms, by, b_ms, o_ms = dw_bound((2 * n + w.numel()) * es, 2 * k ** 3 * n)
        with torch.no_grad():
            dx_row = {**base, "max_abs_err": errs["dx"],
                      "ms": time_ms(lambda: dw_conv3(g, wf)),
                      "plain_ms": time_ms(lambda: dw_conv3_reference(g, wf), reps=5),
                      "library_ms": time_ms(lambda: torch.nn.grad.conv3d_input(
                          x.shape, w, g, padding=k // 2, groups=C)),
                      "autograd_ms": autograd_ms, "bound_ms": ms, "bound_by": by,
                      "bytes_bound_ms": b_ms, "ops_bound_ms": o_ms}
            ms, by, b_ms, o_ms = dw_bound(2 * n * es + C * (k ** 3 + 1) * 4,
                                          2 * k ** 3 * n + n)
            wg_row = {**base, "max_abs_err": max(errs["dw"], errs["db"]),
                      "dw_err": errs["dw"], "db_err": errs["db"],
                      "ms": time_ms(lambda: dw_conv3_wgrad(x, g, k)),
                      "plain_ms": time_ms(lambda: dw_conv3_wgrad_reference(x, g, k), reps=5),
                      "library_ms": time_ms(lambda: torch.nn.grad.conv3d_weight(
                          x, w.shape, g, padding=k // 2, groups=C)),
                      "autograd_ms": autograd_ms, "bound_ms": ms, "bound_by": by,
                      "bytes_bound_ms": b_ms, "ops_bound_ms": o_ms}
        dx_rows.append(dx_row)
        wgrad_rows.append(wg_row)
        for name, r, lib_name in (("dw_conv3 dx", dx_row, "cudnn conv3d_input"),
                                  ("dw_conv3_wgrad", wg_row, "cudnn conv3d_weight")):
            log(f"kernel {name} {r['shape']} k {k} {r['dtype']}: err {r['max_abs_err']:.3g}, "
                f"kernel {1e3 * r['ms']:.2f} us, plain {1e3 * r['plain_ms']:.2f} us, "
                f"{lib_name} {1e3 * r['library_ms']:.2f} us, F.conv3d fwd+bwd "
                f"{1e3 * autograd_ms:.2f} us, bound {1e3 * r['bound_ms']:.2f} us "
                f"({r['bound_by']}; bytes {1e3 * r['bytes_bound_ms']:.2f} us, ops "
                f"{1e3 * r['ops_bound_ms']:.2f} us)")
        del x, g, w, wf, lib
    return dx_rows, wgrad_rows


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


def phase_mednext_train_slice():
    """One full-width MedNeXt-S training step's loss and gradients, f32 with
    TF32 off, on the card against the CPU: mdice on the plain output, and
    dice_ce through the deep-supervision pyramid."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from micformer_tpu_torch.losses.dice import (
        deep_supervision_loss, mdice_loss, one_hot, softmax_dice_ce_loss,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 2, 64, 64, 64)).astype(np.float32))
    y = one_hot(torch.from_numpy(rng.integers(0, 8, (1, 64, 64, 64))), 8)
    losses = {"mdice": lambda out, t: mdice_loss(out, t),
              "dice_ce_ds": lambda out, t: deep_supervision_loss(out, t, softmax_dice_ce_loss)}

    def step(model, loss_fn, dev):
        model.train()
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model(x.to(dev)), y.to(dev))
        loss.backward()
        return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    res = {}
    for variant, loss_fn in losses.items():
        model_cpu = registry.build("mednext", device="cpu", deep_supervision=variant != "mdice",
                                   generator=torch.Generator().manual_seed(0))
        ref_loss, ref_grads = step(model_cpu, loss_fn, "cpu")
        model = copy.deepcopy(model_cpu).to("cuda")
        reset_launches()
        loss, grads = step(model, loss_fn, "cuda")
        launches = dict(LAUNCHES)
        top = max(g.abs().max().item() for g in ref_grads.values())
        worst, bias_noise = 0.0, 0.0
        for n, g in ref_grads.items():
            if n.endswith("dw.bias"):
                # an instance norm follows every depthwise conv: the exact
                # gradient of its bias is zero, both sides hold rounding
                bias_noise = max(bias_noise, grads[n].abs().max().item() / top,
                                 g.abs().max().item() / top)
                continue
            worst = max(worst, (grads[n] - g).abs().max().item() / g.abs().max().item())
        log(f"train slice: full-width mednext 1x2x64³ f32, {variant}: loss card {loss:.7f} "
            f"cpu {ref_loss:.7f}, max over leaves of max|dg|/max|g_cpu| {worst:.3g}, "
            f"depthwise biases (exactly 0) within {bias_noise:.3g} of the largest gradient, "
            f"kernel launches {launches}")
        if (not (abs(loss - ref_loss) <= 1e-5 and worst <= 1e-3 and bias_noise <= 1e-4)
                or launches != TRAIN_STEP["mednext"]):
            raise AssertionError(f"mednext train slice {variant}: loss {loss} vs {ref_loss}, "
                                 f"grad err {worst} (limit 1e-3), bias noise {bias_noise} "
                                 f"(limit 1e-4), launches {launches} "
                                 f"(want {TRAIN_STEP['mednext']})")
        res[variant] = {"loss": loss, "cpu_loss": ref_loss, "max_rel_grad_err": worst,
                        "dw_bias_noise": bias_noise, "launches": launches}
        del model, model_cpu
    torch.backends.cudnn.allow_tf32 = True
    return res


def phase_train(work):
    """cli/train.main on the card. MicFormer: two epochs, --resume for a
    third, then one epoch with --fused-attention. MedNeXt-S: the paper's
    config for two epochs, --resume for a third, then three epochs of the
    nnU-Net preset. Every step's loss finite, every step's launches as
    TRAIN_STEP says."""
    from micformer_tpu_torch.cli import train
    from micformer_tpu_torch.data.synthetic import write_synthetic_dataset
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches

    data = os.path.join(work, "mmwhs")
    t0 = time.perf_counter()
    write_synthetic_dataset(data, n_cases=6, shape=(48, 48, 48), seed=0)
    log(f"train: synthetic MM-WHS root, 6 cases of 48³, {time.perf_counter() - t0:.2f} s")
    common = ["--data", data, "--cache", os.path.join(work, "cache"),
              "--target-shape", "128", "--bf16", "--val", "1", "--workers", "2"]
    micformer = ["--model", "micformer"]
    mednext = ["--cfg", os.path.join(ROOT, "configs", "mednext_s_mmwhs.yaml")]   # batch 2
    nnunet = ["--model-kwargs", '{"deep_supervision": true}', "--deep-supervision",
              "--loss", "dice_ce", "--augment", "nnunet", "--optimizer", "sgd_nesterov",
              "--grad-clip", "12"]

    def run_dir(name):
        return ["--run-dir", os.path.join(work, name)]

    # (name, arguments, TRAIN_STEP key, batch, (steps run, step reached))
    plan = [("two epochs", micformer + ["--epochs", "2"] + run_dir("run"), False, 1, (8, 8)),
            ("resume", micformer + ["--epochs", "3", "--resume"] + run_dir("run"), False, 1,
             (4, 12)),
            ("fused", micformer + ["--epochs", "1", "--fused-attention"] + run_dir("run_fused"),
             True, 1, (4, 4)),
            ("mednext two epochs", mednext + ["--epochs", "2"] + run_dir("run_mednext"),
             "mednext", 2, (4, 4)),
            ("mednext resume", mednext + ["--epochs", "3", "--resume"] + run_dir("run_mednext"),
             "mednext", 2, (2, 6)),
            ("mednext nnunet", mednext + nnunet + ["--epochs", "3"] + run_dir("run_nnunet"),
             "mednext", 2, (6, 6))]
    runs = {}
    for name, args, key, batch, want_steps in plan:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        trainer = train.main(common + args)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        hist = trainer.history
        losses = [r["loss"] for r in hist]
        warm = [r["seconds"] for r in hist[1:]]
        res = {"steps": len(hist), "final_step": trainer.step, "losses": losses,
               "step_ms": [1e3 * r["seconds"] for r in hist],
               "batch": batch, "first_step_s": hist[0]["seconds"] if hist else None,
               "warm_ms_per_step": 1e3 * statistics.mean(warm) if warm else None,
               "warm_vol_per_s": batch * len(warm) / sum(warm) if warm else None,
               "max_memory_allocated": peak, "launches": launches, "wall_s": wall,
               "launches_per_step": hist[0]["launches"] if hist else None}
        runs[name] = res
        log(f"train {name}: {len(hist)} steps of batch {batch} (to step {trainer.step}) in "
            f"{wall:.2f} s, first step {res['first_step_s']:.3f} s, warm "
            f"{res['warm_ms_per_step']:.2f} ms/step, {res['warm_vol_per_s']:.3f} vol/s, peak "
            f"{peak / 2 ** 30:.2f} GiB, step ms {res['step_ms']}, losses {losses}, launches "
            f"{launches}, per step "
            f"{res['launches_per_step']}")
        want = TRAIN_STEP[key]
        if ((len(hist), trainer.step) != want_steps
                or not all(np.isfinite(v) and not r["skipped"] for v, r in zip(losses, hist))
                or any(r["launches"] != want for r in hist)
                or any(launches[k] < n * len(hist) for k, n in want.items())):
            raise AssertionError(f"train {name}: steps {len(hist)} to {trainer.step} (want "
                                 f"{want_steps}), losses {losses}, launches per step "
                                 f"{[r['launches'] for r in hist]} (want {want})")
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
    _, wgrad = phase_dw_backward_kernel()       # dx rows: printed
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
            else:
                phase_mednext_train_slice()
            serve[name] = phase_serve(name, model_cpu, work)
            del model_cpu
        train = phase_train(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # each kernel's line times its path's stage-0 call in bf16, q/k/v in the
    # layout of the path's self attention (sliced from the fused qkv
    # projection): K1 at serving's [16384, 8, 3, 16], its backward and K2 at
    # training's [4096, 8, 3, 16]; K3 on MedNeXt-S's [4, 32, 128³], the wgrad
    # kernel on its training [2, 32, 128³]. Launches are each path's: K1 and
    # K3 from the serve phase's three volumes, the backwards and K2 from the
    # train phase's runs that use them, wgrad from the three MedNeXt runs
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
             ("dw_conv3", stage0(dw, DW_SHAPES[0][0]), dw, serve["mednext"]["launches"]),
             ("dw_conv3_wgrad", stage0(wgrad, DW_TRAIN_SHAPES[0][0]), wgrad,
              {"dw_conv3_wgrad": sum(r["launches"]["dw_conv3_wgrad"] for n, r in train.items()
                                     if n.startswith("mednext"))})]
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
