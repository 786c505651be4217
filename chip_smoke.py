#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (micformer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any error in any of them fails the run (non-zero exit, no result line):
  1. device  - CUDA must be available; prints nvidia-smi's name and power limit.
  2. build   - nvcc builds every kernel source of the serving and training
               paths from csrc/, one nvcc per source, all started together;
               then, per kernel function, cuobjdump's SASS of its main loop
               (the backward branch that holds the most FFMAs): instructions
               and FFMAs, and the function's FFMAs and HMMAs (tensor-core mmas).
  3. kernels - each kernel against its plain PyTorch version on the card at its
               paths' shapes, f32 and bf16, with kernel, plain-version,
               library-call and bound times:
               K1 window attention (after the harness's floor: time_ms of a
               one-block kernel) at the four stage shapes of a b4 serving
               forward and two ragged ones, in the layouts the MicFormer path
               hands it (contiguous, and q/k/v as slices of the fused qkv or
               kv projection); K1's backward at the four training stage shapes
               (b1, 128³) in the self and cross layouts; each K1 row names the
               route its checked launch counted in the wrapper's ROUTES (mma
               in bf16, ffma in f32) and the time_ms of one device copy that
               moves the same bytes; K2 fused window attention, forward and
               backward, on the [N, h, T, d] views of the training stage
               shapes (self and cross layouts) and of the serving ones (self),
               and at its contract's corners (T 4-32, d 8-128, tails), each
               row naming its route as K1's do; the rows of K1, K2 and their
               backwards summed over one pass (the b4 forward's and the b1
               step's 16/16/48/16 launches at the four stages); then K1 and
               its backward, and K2 and its backward, captured once in a CUDA
               graph, replayed and held bitwise against their eager results;
               K3 depthwise k³ conv at MedNeXt-S's five stage shapes and two
               ragged ones, with the bias the path adds (each row names the
               staging route `_dw_route` chose: tma at 128³-32³, volume at
               16³ and 8³, cp_async on the ragged rows); K3's backward at
               MedNeXt-S's five training stage shapes (b2, 128³) and the two
               ragged ones: dx (K3 on the flipped weight) and dw, db (the
               weight-gradient kernel) against the plain version, with
               cuDNN's conv3d_input / conv3d_weight and F.conv3d forward and
               backward as the library times; then each of the three summed
               over one MedNeXt-S pass (18 launches at the stage shapes).
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
               roi 128, overlap 0.5, gaussian, sw_batch 4. Launch counts, K3's
               staging routes (tma and volume only), K1's routes (mma only)
               and peak memory are reset just before the three and read just
               after.
  6. train   - cli/train.main at full width in bf16 on a synthetic MM-WHS root
               (six cases preprocessed to 128³: four train, one validation).
               MicFormer: two epochs with validation, then --resume for a
               third, then one epoch with --fused-attention. MedNeXt-S:
               --cfg configs/mednext_s_mmwhs.yaml (batch 2) for two epochs
               with validation, --resume for a third, then three epochs of
               the nnU-Net preset (deep supervision, dice_ce, the nnunet
               augmentation, SGD-Nesterov, clipping 12); every step 36 K3 and
               18 wgrad launches, on the tma and volume routes only; K1 and its
               backward (K2 and its backward in the fused epoch) on the mma
               route only. Launch counts, routes and peak
               memory are reset just before each run and read just after.
  7. predict - from the runs of phase 6 (MicFormer, fused, MedNeXt-S), f32
               on a second synthetic root (15 cases of 48³, two of them in
               the test split) at 160³, roi 128, sw_batch 4, mirror TTA:
               cli/predict serially and with batched TTA (MicFormer: their
               softmax within 2e-3 of each other and of a direct
               sliding_window_inference on the checkpoint), from the fused
               run, from MedNeXt-S with --native-geometry, and a two-fold
               ensemble; cli/ensemble; cli/evaluate --regions on every output
               (in-process, each timed alone); serve --run-dir of the
               MedNeXt-S run (bf16) on two NIfTI pairs and one .npy. Exact
               launches, routes (f32: K1 and K2 ffma; K3 tma and volume),
               seconds a case and peak memory of each run.
  8. train, the rest - on phase 6's root, bf16, one epoch a run through
               cli/train.main, each with phase 6's checks (launches a step,
               routes, finite losses) and its warm ms a step, first step, peak
               memory and wall: MicFormer --loss gdl; MicFormer --pretrained
               from phase 6's run with --loss focal (out_conv alone skipped,
               nothing missing); Trainer.find_lr (8 iterations, topk: rising
               lrs, finite smoothed losses, a train step's launches each
               iteration, the trainer's weights unchanged); MedNeXt-S
               --oversample-fg 0.33 --loss dice_topk; the cascade on
               previous-stage maps at 64³ with --loss mcc (a 9-channel stem),
               then cli/predict from it with the same maps (f32, 18 K3
               launches a case); --single-modal --worker-mode process --loss
               dice_bce (a 1-channel stem); run_export over the phase's runs;
               profiling.trace of one MicFormer step (96 K1 and 96 K1-bwd
               kernel events).
  9. parallel - data parallelism (torch.distributed): (a) NCCL at world size 1 in
               this process: a DDP-wrapped full-width MicFormer step (b1, 128³, f32,
               TF32 off) against the plain step (1e-6 of max |g|; bitwise
               reported), the bf16 step's warm ms both ways (6 steps after one);
               (b) two ranks on the one card over gloo (spawned with torchrun's
               variables), each through cli/train.main --mesh data=2 at global
               batch 2, bf16, one epoch: MicFormer (K1 96 + K1-bwd 96 a rank and
               step, mma) and MedNeXt-S --zero1 (K3 36 + wgrad 18, tma and
               volume); every loss finite and equal on both ranks; each run's
               all-reduce events from a profiled step and one gradient-sized
               all-reduce timed alone; then the ZeRO-1 run resumed in one process
               without --mesh from its consolidated optimizer state; (c) a
               two-rank MicFormer step at global b2 (f32, SGD-Nesterov) against
               the single process's b2 step from (a)'s process: loss 1e-5, every
               gradient leaf 1e-3 of its max |g|, parameters after the step 1e-6;
               (d) cli/predict --sharded-tiles over two ranks from phase 6's
               MicFormer run on phase 7's root (f32, 160³, roi 128, mirror TTA):
               K1 launches a rank (its 4 of the 8 tiles) x 8 flips x 96, the
               softmax of the first case within 1e-4 of phase 7's serial
               prediction; (e) cli/train --model generic_unet (base 32, five (2,
               2, 2) pools, k3) for one epoch, then cli/predict --engine spatial
               --spatial-shards 2 from it, its logits within 2e-4 of one
               process's forward of the checkpoint. Each run's warm ms a step,
               first step, peak memory and wall a rank.
 10. lines   - a {"kernels": [...]} line, then the {"ok": true, ...} line last.
"""

from __future__ import annotations

import concurrent.futures
import copy
import glob
import itertools
import json
import math
import os
import re
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
        "source": "micformer_tpu_torch/csrc/window_attention.cu",
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
# K1 launches at the four stages of one MicFormer pass (a forward at sw_batch
# 4, or a b1 training step's backward): 16, 16, 48 and 16 of the 96
ATTN_STAGE_LAUNCHES = [16, 16, 48, 16]
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
# stride-1 depthwise convs of one MedNeXt-S pass at stages 0-3 (2 encoder
# and 2 decoder blocks each) and the bottleneck (2 blocks): 18 in all
DW_STAGE_LAUNCHES = [4, 4, 4, 4, 2]
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
              "mednext": expect(dw_conv3=36, dw_conv3_wgrad=18), "generic_unet": expect()}


# the training phases' volumes: 2×128³, each model's published patch
TRAIN_SIZE = 128


def log(msg):
    print(msg, flush=True)


def path_routes(routes):
    """The staging routes a run used, per depthwise kernel."""
    return {name: sorted(r for r, n in counts.items() if n > 0)
            for name, counts in routes.items()}


# a path at roi 128 (or 64) runs the depthwise kernels on the tma route down
# to 32³ and the volume route at 16³ and 8³, never on cp_async; the bf16
# MicFormer paths run both K1 kernels (or with --fused-attention both K2
# kernels) on the mma route
PATH_ROUTES = ["tma", "volume"]
ATTN_PATH_ROUTES = ["mma"]


def all_routes():
    """The routes a run used, per K3-family and attention (K1, K2) kernel."""
    from micformer_tpu_torch.kernels.dw_conv3 import ROUTES
    from micformer_tpu_torch.kernels.window_attention import ROUTES as ATTN_ROUTES

    return path_routes({**ROUTES, **ATTN_ROUTES})


def reset_all_routes():
    from micformer_tpu_torch.kernels.dw_conv3 import reset_routes
    from micformer_tpu_torch.kernels.window_attention import reset_routes as reset_attn

    reset_routes()
    reset_attn()


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


def copy_ms(nbytes):
    """time_ms of one device-to-device copy that reads nbytes / 2 and writes
    nbytes / 2: what the harness gives a single streaming kernel that moves
    the same bytes (cold L2 after the flush, launch and event overhead)."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src))


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
    sass_report([_build._target(name)[1] for name in sources])


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
_SASS_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass_report(libs):
    """Per kernel function of each library: SASS instructions and FFMAs of
    its main loop (the backward branch whose range holds the most FFMAs),
    the loop's most frequent opcodes, and the whole function's counts, from
    cuobjdump -sass. Prints one line a function; a missing cuobjdump is
    reported, not an error."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not os.path.exists(tool):
        log("sass: cuobjdump not found")
        return
    for lib in libs:
        text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                              timeout=300).stdout
        funcs = re.split(r"\n\s*Function : (\S+)", text)
        names = funcs[1::2]
        if os.path.exists(filt) and names:
            names = subprocess.run([filt], input="\n".join(names), capture_output=True,
                                   text=True, timeout=60).stdout.split("\n")
        for name, body in zip(names, funcs[2::2]):
            insns, labels, pending = [], {}, []
            for line in body.splitlines():
                m = _SASS_LABEL.match(line)
                if m:
                    pending.append(m.group(1))
                    continue
                m = _SASS_INSN.search(line)
                if m:
                    addr = int(m.group(1), 16)
                    for lab in pending:
                        labels[lab] = addr
                    pending = []
                    insns.append((addr, m.group(3), m.group(4)))
            best = None
            for addr, op, rest in insns:
                m = _SASS_BRA.search(op + rest) if op.startswith("BRA") else None
                if not m:
                    continue
                tgt = m.group(1)
                tgt = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt, addr + 1)
                if tgt >= addr:
                    continue
                body_ops = [o.split(".")[0] for a, o, _ in insns if tgt <= a <= addr]
                ffma = body_ops.count("FFMA")
                if best is None or ffma > best[1]:
                    best = (len(body_ops), ffma, body_ops)
            total = len(insns)
            ffma_all = sum(o.startswith("FFMA") for _, o, _ in insns)
            hmma_all = sum(o.startswith("HMMA") for _, o, _ in insns)
            loop = "no loop"
            if best:
                top = sorted(set(best[2]), key=lambda o: (-best[2].count(o), o))[:8]
                loop = (f"loop {best[0]} instructions, {best[1]} FFMA "
                        f"({100.0 * best[1] / max(best[0], 1):.1f} %) ["
                        + " ".join(f"{o} {best[2].count(o)}" for o in top) + "]")
            log(f"sass: {os.path.basename(lib)} {name.strip()}: {loop}; function {total} "
                f"instructions, {ffma_all} FFMA, {hmma_all} HMMA")


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


def routed(kernel, fn):
    """fn()'s result (after a synchronize) and the one route of `kernel`
    it launched on, read from the wrapper's ROUTES counts around the call."""
    from micformer_tpu_torch.kernels.window_attention import ROUTES, reset_routes

    reset_routes()
    out = fn()
    torch.cuda.synchronize()
    used = [r for r, n in ROUTES[kernel].items() if n]
    if [ROUTES[kernel][r] for r in used] != [1]:
        raise AssertionError(f"{kernel}: one launch on one route expected, got {ROUTES[kernel]}")
    return out, used[0]


def phase_attention_kernel():
    from micformer_tpu_torch.kernels.window_attention import (
        window_attention, window_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    tiny = torch.zeros(32, device="cuda")
    log(f"floor: time_ms of a one-block kernel (zero_ on 32 floats) "
        f"{1e3 * time_ms(tiny.zero_):.2f} us")
    rows = []
    for (N, T, h, d), layout, dt in itertools.product(
            ATTN_SHAPES, ATTN_LAYOUTS, (torch.float32, torch.bfloat16)):
        q, k, v = attn_inputs(gen, layout, N, T, h, d, dt)
        if layout != "contiguous" and k.is_contiguous():
            raise AssertionError(f"{layout} inputs should be strided views")
        got, route = routed("window_attention", lambda: window_attention(q, k, v))
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
               "route": route, "ms": time_ms(lambda: window_attention(q, k, v)),
               "plain_ms": time_ms(lambda: window_attention_reference(q, k, v)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               "copy_ms": copy_ms(nbytes),
               "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dt]),
               "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                            >= ops / PEAK_OPS_PER_S[dt] else "operations")}
        rows.append(row)
        log(f"kernel window_attention {row['shape']} {layout} {row['dtype']} {row['route']}: err "
            f"{err:.3g}, kernel {1e3 * row['ms']:.2f} us, plain "
            f"{1e3 * row['plain_ms']:.2f} us, sdpa {1e3 * row['library_ms']:.2f} us, "
            f"copy of the same bytes {1e3 * row['copy_ms']:.2f} us, "
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
        got, route = routed("window_attention_backward",
                            lambda: window_attention_backward(q, k, v, g))
        err = check_grads(f"window_attention_backward {(N, T, h, d)} {layout} {dt}", got,
                          window_attention_backward_reference(q, k, v, g), dt)
        lib = leaves(*(t.transpose(1, 2) for t in (q, k, v))) + [g.transpose(1, 2).contiguous()]
        nbytes = 7 * q.numel() * q.element_size()
        ms, bound_by = bound(nbytes, N * h * (10 * T * T * d + 5 * T * T), dt)
        row = {"shape": [N, T, h, d], "layout": layout,
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
               "route": route,
               "ms": time_ms(lambda: window_attention_backward(q, k, v, g)),
               "plain_ms": time_ms(lambda: window_attention_backward_reference(q, k, v, g)),
               "library_ms": time_ms(lambda: sdpa_backward(*lib)),
               "copy_ms": copy_ms(nbytes), "bound_ms": ms, "bound_by": bound_by}
        rows.append(row)
        log(f"kernel window_attention_backward {row['shape']} {layout} {row['dtype']} "
            f"{row['route']}: err "
            f"{err:.3g}, kernel {1e3 * row['ms']:.2f} us, plain {1e3 * row['plain_ms']:.2f} us, "
            f"sdpa fwd+bwd {1e3 * row['library_ms']:.2f} us, copy of the same bytes "
            f"{1e3 * row['copy_ms']:.2f} us, bound "
            f"{1e3 * row['bound_ms']:.2f} us ({bound_by})")
    return rows


def attn_pass_sums(fwd_rows, bwd_rows, fused_fwd_rows, fused_bwd_rows):
    """Kernel, library and bound time of one MicFormer pass of each attention
    kernel, q/k/v sliced from the fused qkv projection (self layout; K2 on
    their [N, h, T, d] views): K1's and K2's rows at the serving stage shapes
    (a b4 forward) and K2's, K1-bwd's and K2-bwd's at the training ones (a
    b1 step), each times its launches (ATTN_STAGE_LAUNCHES)."""
    def k2(shapes):
        return [(N, h, T, d) for N, T, h, d in shapes]

    sums = {}
    for name, rows, shapes in (
            ("window_attention (b4 forward)", fwd_rows, ATTN_SHAPES),
            ("fused_window_attention (b4 forward)", fused_fwd_rows, k2(ATTN_SHAPES[:4])),
            ("fused_window_attention (b1 step)", fused_fwd_rows, k2(TRAIN_SHAPES)),
            ("window_attention_backward (b1 step)", bwd_rows, TRAIN_SHAPES),
            ("fused_window_attention_backward (b1 step)", fused_bwd_rows, k2(TRAIN_SHAPES))):
        for dt in ("float32", "bfloat16"):
            sel = [next(r for r in rows if r["shape"] == list(shape) and r["dtype"] == dt
                        and r["layout"] == "self") for shape in shapes[:4]]
            s = {key: sum(n * r[key] for n, r in zip(ATTN_STAGE_LAUNCHES, sel))
                 for key in ("ms", "library_ms", "copy_ms", "bound_ms") if key in sel[0]}
            sums[f"{name} {dt}"] = s
            copies = f"copies {1e3 * s['copy_ms']:.1f} us, " if "copy_ms" in s else ""
            log(f"pass sum {name} {dt}: kernel {1e3 * s['ms']:.1f} us, sdpa "
                f"{1e3 * s['library_ms']:.1f} us, {copies}bound {1e3 * s['bound_ms']:.1f} us "
                f"({sum(ATTN_STAGE_LAUNCHES)} launches; stages "
                + ", ".join(f"{1e3 * r['ms']:.2f}" for r in sel) + " us)")
    return sums


def phase_attention_graph():
    """K1 and its backward, and K2 and its backward, each pair captured once
    in a CUDA graph on static inputs (the training stage-0 shape, self layout,
    f32 and bf16; K2 on the [N, h, T, d] views), replayed, and held bitwise
    against the eager results: the wrappers and C entries allocate nothing
    and never synchronise inside the capture."""
    from micformer_tpu_torch.kernels.fused_window_attention import (
        fused_window_attention, fused_window_attention_backward,
    )
    from micformer_tpu_torch.kernels.window_attention import (
        window_attention, window_attention_backward,
    )

    gen = torch.Generator(device="cuda").manual_seed(6)
    N, T, h, d = TRAIN_SHAPES[0]
    res = {}
    for (name, fwd, bwd), dt in itertools.product(
            (("window_attention", window_attention, window_attention_backward),
             ("fused_window_attention", fused_window_attention,
              fused_window_attention_backward)), (torch.float32, torch.bfloat16)):
        q, k, v = attn_inputs(gen, "self", N, T, h, d, dt)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        if name == "fused_window_attention":
            q, k, v, g = (t.transpose(1, 2) for t in (q, k, v, g))

        def both():
            return (fwd(q, k, v), *bwd(q, k, v, g))

        eager = both()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            both()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = both()
        for t in static:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(static, eager)]
        log(f"graph: {name} and its backward {list(q.shape)} self "
            f"{str(dt).replace('torch.', '')}: replay equals eager bitwise (out, dq, dk, dv) "
            f"{same}")
        if not all(same):
            raise AssertionError(f"graph replay of {name} differs from eager: {same}")
        res[f"{name} {dt}"] = same
        del graph, static, eager
    return res


def phase_fused_kernel():
    """K2 forward and backward on the [N, h, T, d] views the paths hand it
    (the training stage shapes, self and cross layouts; the serving stage
    shapes, self layout) and at the corners of its contract (dense); each
    row names the route its checked launch counted in ROUTES."""
    from micformer_tpu_torch.kernels.fused_window_attention import (
        fused_window_attention, fused_window_attention_backward,
        fused_window_attention_backward_reference, fused_window_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = ([(s, lay) for s in TRAIN_SHAPES for lay in ("self", "cross")]
             + [(s, "self") for s in ATTN_SHAPES[:4]]
             + [(s, "contiguous") for s in FUSED_CORNERS])
    fwd, bwd = [], []
    for ((N, T, h, d), layout), dt in itertools.product(cases, (torch.float32, torch.bfloat16)):
        q, k, v = (t.transpose(1, 2) for t in attn_inputs(gen, layout, N, T, h, d, dt))
        g = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        got, f_route = routed("fused_window_attention", lambda: fused_window_attention(q, k, v))
        err = (got.float() - fused_window_attention_reference(q, k, v).float()).abs().max().item()
        if not (err <= ATTN_ATOL[dt]):
            raise AssertionError(f"fused_window_attention {(N, h, T, d)} {layout} {dt}: "
                                 f"max err {err} > {ATTN_ATOL[dt]}")
        grads, b_route = routed("fused_window_attention_backward",
                                lambda: fused_window_attention_backward(q, k, v, g))
        berr = check_grads(f"fused_window_attention_backward {(N, h, T, d)} {layout} {dt}",
                           grads, fused_window_attention_backward_reference(q, k, v, g), dt)
        del got, grads
        dense = leaves(q, k, v)
        gd = g.contiguous()
        base = {"shape": [N, h, T, d], "layout": layout, "dtype": str(dt).replace("torch.", "")}
        ms, by = bound(4 * q.numel() * q.element_size(), N * h * (4 * T * T * d + 5 * T * T), dt)
        f_row = {**base, "max_abs_err": err, "route": f_route,
                 "ms": time_ms(lambda: fused_window_attention(q, k, v)),
                 "plain_ms": time_ms(lambda: fused_window_attention_reference(q, k, v)),
                 "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                     *(t.detach() for t in dense))),
                 "bound_ms": ms, "bound_by": by}
        ms, by = bound(7 * q.numel() * q.element_size(), N * h * (10 * T * T * d + 5 * T * T), dt)
        b_row = {**base, "max_abs_err": berr, "route": b_route,
                 "ms": time_ms(lambda: fused_window_attention_backward(q, k, v, g)),
                 "plain_ms": time_ms(lambda: fused_window_attention_backward_reference(q, k, v, g)),
                 "library_ms": time_ms(lambda: sdpa_backward(*dense, gd)),
                 "bound_ms": ms, "bound_by": by}
        fwd.append(f_row)
        bwd.append(b_row)
        for name, r in (("fused_window_attention", f_row),
                        ("fused_window_attention_backward", b_row)):
            log(f"kernel {name} {r['shape']} {layout} {r['dtype']} {r['route']}: err "
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
    from micformer_tpu_torch.kernels.dw_conv3 import _dw_route, dw_conv3, dw_conv3_reference

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
               "route": _dw_route(x.shape, dt, k, x.data_ptr()), "max_abs_err": err,
               "ms": time_ms(lambda: dw_conv3(x, w, b)),
               "plain_ms": time_ms(lambda: dw_conv3_reference(x, w, b), reps=5),
               "library_ms": time_ms(lambda: F.conv3d(x, w, b, padding=k // 2, groups=C)),
               "bound_ms": ms, "bytes_bound_ms": b_ms, "ops_bound_ms": o_ms, "bound_by": by}
        rows.append(row)
        log(f"kernel dw_conv3 {row['shape']} k {k} {row['dtype']} {row['route']}: err {err:.3g}, "
            f"kernel {1e3 * row['ms']:.2f} us, plain {1e3 * row['plain_ms']:.2f} us, "
            f"cudnn {1e3 * row['library_ms']:.2f} us, bound "
            f"{1e3 * row['bound_ms']:.2f} us ({row['bound_by']}; bytes "
            f"{1e3 * row['bytes_bound_ms']:.2f} us, ops {1e3 * row['ops_bound_ms']:.2f} us)")
        del x, w, b
    return rows


def dw_pass_sums(name, rows, shapes):
    """Kernel, library and bound time of one MedNeXt-S pass of a K3-family
    kernel: each stage shape's row times its launches (DW_STAGE_LAUNCHES)."""
    sums = {}
    for dt in ("float32", "bfloat16"):
        sel = [next(r for r in rows if r["shape"] == list(shape) and r["dtype"] == dt)
               for shape, _ in shapes[:len(DW_STAGE_LAUNCHES)]]
        sums[dt] = {key: sum(n * r[key] for n, r in zip(DW_STAGE_LAUNCHES, sel))
                    for key in ("ms", "library_ms", "bound_ms")}
        log(f"pass sum {name} {dt}: kernel {1e3 * sums[dt]['ms']:.1f} us, library "
            f"{1e3 * sums[dt]['library_ms']:.1f} us, bound {1e3 * sums[dt]['bound_ms']:.1f} us "
            f"({sum(DW_STAGE_LAUNCHES)} launches)")
    return sums


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
        _dw_route, dw_conv3, dw_conv3_backward, dw_conv3_backward_reference,
        dw_conv3_reference, dw_conv3_wgrad, dw_conv3_wgrad_reference,
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
        dx_route = _dw_route(g.shape, dt, k, g.data_ptr())
        wg_route = _dw_route(x.shape, dt, k, x.data_ptr(), g.data_ptr())
        lib = [t.detach().requires_grad_() for t in (x, w)]
        autograd_ms = time_ms(lambda: autograd_conv3d(*lib, g, k, C), reps=5)
        ms, by, b_ms, o_ms = dw_bound((2 * n + w.numel()) * es, 2 * k ** 3 * n)
        with torch.no_grad():
            dx_row = {**base, "route": dx_route, "max_abs_err": errs["dx"],
                      "ms": time_ms(lambda: dw_conv3(g, wf)),
                      "plain_ms": time_ms(lambda: dw_conv3_reference(g, wf), reps=5),
                      "library_ms": time_ms(lambda: torch.nn.grad.conv3d_input(
                          x.shape, w, g, padding=k // 2, groups=C)),
                      "autograd_ms": autograd_ms, "bound_ms": ms, "bound_by": by,
                      "bytes_bound_ms": b_ms, "ops_bound_ms": o_ms}
            ms, by, b_ms, o_ms = dw_bound(2 * n * es + C * (k ** 3 + 1) * 4,
                                          2 * k ** 3 * n + n)
            wg_row = {**base, "route": wg_route, "max_abs_err": max(errs["dw"], errs["db"]),
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
            log(f"kernel {name} {r['shape']} k {k} {r['dtype']} {r['route']}: err "
                f"{r['max_abs_err']:.3g}, "
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
    from micformer_tpu_torch.data.synthetic import write_synthetic_dataset

    data = os.path.join(work, "mmwhs")
    t0 = time.perf_counter()
    write_synthetic_dataset(data, n_cases=6, shape=(48, 48, 48), seed=0)
    log(f"train: synthetic MM-WHS root, 6 cases of 48³, {time.perf_counter() - t0:.2f} s")
    common = ["--data", data, "--cache", os.path.join(work, "cache"),
              "--target-shape", str(TRAIN_SIZE), "--bf16", "--val", "1", "--workers", "2"]
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
        runs[name], trainer = train_run(name, common + args, key, batch, want_steps)
        del trainer
        torch.cuda.empty_cache()
    return runs


def train_run(name, argv, key, batch, want_steps):
    """cli/train.main(argv) with launch counts, routes and peak memory reset
    just before and read just after. Checks: (steps run, step reached) as
    want_steps, every loss finite and applied, every step's launches
    TRAIN_STEP[key], routes only tma and volume (K3 family) and mma (K1 or
    K2). Returns (the run's numbers, the trainer)."""
    from micformer_tpu_torch.cli import train
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_all_routes()
    t0 = time.perf_counter()
    trainer = train.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    routes = all_routes()
    dw_routes = PATH_ROUTES if key == "mednext" else []
    k1_routes = ATTN_PATH_ROUTES if key is False else []
    k2_routes = ATTN_PATH_ROUTES if key is True else []
    want_routes = {"dw_conv3": dw_routes, "dw_conv3_wgrad": dw_routes,
                   "window_attention": k1_routes, "window_attention_backward": k1_routes,
                   "fused_window_attention": k2_routes,
                   "fused_window_attention_backward": k2_routes}
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
           "launches_per_step": hist[0]["launches"] if hist else None, "routes": routes}
    log(f"train {name}: {len(hist)} steps of batch {batch} (to step {trainer.step}) in "
        f"{wall:.2f} s, first step {res['first_step_s']:.3f} s, warm "
        f"{res['warm_ms_per_step']:.2f} ms/step, {res['warm_vol_per_s']:.3f} vol/s, peak "
        f"{peak / 2 ** 30:.2f} GiB, step ms {res['step_ms']}, losses {losses}, launches "
        f"{launches}, per step "
        f"{res['launches_per_step']}, routes {routes}")
    want = TRAIN_STEP[key]
    if routes != want_routes:
        raise AssertionError(f"train {name}: routes {routes} (want {want_routes})")
    if ((len(hist), trainer.step) != want_steps
            or not all(np.isfinite(v) and not r["skipped"] for v, r in zip(losses, hist))
            or any(r["launches"] != want for r in hist)
            or any(launches[k] < n * len(hist) for k, n in want.items())):
        raise AssertionError(f"train {name}: steps {len(hist)} to {trainer.step} (want "
                             f"{want_steps}), losses {losses}, launches per step "
                             f"{[r['launches'] for r in hist]} (want {want})")
    return res, trainer


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
    reset_all_routes()
    t0 = time.perf_counter()
    lat, out = serve_dir("in", names)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    routes = all_routes()
    want_routes = {"dw_conv3": PATH_ROUTES if name == "mednext" else [], "dw_conv3_wgrad": [],
                   "window_attention": ATTN_PATH_ROUTES if name == "micformer" else [],
                   "window_attention_backward": [], "fused_window_attention": [],
                   "fused_window_attention_backward": []}
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
           "launches_per_request": per_request, "routes": routes}
    log(f"serve: {name} {len(lat)} warm volumes 2x160³ bf16 roi 128 sw_batch 4: p50 "
        f"{res['p50_s']:.4f} s, {res['vol_per_s']:.3f} vol/s, latencies {lat}, "
        f"cold first request {cold:.4f} s, peak {peak / 2 ** 30:.2f} GiB, "
        f"launches {launches}, per request {per_request}, routes {routes}")
    if (len(lat) != 3 or per_request != [want] * 3
            or launches != {k: 3 * n for k, n in want.items()} or routes != want_routes):
        raise AssertionError(f"serve {name}: {len(lat)} requests, launches {launches}, "
                             f"per request {per_request} (want 3 requests of {want}), "
                             f"routes {routes} (want {want_routes})")
    return res


def phase_predict(work):
    """cli/predict, cli/ensemble, cli/evaluate and serve --run-dir from the
    runs phase_train left, at full width on a second synthetic root (15
    cases of 48³: two in the test split), each predict f32 at 160³, roi 128,
    overlap 0.5, sw_batch 4 (8 tiles, 2 chunks), mirror TTA (8 flips).
    Each run's launches are exact: tiles, chunks, flips and folds times a
    forward's launches; counts, routes and peak memory are reset just before
    each run and read just after. Each output is evaluated in-process right
    after it is written, and timed alone."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.cli import ensemble, evaluate, predict, serve
    from micformer_tpu_torch.data.image_utils import label_to_one_hot
    from micformer_tpu_torch.data.mmwhs import get_datasets
    from micformer_tpu_torch.data.nifti import read_nifti, write_nifti
    from micformer_tpu_torch.data.synthetic import write_synthetic_dataset
    from micformer_tpu_torch.infer import sliding_window_inference
    from micformer_tpu_torch.infer.sliding_window import compute_steps_monai
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    data, cache = os.path.join(work, "mmwhs_predict"), os.path.join(work, "cache_predict")
    write_synthetic_dataset(data, n_cases=15, shape=(48, 48, 48), seed=1)
    runs = {n: os.path.join(work, n) for n in ("run", "run_fused", "run_mednext")}
    size, roi, sw = 160, 128, 4
    tiles = math.prod(len(a) for a in compute_steps_monai((size,) * 3, (roi,) * 3, 0.5))
    chunks, flips = -(-tiles // sw), 8
    # the launches of one forward of each run's model
    forward = {"run": PATHS["micformer"]["slice"],
               "run_fused": expect(fused_window_attention=96),
               "run_mednext": PATHS["mednext"]["slice"]}
    f32_routes = {"run": {"window_attention": ["ffma"]},
                  "run_fused": {"fused_window_attention": ["ffma"]},
                  "run_mednext": {"dw_conv3": PATH_ROUTES}}
    grid = ["--data", data, "--cache", cache, "--target-shape", str(size), "--roi", str(roi),
            "--overlap", "0.5", "--sw-batch-size", str(sw), "--mirror-tta", "--workers", "2"]
    saved = ["--largest-cc", "--save-softmax", "--save-seg-for-next-stage", "--overlays"]
    # (name, run dirs, extra arguments, batched TTA)
    plan = [("micformer serial", ["run"], saved, False),
            ("micformer batched", ["run"], saved, True),
            ("micformer fused", ["run_fused"], saved, False),
            ("mednext native", ["run_mednext"], ["--native-geometry", "--largest-cc"], False),
            ("two-fold ensemble", ["run", "run_fused"], ["--largest-cc"], False)]
    res = {"tiles": tiles, "chunks": chunks, "flips": flips}
    gt = {"model": os.path.join(work, "gt_model"), "native": os.path.join(work, "gt_native")}

    def evaluate_dir(out, gt_dir):
        """cli/evaluate --json --regions on `out`, timed alone, and its JSON
        checked: every case, Dice in [0, 1], HD95 finite exactly when the
        class is in both maps (else nan, the evaluator's value)."""
        summary_path = os.path.join(out, "summary.json")
        t0 = time.perf_counter()
        evaluate.main(["--pred", out, "--gt", gt_dir, "--json", summary_path, "--regions"])
        seconds = time.perf_counter() - t0
        with open(summary_path) as f:
            summary = json.load(f)
        cases = summary["results"]["all"]
        bad = [(i, c, m) for i, case in enumerate(cases) for c, m in case.items()
               if not 0.0 <= m["Dice"] <= 1.0
               or (math.isfinite(m["Hausdorff Distance 95"])
                   != (m["True Positives"] + m["False Positives"] > 0
                       and m["True Positives"] + m["False Negatives"] > 0))]
        if len(cases) != len(pids) or bad or "regions" not in summary:
            raise AssertionError(f"evaluate {out}: {len(cases)} cases, bad entries {bad}")
        name = os.path.basename(out)
        res[f"evaluate {name}"] = {"seconds": seconds, "s_per_case": seconds / len(cases)}
        log(f"evaluate {name}: {len(cases)} cases in {seconds:.2f} s "
            f"({seconds / len(cases):.2f} s a case), whole-heart region Dice "
            f"{summary['regions']['dc']['whole heart']['mean']:.4f}")

    _, _, test_ds = get_datasets(data, cache_dir=cache, target_shape=(size,) * 3)
    os.makedirs(gt["model"])
    os.makedirs(gt["native"])
    for i in range(len(test_ds)):
        s = test_ds[i]
        pid = s["patient_id"]
        write_nifti(os.path.join(gt["model"], f"{pid}_gt.nii.gz"),
                    np.argmax(s["label"], axis=0).astype(np.uint8))
        native = label_to_one_hot(read_nifti(test_ds.cases[i].ct_label))
        write_nifti(os.path.join(gt["native"], f"{pid}_gt.nii.gz"),
                    np.argmax(native, axis=0).astype(np.uint8))
    pids = [test_ds.cases[i].patient_id for i in range(len(test_ds))]
    if len(pids) != 2:
        raise AssertionError(f"predict: test split of {pids}, want two cases")

    outs = {}
    for name, run_names, extra, batched in plan:
        out = os.path.join(work, "pred_" + name.split()[-1])
        outs[name] = out
        # every fold runs the model of the first run's config.json, as
        # the JAX CLI rebuilds it: the ensemble runs K1 for both folds
        first = run_names[0]
        want = {k: len(pids) * len(run_names) * forward[first][k] * chunks
                * (1 if batched else flips) for k in KERNELS}
        want_routes = {k: f32_routes[first].get(k, []) for k in KERNELS}
        if batched:
            os.environ["MICFORMER_TTA_BATCHED"] = "1"
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_all_routes()
        t0 = time.perf_counter()
        try:
            recs = predict.main(grid + extra + ["--out", out, "--run-dirs"]
                                + [runs[r] for r in run_names])
        finally:
            os.environ.pop("MICFORMER_TTA_BATCHED", None)
        wall = time.perf_counter() - t0
        launches, routes = dict(LAUNCHES), all_routes()
        peak = torch.cuda.max_memory_allocated()
        per_case = [r["launches"] for r in recs]
        res[name] = {"wall_s": wall, "case_s": [r["seconds"] for r in recs],
                     "infer_s": [r["infer_seconds"] for r in recs],
                     "launches": launches, "launches_per_case": per_case[0],
                     "routes": routes, "max_memory_allocated": peak}
        log(f"predict {name}: {len(recs)} cases 2x{size}³ f32 roi {roi} sw_batch {sw}, "
            f"{'batched' if batched else 'serial'} TTA, folds {run_names}: seconds a case "
            f"{res[name]['case_s']} (inference to the label map on the host "
            f"{res[name]['infer_s']}), wall {wall:.2f} s, peak {peak / 2 ** 30:.2f} GiB, "
            f"launches {launches}, per case {per_case}, routes {routes}")
        half = {k: n // len(pids) for k, n in want.items()}
        if (sorted(r["patient_id"] for r in recs) != sorted(pids) or launches != want
                or per_case != [half] * len(pids) or routes != want_routes):
            raise AssertionError(f"predict {name}: cases {[r['patient_id'] for r in recs]}, "
                                 f"launches {launches} (want {want}), per case {per_case}, "
                                 f"routes {routes} (want {want_routes})")
        for pid in pids:
            seg = read_nifti(os.path.join(out, f"{pid}_pred.nii.gz"))
            shape = (48,) * 3 if "--native-geometry" in extra else (size,) * 3
            if seg.shape != shape or seg.dtype != np.uint8 or seg.max() >= 8:
                raise AssertionError(f"predict {name}: {pid} segmentation {seg.shape} "
                                     f"{seg.dtype} max {seg.max()}")
        evaluate_dir(out, gt["native" if "--native-geometry" in extra else "model"])

    # the batched TTA's softmax against the serial one's, and the serial
    # one against a direct sliding-window call on the same checkpoint
    def softmax(name, pid):
        return np.load(os.path.join(outs[name], f"{pid}_softmax.npz"))["softmax"].astype(
            np.float32)

    diff = max(np.abs(softmax("micformer serial", p) - softmax("micformer batched", p)).max()
               for p in pids)
    model = registry.build("micformer", device="cuda")
    model.load_state_dict(torch.load(os.path.join(runs["run"], "ckpt_best_dice.pt"),
                                     map_location="cpu", weights_only=True)["params"])
    s = test_ds[0]
    # cuDNN without TF32, so phase 9's sharded-tile prediction of this case
    # (one tile a call) can be held against it at 1e-4
    torch.backends.cudnn.allow_tf32 = False
    logits = sliding_window_inference(
        torch.tensor(s["image"][None], device="cuda"), (roi,) * 3, model, num_classes=8,
        overlap=0.5, sw_batch_size=sw, mirror_tta=True, tta_batched=False)
    torch.backends.cudnn.allow_tf32 = True
    direct = torch.softmax(logits, dim=1)[0].cpu().numpy()
    res["direct"] = {"patient_id": s["patient_id"], "softmax": direct}
    ddiff = float(np.abs(direct - softmax("micformer serial", s["patient_id"])).max())
    res["serial_vs_batched_max_abs"], res["serial_vs_direct_max_abs"] = float(diff), ddiff
    log(f"predict: softmax max |d| serial vs batched TTA {diff:.3g}, serial vs a direct "
        f"sliding_window_inference on ckpt_best_dice.pt {ddiff:.3g} (limit 2e-3 each)")
    if not (diff <= 2e-3 and ddiff <= 2e-3):
        raise AssertionError(f"predict: softmax differs: batched {diff}, direct {ddiff}")
    del model, logits

    ens = os.path.join(work, "pred_cli_ensemble")
    ensemble.main(["--inputs", outs["micformer serial"], outs["micformer fused"],
                   "--out", ens, "--largest-cc"])
    for pid in pids:
        if read_nifti(os.path.join(ens, f"{pid}_pred.nii.gz")).shape != (size,) * 3:
            raise AssertionError(f"ensemble: bad segmentation for {pid}")
    evaluate_dir(ens, gt["model"])

    # serve the MedNeXt run: two NIfTI pairs and one .npy request
    watch, served = os.path.join(work, "serve_run_in"), os.path.join(work, "serve_run_out")
    os.makedirs(watch)
    for pid in pids:
        for mod in ("ct", "mr"):
            shutil.copy(os.path.join(data, f"{mod}_{pid}_image.nii.gz"), watch)
    np.save(os.path.join(watch, "vol.npy"), np.random.default_rng(3).normal(
        size=(2, size, size, size)).astype(np.float32))
    for f in os.listdir(watch):
        os.utime(os.path.join(watch, f), (time.time() - 5,) * 2)
    reset_launches()
    reset_all_routes()
    lat = serve.main(["--run-dir", runs["run_mednext"], "--ckpt-tag", "best_dice", "--bf16",
                      "--watch", watch, "--out", served, "--target-shape", str(size),
                      "--roi", str(roi), "--overlap", "0.5", "--sw-batch-size", str(sw),
                      "--max-requests", "3", "--poll", "0.05", "--idle-exit", "300"])
    launches, routes = dict(LAUNCHES), all_routes()
    names = [f"ct_{pid}" for pid in pids] + ["vol"]
    per_request = []
    for n in names:
        if read_nifti(os.path.join(served, f"{n}_seg.nii.gz")).shape != (size,) * 3:
            raise AssertionError(f"serve --run-dir: bad segmentation for {n}")
        with open(os.path.join(served, f"{n}.done")) as f:
            per_request.append(json.load(f)["launches"])
    want = PATHS["mednext"]["request"]
    want_routes = {k: PATH_ROUTES if k == "dw_conv3" else [] for k in KERNELS}
    res["serve_run_dir"] = {"latency_s": lat, "launches": launches,
                            "launches_per_request": per_request, "routes": routes}
    log(f"serve --run-dir run_mednext bf16: requests {names}, latencies {lat}, launches "
        f"{launches}, per request {per_request}, routes {routes}")
    if per_request != [want] * 3 or routes != want_routes:
        raise AssertionError(f"serve --run-dir: launches per request {per_request} (want "
                             f"{want}), routes {routes} (want {want_routes})")

    res["wall_s"] = time.perf_counter() - t_phase
    log(f"predict phase: {res['wall_s']:.2f} s")
    return res


def phase_train_rest(work):
    """Phase 8: the rest of the trainer on phase 6's root at full width in
    bf16, one epoch a run (batch 1 MicFormer, batch 2 MedNeXt-S as
    configs/mednext_s_mmwhs.yaml), each checked by train_run; then find_lr,
    the cascade's predict, run export and a profiler trace of one step."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.cli import predict
    from micformer_tpu_torch.convert.pretrained import load_pretrained_state
    from micformer_tpu_torch.data.cascade import resize_seg_nearest
    from micformer_tpu_torch.data.loader import DataLoader
    from micformer_tpu_torch.data.mmwhs import get_datasets
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from micformer_tpu_torch.train import profiling, run_export
    from micformer_tpu_torch.train.checkpoint import CheckpointManager
    from micformer_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    data, cache = os.path.join(work, "mmwhs"), os.path.join(work, "cache")
    size = TRAIN_SIZE
    splits = get_datasets(data, cache_dir=cache, target_shape=(size,) * 3)
    # the previous stage's maps, standing in for a low-resolution stage: each
    # case's label map taken to half the grid (64³; back to 128³ by the
    # cascade dataset)
    prev = os.path.join(work, "prev_stage")
    os.makedirs(prev)
    for ds in splits:
        for i in range(len(ds)):
            s = ds[i]
            np.save(os.path.join(prev, f"{s['patient_id']}_segFromPrevStage.npy"),
                    resize_seg_nearest(np.argmax(s["label"], axis=0).astype(np.uint8),
                                       (size // 2,) * 3))
    common = ["--data", data, "--cache", cache, "--target-shape", str(size), "--bf16",
              "--val", "1", "--workers", "2", "--epochs", "1"]
    micformer = ["--model", "micformer"]
    mednext = ["--cfg", os.path.join(ROOT, "configs", "mednext_s_mmwhs.yaml")]   # batch 2
    src = os.path.join(work, "run")       # phase 6's MicFormer run
    # (name, run dir, arguments, TRAIN_STEP key, batch, (steps run, step reached),
    # the model's input channels)
    plan = [("micformer gdl", "run8_gdl", micformer + ["--loss", "gdl"], False, 1, (4, 4), 2),
            ("micformer pretrained focal", "run8_pretrained",
             micformer + ["--pretrained", f"{src}:best_dice", "--loss", "focal"], False, 1,
             (4, 4), 2),
            ("mednext oversample-fg dice_topk", "run8_oversample",
             mednext + ["--oversample-fg", "0.33", "--loss", "dice_topk"], "mednext", 2, (2, 2),
             2),
            ("mednext cascade mcc", "run8_cascade",
             mednext + ["--cascade-prev-seg-dir", prev, "--loss", "mcc"], "mednext", 2, (2, 2),
             9),
            ("mednext single-modal process dice_bce", "run8_single",
             mednext + ["--single-modal", "--worker-mode", "process", "--loss", "dice_bce"],
             "mednext", 2, (2, 2), 1)]
    res = {}
    for name, rdir, args, key, batch, want_steps, channels in plan:
        run = os.path.join(work, rdir)
        res[name], trainer = train_run(name, common + args + ["--run-dir", run], key, batch,
                                       want_steps)
        model = trainer.model
        stem = model.stem.weight if key == "mednext" else None
        if stem is not None and stem.shape[1] != channels:
            raise AssertionError(f"train {name}: stem takes {stem.shape[1]} channels, want "
                                 f"{channels}")
        if "--pretrained" in args:
            # the same rule on a fresh model: out_conv alone is skipped
            fresh = registry.build("micformer", device="cpu").state_dict()
            _, report = load_pretrained_state(
                fresh, CheckpointManager(src).restore_params_only("best_dice"))
            logged = [json.loads(line) for line in open(os.path.join(run, "log.jsonl"))]
            counts = next(r["pretrained"] for r in logged if "pretrained" in r)
            skipped = sorted(e.split(":")[0] for e in report["skipped"])
            res[name]["pretrained"] = counts
            log(f"train {name}: pretrained {counts}, skipped {skipped}")
            if (skipped != ["out_conv.bias", "out_conv.weight"] or report["missing"]
                    or counts != {k: len(v) for k, v in report.items()}
                    or counts["loaded"] != len(fresh) - 2):
                raise AssertionError(f"train {name}: pretrained {counts}, skipped {skipped}, "
                                     f"missing {report['missing']}")
        del trainer, model
        torch.cuda.empty_cache()

    # find_lr: eight iterations of MicFormer with the topk loss
    train_ds = splits[0]
    loader = DataLoader(train_ds, batch_size=1, shuffle=True, seed=0, workers=2)
    model = registry.build("micformer", device="cuda", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, TrainConfig(run_dir=os.path.join(work, "run8_find_lr"), loss="topk",
                                         bf16=True, steps_per_epoch=len(loader),
                                         roi=(size,) * 3))
    before = {k: v.clone() for k, v in model.state_dict().items()}

    class Marked:
        """The loader, noting the launch counts and the clock as each batch
        is handed out (after the previous iteration's loss was read)."""

        def __init__(self):
            self.marks = []

        def __iter__(self):
            for item in loader:
                self.marks.append((dict(LAUNCHES), time.perf_counter()))
                yield item

    marked = Marked()
    reset_launches()
    reset_all_routes()
    lrs, losses = trainer.find_lr(marked, num_iters=8)
    marks = marked.marks[:8] + [(dict(LAUNCHES), time.perf_counter())]
    per_iter = [{k: b[0][k] - a[0][k] for k in KERNELS} for a, b in zip(marks, marks[1:])]
    secs = [b[1] - a[1] for a, b in zip(marks, marks[1:])]
    routes = all_routes()
    unchanged = all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    res["find_lr"] = {"lrs": lrs, "losses": losses, "s_per_iter": secs,
                      "launches_per_iter": per_iter, "routes": routes}
    log(f"find_lr micformer topk bf16: lrs {lrs}, smoothed losses {losses}, seconds an "
        f"iteration {secs}, launches per iteration {per_iter[0]}, routes {routes}, weights "
        f"unchanged {unchanged}")
    want_routes = {k: ATTN_PATH_ROUTES if k in ("window_attention", "window_attention_backward")
                   else [] for k in KERNELS}
    if (len(lrs) != 8 or not all(np.isfinite(losses)) or lrs != sorted(lrs)
            or per_iter != [TRAIN_STEP[False]] * 8 or routes != want_routes or not unchanged):
        raise AssertionError(f"find_lr: lrs {lrs}, losses {losses}, launches {per_iter}, "
                             f"routes {routes}, weights unchanged {unchanged}")

    # a profiler trace of one training step names K1 and K1-bwd
    images, labels, _ = next(iter(loader))
    loader.close()
    with profiling.trace(os.path.join(work, "trace")) as prof:
        trainer.train_step(images, labels)
    kernels = {}
    for evt in prof.key_averages():
        for name in ("window_attention_kernel", "window_attention_backward_kernel"):
            if name in evt.key and "fused" not in evt.key:
                kernels[name] = kernels.get(name, 0) + evt.count
    res["trace"] = kernels
    log(f"profiling.trace of one MicFormer step: K1 and K1-bwd kernel events {kernels}")
    if kernels != {"window_attention_kernel": 96, "window_attention_backward_kernel": 96}:
        raise AssertionError(f"trace: K1 and K1-bwd events {kernels} (want 96 each)")
    del trainer, model
    torch.cuda.empty_cache()

    # predict from the cascade run, with the same previous-stage maps
    out = os.path.join(work, "pred8_cascade")
    reset_launches()
    reset_all_routes()
    recs = predict.main(["--data", data, "--cache", cache, "--target-shape", str(size),
                         "--roi", str(size), "--sw-batch-size", "1", "--workers", "2",
                         "--cascade-prev-seg-dir", prev, "--out", out,
                         "--run-dirs", os.path.join(work, "run8_cascade")])
    launches, routes = dict(LAUNCHES), all_routes()
    res["cascade predict"] = {"case_s": [r["seconds"] for r in recs],
                              "infer_s": [r["infer_seconds"] for r in recs],
                              "launches": launches, "routes": routes}
    log(f"predict cascade (9 input channels, f32, {size}³ roi {size}): cases "
        f"{[r['patient_id'] for r in recs]}, seconds a case {res['cascade predict']['case_s']} "
        f"(to the label map {res['cascade predict']['infer_s']}), launches {launches}, "
        f"routes {routes}")
    want = {k: len(recs) * n for k, n in PATHS["mednext"]["slice"].items()}
    want_routes = {k: PATH_ROUTES if k == "dw_conv3" else [] for k in KERNELS}
    if len(recs) != len(splits[2]) or launches != want or routes != want_routes:
        raise AssertionError(f"predict cascade: {len(recs)} cases, launches {launches} (want "
                             f"{want}), routes {routes} (want {want_routes})")
    for r in recs:
        seg = read_nifti(os.path.join(out, f"{r['patient_id']}_pred.nii.gz"))
        if seg.shape != (size,) * 3 or seg.dtype != np.uint8 or seg.max() >= 8:
            raise AssertionError(f"predict cascade: {r['patient_id']} segmentation "
                                 f"{seg.shape} {seg.dtype} max {seg.max()}")
    # the phase's runs in one CSV
    dirs = [os.path.join(work, rdir) for _, rdir, *_ in plan] + [os.path.join(work,
                                                                               "run8_find_lr")]
    csv_path = run_export.export_runs_csv(dirs, os.path.join(work, "runs8.csv"))
    with open(csv_path) as f:
        rows = [line.rstrip("\n").split(",") for line in f][1:]
    per_run = {os.path.basename(d): sum(r[0] == os.path.basename(d) for r in rows) for d in dirs}
    res["export_rows"] = per_run
    log(f"run_export: {len(rows)} rows in {csv_path}: {per_run}")
    if not all(per_run[os.path.basename(d)] > 0 for d in dirs[:-1]):
        raise AssertionError(f"run_export: rows per run {per_run}")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"train, the rest (phase 8): {res['wall_s']:.2f} s")
    return res


# phase 9: data parallelism. NCCL runs at world size 1 in this process; the
# multi-rank runs put two ranks on the one card over gloo (NCCL takes one
# rank a device). The ranks read their device and sizes from their spec, so
# a CPU rehearsal can set PARALLEL_DEVICE "cpu", smaller sizes and zero
# launch counts here.
PARALLEL_DEVICE = "cuda"
PARALLEL_SIZE = 128          # (a), (c): MicFormer's steps; (b), (e): the training volumes
SHARDED_SIZE, SHARDED_ROI = 160, 128    # (d): phase 7's grid
RANK_THREADS = 3             # torch threads a rank: two ranks and this process share 8 cores
PARALLEL_TRAIN = {"micformer": expect(window_attention=96, window_attention_backward=96),
                  "mednext": expect(dw_conv3=36, dw_conv3_wgrad=18),
                  "generic_unet": expect()}


def _set_tf32(on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def _grads(model):
    return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}


def _params(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _random_batch(batch, size, seed):
    """A loader batch: f16 images [batch, 2, size³], uint8 class maps."""
    rng = np.random.default_rng(seed)
    shape = (size,) * 3
    return (torch.from_numpy(rng.uniform(0, 1, (batch, 2) + shape).astype(np.float16)),
            torch.from_numpy(rng.integers(0, 8, (batch,) + shape).astype(np.uint8)))


def _parity_trainer(run_dir, device, mesh=None, bf16=False):
    """Full-width MicFormer from seed 0 under SGD-Nesterov (lr 1e-2),
    constant schedule, no augmentation: the trainer of (a) and (c)."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.train.trainer import TrainConfig, Trainer

    model = registry.build("micformer", device=device, generator=torch.Generator().manual_seed(0))
    return Trainer(model, TrainConfig(run_dir=run_dir, optimizer="sgd_nesterov", lr=1e-2,
                                      scheduler="constant", augment="none", mesh=mesh,
                                      bf16=bf16))


def _profiled_step(trainer, batch):
    """One more train step under torch.profiler: its all-reduce events by
    name (count, host ms, device ms), and their total over the backend's own
    work events ("gloo:..." or "nccl:..."; the dispatcher's `c10d::` events
    wrap them and are not added again)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        trainer.train_step(*batch)
    by_key, device = {}, 0.0
    for evt in prof.key_averages():
        key = evt.key.lower()
        if "all_reduce" in key or "allreduce" in key:
            dev = getattr(evt, "device_time_total", 0.0) / 1e3
            by_key[evt.key] = (evt.count, evt.cpu_time_total / 1e3, dev)
            if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
                device += dev       # a collective's kernel (NCCL's), counted once
    work = [v for k, v in by_key.items() if k.lower().startswith(("gloo:", "nccl:"))]
    return {"events": sum(v[0] for v in work), "host_ms": sum(v[1] for v in work),
            "device_ms": device, "by_name": by_key}


def parallel_nccl(work):
    """(a) NCCL at world size 1 in this process: a DDP-wrapped MicFormer
    step (b1 at PARALLEL_SIZE³, f32, TF32 off) against the plain step from
    the same weights and batch; the bf16 step's warm ms both ways (and the
    DDP step's all-reduce); then the single-process b2 step that (c) is held
    against, saved."""
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from micformer_tpu_torch.parallel import distributed

    dev = distributed.initialize(PARALLEL_DEVICE, init_method=f"file://{work}/nccl_store",
                                 world_size=1, rank=0)
    backend = torch.distributed.get_backend()
    res = {"backend": backend}
    try:
        _set_tf32(False)
        batch = _random_batch(2, PARALLEL_SIZE, 9)
        b1 = (batch[0][:1], batch[1][:1])
        out = {}
        for mesh in ("data=1", None):
            tr = _parity_trainer(os.path.join(work, f"run9a_{mesh}"), dev, mesh)
            reset_launches()
            rec = tr.train_step(*b1)
            out[mesh] = (rec["loss"], _grads(tr.model), dict(LAUNCHES), tr.net is not tr.model)
            del tr
        (l_ddp, g_ddp, n_ddp, wrapped), (l_plain, g_plain, n_plain, _) = out["data=1"], out[None]
        bitwise = l_ddp == l_plain and all(torch.equal(g_ddp[n], g) for n, g in g_plain.items())
        worst = max((g_ddp[n] - g).abs().max().item() for n, g in g_plain.items())
        top = max(g.abs().max().item() for g in g_plain.values())
        res.update(loss_ddp=l_ddp, loss_plain=l_plain, bitwise=bitwise,
                   max_abs_grad_diff=worst, max_abs_grad=top, launches=n_ddp)
        log(f"parallel (a) {backend} at world size 1, DDP-wrapped {wrapped}: MicFormer b1 "
            f"{PARALLEL_SIZE}³ f32 step, loss DDP {l_ddp!r} plain {l_plain!r}, gradients "
            f"{'bitwise equal' if bitwise else f'max |d| {worst:.3g}, not bitwise'} (max |g| "
            f"{top:.3g}; limit 1e-6·max|g|), launches {n_ddp}")
        want_backend = "nccl" if PARALLEL_DEVICE == "cuda" else "gloo"
        if (not wrapped or backend != want_backend or abs(l_ddp - l_plain) > 1e-6 * abs(l_plain)
                or worst > 1e-6 * top or n_ddp != PARALLEL_TRAIN["micformer"]
                or n_plain != PARALLEL_TRAIN["micformer"]):
            raise AssertionError(f"parallel (a): {res}, plain launches {n_plain}")
        _set_tf32(True)
        for mesh in ("data=1", None):
            tr = _parity_trainer(os.path.join(work, f"run9a_bf16_{mesh}"), dev, mesh, bf16=True)
            for _ in range(7):
                tr.train_step(*b1)
            kind = "ddp" if mesh else "plain"
            res[f"bf16_first_step_s_{kind}"] = tr.history[0]["seconds"]
            res[f"bf16_warm_ms_{kind}"] = 1e3 * statistics.mean(
                r["seconds"] for r in tr.history[1:])
            if mesh:
                res["allreduce"] = _profiled_step(tr, b1)
                res["grad_allreduce_ms"] = _time_allreduce(tr)
            del tr
        log(f"parallel (a) bf16 b1 step, warm ms (mean of 6): DDP {res['bf16_warm_ms_ddp']:.2f}, "
            f"plain {res['bf16_warm_ms_plain']:.2f}; first step DDP "
            f"{res['bf16_first_step_s_ddp']:.3f} s, plain {res['bf16_first_step_s_plain']:.3f} "
            f"s; the DDP step's all-reduce events {res['allreduce']}; one gradient-sized "
            f"all-reduce {res['grad_allreduce_ms']:.3f} ms")
        _set_tf32(False)
        tr = _parity_trainer(os.path.join(work, "run9c_single"), dev)
        rec = tr.train_step(*batch)
        torch.save({"loss": rec["loss"], "grads": _grads(tr.model), "params": _params(tr.model)},
                   os.path.join(work, "parity_single.pt"))
        del tr
    finally:
        _set_tf32(True)
        distributed.shutdown()
        if PARALLEL_DEVICE == "cuda":
            torch.cuda.empty_cache()
    return res


def _rank_run(device, fn):
    """fn() with launches, routes and peak memory reset before and read
    after: (its result, its numbers)."""
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_all_routes()
    t0 = time.perf_counter()
    out = fn()
    return out, {"wall_s": time.perf_counter() - t0, "launches": dict(LAUNCHES),
                 "routes": all_routes(),
                 "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else 0}


def _time_allreduce(trainer, reps=3):
    """ms of one all-reduce of a flat f32 buffer as large as the model's
    gradients: the host clock around dist.all_reduce and a synchronise, the
    mean of `reps` after a warm-up. gloo runs its work on a thread of its
    own, whose profiler events carry no host time; this times the
    collective whole (without DDP's overlap with the backward)."""
    buf = torch.zeros(sum(p.numel() for p in trainer.params), device=trainer.device)
    cuda = trainer.device.type == "cuda"
    times = []
    for _ in range(reps + 1):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.distributed.all_reduce(buf)
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.mean(times[1:])


def _rank_train(rank, world, device, spec, argv, local_batch):
    """(b) cli/train.main(argv) on this rank: per step its loss, launches and
    seconds; the all-reduce events of one more, profiled step; and one
    gradient-sized all-reduce timed alone."""
    from micformer_tpu_torch.cli import train

    trainer, res = _rank_run(device, lambda: train.main(argv))
    hist = trainer.history
    res.update(losses=[r["loss"] for r in hist], skipped=[r["skipped"] for r in hist],
               step_launches=[r["launches"] for r in hist], step=trainer.step,
               first_step_s=hist[0]["seconds"], zero1=trainer.zero1,
               ddp=trainer.net is not trainer.model,
               warm_ms=1e3 * statistics.mean(r["seconds"] for r in hist[1:]))
    res["allreduce"] = _profiled_step(trainer, _random_batch(local_batch, spec["size"], rank))
    res["grad_allreduce_ms"] = _time_allreduce(trainer)
    return res


def _rank_parity(rank, world, device, spec):
    """(c) the two-rank MicFormer step (f32, TF32 off) on this rank's rows of
    the global batch of 2; rank 0 saves its gradients and parameters."""
    from micformer_tpu_torch.parallel.mesh import rank_rows

    _set_tf32(False)
    try:
        tr = _parity_trainer(os.path.join(spec["work"], "run9c_ranks"), device, f"data={world}")
        images, labels = _random_batch(2, spec["size"], 9)
        rows = rank_rows(2, rank, world)
        rec, res = _rank_run(device, lambda: tr.train_step(images[rows], labels[rows]))
        res.update(loss=rec["loss"], seconds=rec["seconds"])
        if rank == 0:
            torch.save({"grads": _grads(tr.model), "params": _params(tr.model)},
                       os.path.join(spec["work"], "parity_ranks.pt"))
        del tr
    finally:
        _set_tf32(True)
    return res


def _run_model(run, device):
    """A run's model (config.json) with its best_dice weights."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.config import run_model
    from micformer_tpu_torch.train.checkpoint import CheckpointManager

    name, kwargs = run_model(run)
    model = registry.build(name, device=device, **kwargs)
    model.load_state_dict(CheckpointManager(run).restore_params_only("best_dice"))
    return model


def _case(data, cache, size):
    """The first test case of a root at size³: (patient id, [1, 2, size³])."""
    from micformer_tpu_torch.data.mmwhs import get_datasets

    s = get_datasets(data, cache_dir=cache, target_shape=(size,) * 3)[2][0]
    return s["patient_id"], torch.tensor(np.asarray(s["image"], np.float32)[None])


def _rank_predict(rank, world, device, spec, argv, run, data, cache, size, engine):
    """(d), (e) cli/predict.main(argv) on this rank (cuDNN without TF32),
    then the engine called directly on the root's first test case; rank 0
    saves the direct call's f32 result."""
    from micformer_tpu_torch.cli import predict
    from micformer_tpu_torch.infer import sliding_window_inference_sharded
    from micformer_tpu_torch.parallel.spatial import spatial_sharded_apply

    _set_tf32(False)
    try:
        recs, res = _rank_run(device, lambda: predict.main(argv))
        res["records"] = recs
        model = _run_model(run, device)
        pid, vol = _case(data, cache, size)
        t0 = time.perf_counter()
        if engine == "sharded":
            out = torch.softmax(sliding_window_inference_sharded(
                vol.to(device), (SHARDED_ROI,) * 3, model, mirror_tta=True), dim=1)
        else:
            out = spatial_sharded_apply(model, vol.to(device))
        res["direct_s"] = time.perf_counter() - t0
        if rank == 0:
            np.save(os.path.join(spec["work"], f"{engine}_direct.npy"), out[0].cpu().numpy())
        res["patient_id"] = pid
        del model, out
    finally:
        _set_tf32(True)
    return res


RANK_TASKS = {"train": _rank_train, "parity": _rank_parity, "predict": _rank_predict}


def _rank_main(rank, world, spec):
    """One rank of phase 9: joins the group as torchrun's variables say
    (gloo: the ranks share the card), runs the spec's tasks in order and
    saves their results."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(spec["port"]))
    torch.set_num_threads(RANK_THREADS)
    from micformer_tpu_torch.parallel import distributed

    device = distributed.initialize(spec["device"])
    out = {"device": str(device), "backend": torch.distributed.get_backend()}
    try:
        for kind, name, kw in spec["tasks"]:
            t0 = time.perf_counter()
            out[name] = RANK_TASKS[kind](rank, world, device, spec, **kw)
            print(f"rank {rank}: {name} in {time.perf_counter() - t0:.2f} s", flush=True)
        torch.save(out, os.path.join(spec["work"], f"rank9_{rank}.pt"))
    finally:
        distributed.shutdown()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _check_rank_train(name, outs, key, steps, zero1):
    """(b): every rank ran `steps` steps (to step `steps`), each loss finite,
    applied and equal on both ranks, each step's launches exact, the routes
    the path's, DDP on and ZeRO-1 as asked."""
    want = PARALLEL_TRAIN[key]
    dw = PATH_ROUTES if key == "mednext" else []
    k1 = ATTN_PATH_ROUTES if key == "micformer" else []
    want_routes = {k: dw if k.startswith("dw_conv3") else k1 if k.startswith("window") else []
                   for k in KERNELS}
    for r, o in enumerate(outs):
        log(f"parallel (b) {name}, rank {r}: {len(o['losses'])} steps to step {o['step']}, "
            f"losses {o['losses']}, first step {o['first_step_s']:.3f} s, warm "
            f"{o['warm_ms']:.2f} ms/step, peak {o['max_memory_allocated'] / 2 ** 30:.2f} GiB, "
            f"wall {o['wall_s']:.2f} s, launches per step {o['step_launches']}, routes "
            f"{o['routes']}, ZeRO-1 {o['zero1']}, all-reduce events of a profiled step "
            f"{o['allreduce']}, one gradient-sized all-reduce {o['grad_allreduce_ms']:.2f} ms")
        if (len(o["losses"]) != steps or o["step"] != steps or not o["ddp"]
                or o["zero1"] != zero1 or any(o["skipped"])
                or not all(np.isfinite(o["losses"])) or o["step_launches"] != [want] * steps
                or o["routes"] != want_routes):
            raise AssertionError(f"parallel (b) {name}, rank {r}: {o} (want {want} a step, "
                                 f"routes {want_routes})")
    if outs[0]["losses"] != outs[1]["losses"]:
        raise AssertionError(f"parallel (b) {name}: the ranks' losses differ: "
                             f"{[o['losses'] for o in outs]}")


def phase_parallel(work, direct):
    """Phase 9: data parallelism, see the module docstring. `direct`: phase
    7's serial f32 softmax of the first test case of its root."""
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.infer.sliding_window import compute_steps_monai

    t_phase = time.perf_counter()
    size = PARALLEL_SIZE
    res = {"nccl": parallel_nccl(work)}
    data, cache = os.path.join(work, "mmwhs"), os.path.join(work, "cache")
    dev = ["--device", PARALLEL_DEVICE]
    common = dev + ["--data", data, "--cache", cache, "--target-shape", str(size), "--bf16",
                    "--val", "1", "--workers", "2"]
    mednext = ["--cfg", os.path.join(ROOT, "configs", "mednext_s_mmwhs.yaml")]   # batch 2
    runs = {k: os.path.join(work, f"run9_{k}") for k in ("micformer", "mednext", "unet")}
    # (e) GenericUNet at the registry's defaults, one epoch in one process
    res["generic_unet train"], trainer = train_run(
        "generic_unet", common + ["--epochs", "1", "--model", "generic_unet", "--run-dir",
                                  runs["unet"]],
        "generic_unet", 1, (4, 4))
    del trainer
    if PARALLEL_DEVICE == "cuda":
        torch.cuda.empty_cache()

    mesh = ["--epochs", "1", "--mesh", "data=2", "--batch-size", "2"]
    pdata, pcache = os.path.join(work, "mmwhs_predict"), os.path.join(work, "cache_predict")
    spec = {"work": work, "port": _free_port(), "device": PARALLEL_DEVICE, "size": size,
            "tasks": [
                ("train", "micformer", dict(argv=common + mesh + [
                    "--model", "micformer", "--run-dir", runs["micformer"]], local_batch=1)),
                ("train", "mednext", dict(argv=common + mednext + mesh + [
                    "--zero1", "--run-dir", runs["mednext"]], local_batch=1)),
                ("parity", "parity", {}),
                ("predict", "sharded", dict(
                    argv=dev + ["--data", pdata, "--cache", pcache, "--target-shape",
                                str(SHARDED_SIZE), "--roi", str(SHARDED_ROI), "--overlap", "0.5",
                                "--mirror-tta", "--sharded-tiles", "--save-softmax",
                                "--run-dirs", os.path.join(work, "run"),
                                "--out", os.path.join(work, "pred9_tiles")],
                    run=os.path.join(work, "run"), data=pdata, cache=pcache, size=SHARDED_SIZE,
                    engine="sharded")),
                ("predict", "spatial", dict(
                    argv=dev + ["--data", data, "--cache", cache, "--target-shape", str(size),
                                "--engine", "spatial", "--spatial-shards", "2", "--save-softmax",
                                "--run-dirs", runs["unet"],
                                "--out", os.path.join(work, "pred9_spatial")],
                    run=runs["unet"], data=data, cache=cache, size=size, engine="spatial")),
            ]}
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(_rank_main, args=(2, spec), nprocs=2,
                                          start_method="spawn", join=True)
    res["ranks_wall_s"] = time.perf_counter() - t0
    outs = [torch.load(os.path.join(work, f"rank9_{r}.pt"), weights_only=False) for r in (0, 1)]
    log(f"parallel: two ranks on {[o['device'] for o in outs]}, backend "
        f"{[o['backend'] for o in outs]}, {res['ranks_wall_s']:.2f} s")
    if [o["backend"] for o in outs] != ["gloo", "gloo"]:
        raise AssertionError(f"parallel: the ranks' backends {[o['backend'] for o in outs]}")

    # (b) MicFormer, and MedNeXt-S under ZeRO-1: two steps a rank (4 cases,
    # global batch 2), then MedNeXt-S resumed in one process for an epoch
    _check_rank_train("micformer", [o["micformer"] for o in outs], "micformer", 2, False)
    _check_rank_train("mednext --zero1", [o["mednext"] for o in outs], "mednext", 2, True)
    res["train"] = {k: [o[k] for o in outs] for k in ("micformer", "mednext")}
    ckpt = torch.load(os.path.join(runs["mednext"], "ckpt_latest.pt"), map_location="cpu",
                      weights_only=True)
    n_params = len(ckpt["params"])
    opt = ckpt["opt_state"]
    steps_held = sorted({int(s["step"]) for s in opt["state"].values()})
    log(f"parallel (b) the ZeRO-1 run's checkpoint: {len(opt['state'])} optimizer states for "
        f"{n_params} parameter tensors, Adam steps {steps_held}, group keys "
        f"{sorted(k for k in opt['param_groups'][0] if k != 'params')}")
    if len(opt["state"]) != n_params or steps_held != [2] or "betas" not in opt["param_groups"][0]:
        raise AssertionError(f"parallel (b): the ZeRO-1 checkpoint is not consolidated: "
                             f"{len(opt['state'])} states, steps {steps_held}")
    res["mednext resume"], trainer = train_run(
        "mednext --zero1 run resumed in one process",
        common + ["--epochs", "2", "--resume"] + mednext + ["--run-dir", runs["mednext"]],
        "mednext", 2, (2, 4))
    steps_now = sorted({int(s["step"]) for s in trainer.optimizer.state.values()})
    if type(trainer.optimizer) is not torch.optim.Adam or steps_now != [4]:
        raise AssertionError(f"parallel (b) resume: {type(trainer.optimizer)}, steps {steps_now}")
    del trainer

    # (c) the two-rank step against the single process's, f32
    single = torch.load(os.path.join(work, "parity_single.pt"), weights_only=True)
    ranks_ = torch.load(os.path.join(work, "parity_ranks.pt"), weights_only=True)
    losses = [o["parity"]["loss"] for o in outs]
    grad_err = max((ranks_["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-12)
                   for n, g in single["grads"].items())
    param_err = max((ranks_["params"][k] - v).abs().max().item()
                    for k, v in single["params"].items())
    res["parity"] = {"losses": losses, "single_loss": single["loss"], "grad_err": grad_err,
                     "param_err": param_err, "ranks": [o["parity"] for o in outs]}
    log(f"parallel (c) MicFormer {size}³ f32 SGD-Nesterov, two ranks of b1 against one process "
        f"of b2: losses {losses} vs {single['loss']!r}, max over leaves of max|dg|/max|g| "
        f"{grad_err:.3g} (limit 1e-3), parameters after the step max |d| {param_err:.3g} "
        f"(limit 1e-6); rank step s {[o['parity']['seconds'] for o in outs]}, peak GiB "
        f"{[o['parity']['max_memory_allocated'] / 2 ** 30 for o in outs]}")
    if (losses[0] != losses[1] or abs(losses[0] - single["loss"]) > 1e-5 * abs(single["loss"])
            or grad_err > 1e-3 or param_err > 1e-6
            or any(o["parity"]["launches"] != PARALLEL_TRAIN["micformer"] for o in outs)):
        raise AssertionError(f"parallel (c): {res['parity']}")

    # (d) --sharded-tiles: each rank four of the 8 tiles, 8 flips each
    tiles = math.prod(len(a) for a in compute_steps_monai((SHARDED_SIZE,) * 3,
                                                          (SHARDED_ROI,) * 3, 0.5))
    want = expect(window_attention=-(-tiles // 2) * 8 * PATHS["micformer"]["slice"][
        "window_attention"])
    shard = [o["sharded"] for o in outs]
    got = np.load(os.path.join(work, "sharded_direct.npy"))
    d_err = float(np.abs(got - direct["softmax"]).max())
    pid = direct["patient_id"]
    f16 = np.load(os.path.join(work, "pred9_tiles", f"{pid}_softmax.npz"))["softmax"]
    f_err = float(np.abs(f16.astype(np.float32) - direct["softmax"]).max())
    res["sharded"] = {"ranks": [{k: v for k, v in o.items() if k != "records"} for o in shard],
                      "case_s": [[r["seconds"] for r in o["records"]] for o in shard],
                      "direct_err": d_err, "file_err": f_err}
    for r, o in enumerate(shard):
        log(f"parallel (d) cli/predict --sharded-tiles rank {r}: cases "
            f"{[x['patient_id'] for x in o['records']]}, seconds a case "
            f"{[x['seconds'] for x in o['records']]} (to the label map "
            f"{[x['infer_seconds'] for x in o['records']]}), launches per case "
            f"{[x['launches'] for x in o['records']]}, routes {o['routes']}, peak "
            f"{o['max_memory_allocated'] / 2 ** 30:.2f} GiB, wall {o['wall_s']:.2f} s; the "
            f"direct call {o['direct_s']:.2f} s")
    log(f"parallel (d) softmax of {pid} against phase 7's serial f32 prediction: sharded "
        f"f32 max |d| {d_err:.3g} (limit 1e-4), the CLI's f16 file {f_err:.3g} (limit 2e-3)")
    f32_routes = {k: ["ffma"] if k == "window_attention" and want[k] else [] for k in KERNELS}
    if (d_err > 1e-4 or f_err > 2e-3 or direct["patient_id"] != shard[0]["patient_id"]
            or any(len(o["records"]) != 2 or any(x["launches"] != want for x in o["records"])
                   or o["routes"] != f32_routes for o in shard)):
        raise AssertionError(f"parallel (d): {res['sharded']} (want {want} a case)")

    # (e) --engine spatial against one process's forward of the same checkpoint
    spatial = [o["spatial"] for o in outs]
    got = torch.from_numpy(np.load(os.path.join(work, "spatial_direct.npy")))
    _set_tf32(False)
    model = _run_model(runs["unet"], PARALLEL_DEVICE)
    pid, vol = _case(data, cache, size)
    t0 = time.perf_counter()
    with torch.no_grad():
        want_logits = model(vol.to(PARALLEL_DEVICE))[0].cpu()
    single_s = time.perf_counter() - t0
    _set_tf32(True)
    s_err = float((got - want_logits).abs().max())
    seg = read_nifti(os.path.join(work, "pred9_spatial", f"{pid}_pred.nii.gz"))
    res["spatial"] = {"ranks": [{k: v for k, v in o.items() if k != "records"} for o in spatial],
                      "max_abs_err": s_err, "max_abs_logit": float(want_logits.abs().max()),
                      "single_s": single_s}
    for r, o in enumerate(spatial):
        log(f"parallel (e) cli/predict --engine spatial --spatial-shards 2 rank {r}: cases "
            f"{[x['patient_id'] for x in o['records']]}, seconds "
            f"{[x['seconds'] for x in o['records']]} (to the label map "
            f"{[x['infer_seconds'] for x in o['records']]}), peak "
            f"{o['max_memory_allocated'] / 2 ** 30:.2f} GiB; the direct call {o['direct_s']:.2f} s")
    log(f"parallel (e) GenericUNet {size}³ f32 logits, two slabs against one forward "
        f"({single_s:.2f} s): max |d| {s_err:.3g} (limit 2e-4; max |logit| "
        f"{res['spatial']['max_abs_logit']:.3g}); label map {seg.shape} {seg.dtype}")
    if (s_err > 2e-4 or seg.shape != (size,) * 3 or seg.dtype != np.uint8
            or any(len(o["records"]) != 1 or o["launches"] != expect() for o in spatial)):
        raise AssertionError(f"parallel (e): {res['spatial']}")
    del model

    res["wall_s"] = time.perf_counter() - t_phase
    log(f"parallel (phase 9): {res['wall_s']:.2f} s")
    return res


def main():
    smi = phase_device()
    phase_build()
    attn = phase_attention_kernel()
    attn_bwd = phase_attention_backward_kernel()
    fused_fwd, fused_bwd = phase_fused_kernel()
    attn_pass_sums(attn, attn_bwd, fused_fwd, fused_bwd)
    phase_attention_graph()
    dw = phase_dw_kernel()
    dx, wgrad = phase_dw_backward_kernel()
    dw_pass_sums("dw_conv3 (b4 forward)", dw, DW_SHAPES)
    dw_pass_sums("dw_conv3 dx (b2 step)", dx, DW_TRAIN_SHAPES)
    dw_pass_sums("dw_conv3_wgrad (b2 step)", wgrad, DW_TRAIN_SHAPES)
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
        predicted = phase_predict(work)
        phase_train_rest(work)
        phase_parallel(work, predicted["direct"])
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
                **{k: row[k] for k in timed + ("layout", "k", "route") if k in row}}
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
