#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (micformer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any error in any of them fails the run (non-zero exit, no result line):
  1. device  - CUDA must be available; prints nvidia-smi's name and power limit.
  2. build   - nvcc builds every kernel of the serving path from csrc/.
  3. kernels - each kernel against its plain PyTorch version on the card at the
               serving path's shapes, f32 and bf16, in the layouts the path
               hands it (contiguous, and q/k/v as slices of the fused qkv or
               kv projection), with kernel, plain-version, library-call and
               bound times.
  4. slice   - full-width MicFormer (embed 48, depths 2-2-6-2, heads 3-6-12-24,
               seeded random weights), f32 with TF32 off, on one 1x2x64³ input:
               the card (kernel) against the CPU (plain version).
  5. serve   - the same weights in bf16 through the port's serve loop: one
               cold warm-up request, then three [2, 160³] requests, roi 128,
               overlap 0.5, gaussian, sw_batch 4. Launch counts and peak memory
               are reset just before the three and read just after.
  6. lines   - a {"kernels": [...]} line, then the {"ok": true, ...} line last.
"""

from __future__ import annotations

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
KERNELS = {
    "window_attention": {
        "route": "cuda",
        "source": "micformer_tpu_torch/csrc/window_attention.cu",
        "replaces": "micformer_tpu/ops/pallas/window_attention_v2.py:95",
    },
}
# (N, T, h, d): stages 0-3 of a 128³ forward at sw_batch 4, then two ragged cases
ATTN_SHAPES = [(16384, 8, 3, 16), (2048, 8, 6, 16), (256, 8, 12, 16),
               (32, 8, 24, 16), (1000, 8, 3, 16), (1000, 4, 4, 8)]
# how q, k, v reach the kernel: dense, or as slices of the serving path's
# fused projections (self: qkv split in thirds; cross: q alone, kv in halves)
ATTN_LAYOUTS = ("contiguous", "self", "cross")
ATTN_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=20):
    """Mean device time of fn() over reps, each launch after an L2 flush,
    timed with CUDA events."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
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

    t0 = time.perf_counter()
    for name in KERNELS:
        r = _build.build(name)
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


def phase_kernels():
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


def phase_slice(model_cpu):
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
        launches = LAUNCHES["window_attention"]
        out_cpu = model_cpu(x)
    if out_gpu.shape != (1, 8, 64, 64, 64) or not torch.isfinite(out_gpu).all():
        raise AssertionError(f"slice: bad output {tuple(out_gpu.shape)}")
    err = (out_gpu - out_cpu).abs().max().item()
    scale = out_cpu.abs().max().item()
    log(f"slice: full-width MicFormer 1x2x64³ f32, card vs CPU max |d| {err:.3g} "
        f"(output max |y| {scale:.3g}), {launches} kernel launches")
    if not (err <= 1e-3) or launches != 96 or scale == 0.0:
        raise AssertionError(f"slice: max |d| {err} (limit 1e-3), launches "
                             f"{launches} (want 96)")
    del model_gpu
    torch.backends.cudnn.allow_tf32 = True


def phase_serve(model_cpu, work):
    from micformer_tpu_torch.cli import serve
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches

    weights = os.path.join(work, "weights_bf16.pt")
    torch.save({k: v.bfloat16() for k, v in model_cpu.state_dict().items()}, weights)
    rng = np.random.default_rng(1)

    def serve_dir(sub, names):
        """Write one [2, 160³] request per name into a watch directory and
        serve them all; returns (latencies, out directory)."""
        watch, out = os.path.join(work, sub), os.path.join(work, f"{sub}_out")
        os.makedirs(watch)
        for name in names:
            path = os.path.join(watch, f"{name}.npy")
            np.save(path, rng.normal(size=(2, 160, 160, 160)).astype(np.float32))
            os.utime(path, (time.time() - 5,) * 2)
        lat = serve.main(["--weights", weights, "--watch", watch, "--out", out,
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
    for name in names:
        seg = read_nifti(os.path.join(out, f"{name}_seg.nii.gz"))
        if seg.shape != (160, 160, 160) or seg.max() >= 8:
            raise AssertionError(f"serve: bad segmentation for {name}: {seg.shape}")
        with open(os.path.join(out, f"{name}.done")) as f:
            per_request.append(json.load(f)["launches"]["window_attention"])
    res = {"requests": len(lat), "cold_latency_s": cold, "latency_s": lat,
           "p50_s": statistics.median(lat), "vol_per_s": len(lat) / sum(lat),
           "wall_s": wall, "max_memory_allocated": peak, "launches": launches,
           "launches_per_request": per_request}
    log(f"serve: {len(lat)} warm volumes 2x160³ bf16 roi 128 sw_batch 4: p50 "
        f"{res['p50_s']:.4f} s, {res['vol_per_s']:.3f} vol/s, latencies {lat}, "
        f"cold first request {cold:.4f} s, peak {peak / 2 ** 30:.2f} GiB, "
        f"launches {launches}, per request {per_request}")
    if len(lat) != 3 or launches["window_attention"] != 3 * 192 or per_request != [192] * 3:
        raise AssertionError(f"serve: {len(lat)} requests, launches {launches}, "
                             f"per request {per_request} (want 3 and 576)")
    return res


def main():
    smi = phase_device()
    phase_build()
    attn = phase_kernels()
    from micformer_tpu_torch import registry

    model_cpu = registry.build("micformer", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    log(f"model: micformer {sum(p.numel() for p in model_cpu.parameters())} parameters")
    phase_slice(model_cpu)
    work = os.path.join(ROOT, ".chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        serve = phase_serve(model_cpu, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the kernels line times stage 0 in bf16 in the layout of the path's
    # self attention: q/k/v sliced from the fused qkv projection
    stage0 = next(r for r in attn if r["shape"] == list(ATTN_SHAPES[0])
                  and r["layout"] == "self" and r["dtype"] == "bfloat16")
    kernels = [{"name": "window_attention", **KERNELS["window_attention"],
                "launches": serve["launches"]["window_attention"],
                "max_abs_err": max(r["max_abs_err"] for r in attn),
                **{k: stage0[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "shape", "layout", "dtype")}}]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
