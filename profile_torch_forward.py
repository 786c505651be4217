#!/usr/bin/env python3
"""Device-time breakdown of one forward of each of the port's served models
on one GPU.

    python3 profile_torch_forward.py

Full-width MicFormer and MedNeXt-S k3 (seeded random weights, bf16), each on
a [4, 2, 128³] input: one sw_batch chunk of the serving path (roi 128,
sw_batch 4). After two warm-up forwards, torch.profiler records three
forwards; the script prints, per model, the device time per forward grouped
by kind of kernel (with the hand-written kernels' shares), the top kernels,
and the share of the wall time the device was busy.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

BATCH, ROI, REPS = 4, 128, 3   # the serving chunk: sw_batch 4, roi 128³
MODELS = ("micformer", "mednext")
# kernel-name fragments -> group, first match wins
GROUPS = [("window_attention", "K1 window attention"),
          ("dw_conv3", "K3 depthwise conv"),
          ("grid_sampler", "warp (grid_sample)"),
          ("layer_norm", "layer norm"), ("gelu", "gelu"),
          ("conv", "convolution (cuDNN)"), ("dgrad", "convolution (cuDNN)"),
          ("xmma", "convolution (cuDNN)"), ("cudnn", "convolution (cuDNN)"),
          ("gemm", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
          ("cutlass", "matmul (cuBLAS)"),
          ("copy", "copies / layout"), ("cat", "copies / layout"),
          ("elementwise", "elementwise"), ("reduce", "reductions")]


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for frag, g in GROUPS if frag in low), "other")


def profile_model(name: str) -> str:
    from micformer_tpu_torch import registry

    model = registry.build(name, dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((BATCH, 2) + (ROI,) * 3, generator=gen, device="cuda")
    with torch.no_grad():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                model(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group, by_name = {}, {}
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_group[group_of(e.name)] = by_group.get(group_of(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    total = sum(by_group.values())
    lines = [f"{torch.cuda.get_device_name(0)}; {name} bf16 forward, input "
             f"[{BATCH}, 2, {ROI}³], {REPS} forwards profiled",
             f"wall {wall_us / REPS / 1e3:.3f} ms/forward, device busy "
             f"{busy / REPS / 1e3:.3f} ms/forward ({100 * busy / wall_us:.1f} % of "
             f"wall), kernel time {total / REPS / 1e3:.3f} ms/forward, "
             f"{len(kernels) // REPS} kernels/forward", "by group (ms/forward, share):"]
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {g:24s} {us / REPS / 1e3:9.3f}  {100 * us / total:5.1f} %")
    lines.append("top kernels (ms/forward):")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        lines.append(f"  {us / REPS / 1e3:9.3f}  {n[:110]}")
    return "\n".join(lines)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_forward: CUDA is not available")
    for name in MODELS:
        print(profile_model(name), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
