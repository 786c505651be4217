#!/usr/bin/env python3
"""Device-time breakdown of the port's forwards and of a MicFormer training
step on one GPU.

    python3 profile_torch_forward.py          # the served models' forwards
    python3 profile_torch_forward.py train    # one MicFormer training step

Forward: full-width MicFormer and MedNeXt-S k3 (seeded random weights, bf16),
each on a [4, 2, 128³] input: one sw_batch chunk of the serving path (roi
128, sw_batch 4). After two warm-up forwards, torch.profiler records three.
Train: full-width MicFormer through the port's Trainer (f32 parameters,
bf16 autocast, Adam, the monai augmentation) on a [1, 2, 128³] batch with a
uint8 label, as `cli/train.py --bf16` runs it; after two warm-up steps,
torch.profiler records three. Either way the script prints the device time
per forward or step grouped by kind of kernel (with the hand-written
kernels' shares), the kernel count, the top kernels, and the share of the
wall time the device was busy.
"""

from __future__ import annotations

import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as profile_ctx

BATCH, ROI, REPS = 4, 128, 3   # the serving chunk: sw_batch 4, roi 128³
MODELS = ("micformer", "mednext")
# kernel-name fragments -> group, first match wins
GROUPS = [("attention_backward", "K1/K2 attention backward"),
          ("fused_window_attention", "K2 fused window attention"),
          ("window_attention", "K1 window attention"),
          ("dw_conv3", "K3 depthwise conv"),
          ("grid_sampler", "warp (grid_sample)"),
          ("layer_norm", "layer norm"), ("gelu", "gelu"),
          ("conv", "convolution (cuDNN)"), ("dgrad", "convolution (cuDNN)"),
          ("wgrad", "convolution (cuDNN)"),
          ("multi_tensor", "optimizer"), ("adam", "optimizer"),
          ("xmma", "convolution (cuDNN)"), ("cudnn", "convolution (cuDNN)"),
          ("gemm", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
          ("cutlass", "matmul (cuBLAS)"),
          ("copy", "copies / layout"), ("cat", "copies / layout"),
          ("elementwise", "elementwise"), ("reduce", "reductions")]


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for frag, g in GROUPS if frag in low), "other")


def profile(run, what: str, unit: str) -> str:
    """Profile REPS calls of run() (one `unit` each) after two warm-up
    calls; the report."""
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device events, without the annotations that the optimizer's step and
    # the profiler mirror onto the device timeline (they span kernels)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
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
    lines = [f"{torch.cuda.get_device_name(0)}; {what}, {REPS} {unit}s profiled",
             f"wall {wall_us / REPS / 1e3:.3f} ms/{unit}, device busy "
             f"{busy / REPS / 1e3:.3f} ms/{unit} ({100 * busy / wall_us:.1f} % of "
             f"wall), kernel time {total / REPS / 1e3:.3f} ms/{unit}, "
             f"{len(kernels) // REPS} kernels/{unit}", f"by group (ms/{unit}, share):"]
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {g:26s} {us / REPS / 1e3:9.3f}  {100 * us / total:5.1f} %")
    lines.append(f"top kernels (ms/{unit}):")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        lines.append(f"  {us / REPS / 1e3:9.3f}  {n[:110]}")
    return "\n".join(lines)


def profile_model(name: str) -> str:
    from micformer_tpu_torch import registry

    model = registry.build(name, dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((BATCH, 2) + (ROI,) * 3, generator=gen, device="cuda")

    def run():
        with torch.no_grad():
            model(x)

    return profile(run, f"{name} bf16 forward, input [{BATCH}, 2, {ROI}³]", "forward")


def profile_train() -> str:
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.train.trainer import TrainConfig, Trainer

    model = registry.build("micformer", device="cuda",
                           generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    images = torch.rand((1, 2) + (ROI,) * 3, generator=gen).half()
    labels = torch.randint(0, 8, (1,) + (ROI,) * 3, generator=gen).to(torch.uint8)
    with tempfile.TemporaryDirectory() as run_dir:
        trainer = Trainer(model, TrainConfig(bf16=True, run_dir=run_dir))
        report = profile(lambda: trainer.train_step(images, labels),
                         f"micformer training step, bf16 autocast, batch [1, 2, {ROI}³]", "step")
        steps = trainer.history[-REPS:]
        peak = torch.cuda.max_memory_allocated()
    return (report + f"\nsteps (host clock incl. profiler): "
            f"{[round(1e3 * r['seconds'], 2) for r in steps]} ms; losses "
            f"{[r['loss'] for r in steps]}; launches per step {steps[-1]['launches']}; "
            f"peak allocated {peak / 2 ** 30:.2f} GiB")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_forward: CUDA is not available")
    if sys.argv[1:] == ["train"]:
        print(profile_train(), flush=True)
        return
    if sys.argv[1:]:
        raise SystemExit("usage: profile_torch_forward.py [train]")
    for name in MODELS:
        print(profile_model(name), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
