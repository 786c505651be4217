#!/usr/bin/env python3
"""Device-time breakdown of the port's forwards and of a training step on
one GPU.

    python3 profile_torch_forward.py                 # the served models' forwards
    python3 profile_torch_forward.py train           # one MicFormer training step
    python3 profile_torch_forward.py train fused     # the same with fused attention (K2)
    python3 profile_torch_forward.py train mednext   # one MedNeXt-S training step

Forward: full-width MicFormer and MedNeXt-S k3 (seeded random weights, bf16),
each on a [4, 2, 128³] input: one sw_batch chunk of the serving path (roi
128, sw_batch 4). After two warm-up forwards, torch.profiler records three.
Train: full-width MicFormer through the port's Trainer (f32 parameters,
bf16 autocast, Adam, the monai augmentation) on a [1, 2, 128³] batch with a
uint8 label, as `cli/train.py --bf16` runs it; after two warm-up steps,
torch.profiler records three. Train fused: the same step with
`fused_attention=True` (`cli/train.py --fused-attention`), every attention
through K2 and its backward. Train mednext: full-width MedNeXt-S k3 the
same way, as the paper's config trains it (batch [2, 2, 128³], mdice, Adam
at lr 1e-4, monai augmentation, bf16 autocast); K3's launches in each step
are split by order into the forward's and the backward's dx (the first
half of a step's K3 launches run before its backward starts). Each mode
prints the device time per forward or step grouped by kind of kernel (with
the hand-written kernels' shares), the kernel count, the top kernels, and
the share of the wall time the device was busy. For MicFormer it also splits
the 96 launches a forward or step of K1 and its backward (or K2 and its
backward) by stage, in launch order (STAGE_ORDER; the backward runs it in
reverse), and prints each stage's mean time a launch. Kernels are grouped by
the names of their kernel functions: K2 and its backward run the device code
of K1's, but through kernel functions of their own
(`fused_window_attention_kernel`, `fused_window_attention_backward_kernel`),
so no K2 launch counts as K1's.
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
K3 = "K3 depthwise conv"
K3_DX = "K3 as dx (backward)"
K1, K1_BWD = "K1 window attention", "K1 attention backward"
K2, K2_BWD = "K2 fused window attention", "K2 attention backward"
# attention launches of one MicFormer forward in launch order, as (stage,
# launches): the encoder runs stages 0-3, then the decoder 2-0, 96 in all
STAGE_ORDER = [(0, 8), (1, 8), (2, 24), (3, 16), (2, 24), (1, 8), (0, 8)]
# kernel-name fragments -> group, first match wins
GROUPS = [("fused_window_attention_backward", K2_BWD),
          ("attention_backward", K1_BWD),
          ("dw_conv3_wgrad", "K3 weight gradient (wgrad)"),
          ("fused_window_attention", K2),
          ("window_attention", K1),
          ("dw_conv3", K3),
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


def attn_stages(kernels, groups) -> list[str]:
    """Mean device time a launch of K1, K2 and their backwards at each
    stage, the launches of each unit split by start order (STAGE_ORDER,
    reversed for the backwards); a group whose launches are not 96 a unit is
    skipped."""
    lines = []
    for group, order in ((K1, STAGE_ORDER), (K1_BWD, STAGE_ORDER[::-1]),
                         (K2, STAGE_ORDER), (K2_BWD, STAGE_ORDER[::-1])):
        launches = sorted((e for e in kernels if groups[id(e)] == group),
                          key=lambda e: e.time_range.start)
        stage_of = [s for s, n in order for _ in range(n)]
        per_unit = len(stage_of)
        if not launches or len(launches) != REPS * per_unit:
            continue
        us = [[] for _ in range(4)]
        for i, e in enumerate(launches):
            us[stage_of[i % per_unit]].append(e.time_range.elapsed_us())
        lines.append(f"{group} by stage (us a launch, mean [min, max]; launches a unit): "
                     + "; ".join(f"stage {s} {sum(u) / len(u):.2f} [{min(u):.2f}, "
                                 f"{max(u):.2f}] x{len(u) // REPS}"
                                 for s, u in enumerate(us)))
    return lines


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for frag, g in GROUPS if frag in low), "other")


def profile(run, what: str, unit: str, k3_forward_per_unit: int | None = None) -> str:
    """Profile REPS calls of run() (one `unit` each) after two warm-up
    calls; the report. With k3_forward_per_unit = n, the K3 launches of each
    unit after its first n (in start order) are grouped as dx, and the
    operators that own the most device time are listed with their input
    shapes (recording the shapes costs host time, so only then)."""
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    by_op = k3_forward_per_unit is not None
    with profile_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=by_op) as prof:
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
    groups = {id(e): group_of(e.name) for e in kernels}
    if k3_forward_per_unit is not None:
        k3 = sorted((e for e in kernels if groups[id(e)] == K3),
                    key=lambda e: e.time_range.start)
        per_unit = len(k3) // REPS
        for i, e in enumerate(k3):
            if i % per_unit >= k3_forward_per_unit:
                groups[id(e)] = K3_DX
    by_group, by_name = {}, {}
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_group[groups[id(e)]] = by_group.get(groups[id(e)], 0.0) + us
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
    lines += attn_stages(kernels, groups)
    lines.append(f"top kernels (ms/{unit}):")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        lines.append(f"  {us / REPS / 1e3:9.3f}  {n[:110]}")
    if by_op:
        lines.append(f"top operators by their own device time (ms/{unit}), input shapes:")
        ops = sorted(prof.key_averages(group_by_input_shape=True),
                     key=lambda a: -a.self_device_time_total)
        for a in ops[:12]:
            lines.append(f"  {a.self_device_time_total / REPS / 1e3:9.3f}  {a.key} "
                         f"{str(a.input_shapes)[:90]}")
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


def profile_train(name: str = "micformer", fused: bool = False) -> str:
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.train.trainer import TrainConfig, Trainer

    kwargs = {"fused_attention": True} if fused else {}
    model = registry.build(name, device="cuda", generator=torch.Generator().manual_seed(0),
                           **kwargs)
    batch = 2 if name == "mednext" else 1          # each model's published batch
    gen = torch.Generator().manual_seed(1)
    images = torch.rand((batch, 2) + (ROI,) * 3, generator=gen).half()
    labels = torch.randint(0, 8, (batch,) + (ROI,) * 3, generator=gen).to(torch.uint8)
    # MedNeXt-S's 18 stride-1 depthwise convs run K3 once forward, once for dx
    k3_forward = 18 if name == "mednext" else None
    with tempfile.TemporaryDirectory() as run_dir:
        trainer = Trainer(model, TrainConfig(bf16=True, run_dir=run_dir))
        report = profile(lambda: trainer.train_step(images, labels),
                         f"{name} training step{' with fused attention' if fused else ''}, "
                         f"bf16 autocast, batch [{batch}, 2, {ROI}³]", "step", k3_forward)
        steps = trainer.history[-REPS:]
        peak = torch.cuda.max_memory_allocated()
    return (report + f"\nsteps (host clock incl. profiler): "
            f"{[round(1e3 * r['seconds'], 2) for r in steps]} ms; losses "
            f"{[r['loss'] for r in steps]}; launches per step {steps[-1]['launches']}; "
            f"peak allocated {peak / 2 ** 30:.2f} GiB")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_forward: CUDA is not available")
    if sys.argv[1:2] == ["train"] and sys.argv[2:] in ([], ["micformer"], ["mednext"]):
        print(profile_train(*sys.argv[2:]), flush=True)
        return
    if sys.argv[1:] == ["train", "fused"]:
        print(profile_train("micformer", fused=True), flush=True)
        return
    if sys.argv[1:]:
        raise SystemExit("usage: profile_torch_forward.py [train [micformer|fused|mednext]]")
    for name in MODELS:
        print(profile_model(name), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
