#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (micformer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any error in any of them fails the run (non-zero exit, no result line):
  1. device  - CUDA must be available; prints nvidia-smi's name and power limit.
  2. build   - nvcc builds every kernel source of the serving and training
               paths from csrc/, one nvcc per source, all started together,
               and g++ the native host library (native/) beside them;
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
               over one MedNeXt-S pass (18 launches at the stage shapes); the
               same K3, dx and wgrad rows at SwinUnet3D's gated-conv shapes
               (96-768 channels: [4, C, 32³-4³] serving, b2 training), summed
               over its 14 launches a pass; the biased window attention kernel
               at SwinUNETR's four stage shapes in bf16 (q, k, v sliced from
               one fused qkv, a bias, with and without the shifted blocks'
               region ids), against its plain version, the same bits twice,
               LAUNCHES counting each launch, timed beside its bound, the plain
               chain it replaced and SDPA with bias and mask as one attn_mask,
               then summed over one served call (16 launches).
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
               after. Then SwinUNETR at the benchmark's widths (feature 48,
               heads 3-6-12-24, window 7³, input 128) the same way: each
               request 16 launches of the biased window attention kernel (8
               on each of its routes none and ids), 16 "bwa" and 0 "matmul"
               attention paths, nothing else launched by hand.
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
 10. zoo     - UNet3D, nnFormer, SwinUnet3D (and its pure sibling), VT-UNet (and its
               faithful_2d_merge), SwinUNETR, TransBTS, TransUNet, unet_conv,
               HalfUNet and UNetPatch at their published widths with seeded
               weights: (a) card against CPU at 1x2x64³, f32 without TF32, max
               |card - CPU| within ZOO_REL_BAR of max |output| (nnFormer's whole
               deep-supervision pyramid; TransBTS's probabilities), with the
               launches and attention paths of the card's forward (K3 14 a
               SwinUnet3D forward; K1 only where its window clamps to 2³; every
               attention of the seven new models on the plain chain); (c)
               nnFormer, SwinUnet3D, VT-UNet, SwinUNETR, TransBTS (built for 128³)
               and TransUNet in bf16 through the serve loop as phase 5 (one cold
               request, three [2, 160³] at roi 128), their launches, routes and
               attention paths (nnFormer's, SwinUnet3D's and VT-UNet's windows
               through the biased window attention kernel, the rest on the
               plain chain); (d) cli/train on phase 6's
               root in bf16: nnFormer from configs/nnformer_mmwhs.yaml for two
               epochs with validation, SwinUnet3D (28 K3 and 14 wgrad launches a
               step, tma and volume routes) and UNet3D for one epoch each at batch
               2, VT-UNet from configs/vtunet_base.yaml (batch 2) for one epoch,
               and SwinUNETR, TransBTS, TransUNet, unet_conv, HalfUNet and
               UNetPatch for one epoch at batch 1, each checked as phase 6; (e) on
               phase 7's root at 160³, f32 without TF32: cli/predict from (d)'s
               nnFormer and TransBTS runs (3d engine, mirror TTA; each softmax
               within 2e-3 of a direct sliding_window_inference on the
               checkpoint), --engine 2d and --engine p3d --pseudo3d-slices 5 from
               run dirs of a seeded full-width 2D GenericUNet, and the 2d engine
               with one tile a slice within 1e-4 of a dense per-slice forward;
               seconds a case and peak memory of each.
 11. tensor  - tensor parallelism: the full-width MicFormer (seed 0) at 1x2x128³
               over two ranks on the one card over gloo (spawned with torchrun's
               variables), each through parallel.tensor.shard_tensor_parallel and
               tensor_parallel_apply, in f32 (TF32 off) and bf16, against the same
               model's single-process forward on the card: f32 max |d| within
               TP_REL_BAR of max |logit|, bf16 reported; K1 96 launches a rank and
               forward (route ffma in f32, mma in bf16), the all-reduces' count
               and ms, the forward's ms, peak memory and the share of parameters a
               rank, and the modules the plan keeps whole.
 12. export  - serving artifacts (torch.export, K1, K2 and K3 as custom-op
               nodes): cli/export from phase 6's MicFormer, fused and MedNeXt-S
               runs at the bench protocol (bf16, 160³, roi 128, overlap 0.5,
               gaussian, sw_batch 4, argmax) and an f32 --logits MicFormer
               artifact at 128³, one cli/export process each, all started
               together; each artifact is checked as soon as its process ends,
               while the others still export. An argmax artifact is loaded
               from disk and served by cli/serve --exported (one cold request,
               then three [2, 160³]): the loaded graph's op nodes (192
               window_attention and no softmax node; 192
               fused_window_attention; 36 dw_conv3), each request's launches
               and routes (K1 or K2 mma; K3 tma and volume); then serve
               --run-dir's composition (build_model, build_inference_fn) of
               the same run on the same requests, in-process while the exports
               run, each request timed as serve times it: at least EXPORT_AGREE of the voxels
               agree (the count that differ printed). Printed: the cli/export
               process's seconds, artifact MB, load seconds, cold and p50
               request and peak memory, beside the live composition's and
               phase 5's live p50. The logits artifact (one tile, 96 K1 on
               ffma; TF32 off) is within EXPORT_LOGITS_REL of max |logit| of
               the live pipeline. Then cli/plan and verify_dataset_integrity
               over phase 7's root, and the native reader and resizers against
               the Python ones where the native library built (phase 2 builds
               it; its compiler message when it fails, which fails nothing: it
               is host code off the device).
 13. reference - the reference's own checkpoints imported onto the card: for
               MicFormer and MedNeXt-S at full width with phase 4's seeded weights,
               the weights written in the reference's names and layout (the
               inverse of the port's importer rules, tests/torch_port_reference.py;
               MicFormer's dead swin.concat_back_dim.0 included), saved as the
               reference's trainer saves them (torch.save of {"epoch",
               "state_dict", "optimizer", "scheduler"} to model_best.pth.tar),
               torch.load(map_location="cuda", weights_only=True), imported into a
               freshly built model on the card (convert.torch_import,
               convert.zoo_import): every parameter equal to the source's, one
               1x2x64³ f32 forward (TF32 off, cuDNN deterministic) bitwise equal
               to the source model's with K1 96 and K3 18 launches; the unread
               keys exactly the dead ones. Printed: each import's seconds (load
               and import) and its unread keys. No fallback to the plain versions.
 14. features - the last features of the JAX package: (a) the inference
               rel-pos cache (models.layers.materialize_rpe_cache) on phase 10's
               served SwinUNETR (feature 12), VT-UNet (embed 96) and nnFormer
               (embed 96), seeded, at 1x2x128³: one f32 forward (TF32 off) cached
               against uncached within FEATURE_CACHE_REL of max |logit|, the table
               gathers of each (every biased block uncached, none cached), and the
               bf16 forward's median ms of 5 each way (CUDA events); (b) cli/export
               --platforms cuda cpu of phase 6's MedNeXt-S run (f32, 64³, roi 64),
               started with phase 12's exports and run behind them, then served
               once by cli/serve --exported on each device (live cpu serving in a
               thread beside the cuda request, after (a)): 0 voxels differing from live
               serving on that device (cuDNN deterministic), 18
               dw_conv3 op nodes in each program, 18 K3 launches from the cuda
               program as live, none from the cpu one. Phase 10's nnFormer predict
               reads the cache too (its gathers, once a fold, and cache reads are
               printed there). Then the script's total seconds.
 15. lines   - a {"kernels": [...]} line, then the {"ok": true, ...} line last.
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
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
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
    "dw_transpose2_wgrad": {
        "route": "cuda",
        "source": "micformer_tpu_torch/csrc/dw_transpose2_wgrad.cu",
        "replaces": "none: cuDNN's wgrad of the transposed depthwise up conv",
    },
    "biased_window_attention": {
        "route": "cuda",
        "source": "micformer_tpu_torch/csrc/biased_window_attention.cu",
        "replaces": "none: the JAX package's XLA chain of biased, masked window attention",
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
# SwinUnet3D's gated depthwise convs (groups = channels, 96-768 of them) at
# sw_batch 4, roi 128: its four stage shapes, each run by 4, 4, 4 and 2 of
# the 14 convs of a forward (encoder and decoder stages, two convs each)
SWIN_DW_SHAPES = [((4, 96, 32, 32, 32), 3), ((4, 192, 16, 16, 16), 3),
                  ((4, 384, 8, 8, 8), 3), ((4, 768, 4, 4, 4), 3)]
SWIN_DW_STAGE_LAUNCHES = [4, 4, 4, 2]
# f32: 27-125 f32 terms summed in another order; bf16: one rounding of
# outputs up to about 10
DW_TOL = {torch.float32: dict(rtol=0.0, atol=1e-4),
          torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}
# ([B, C, D, H, W], k): MedNeXt-S's stride-1 depthwise convs in a b2 128³
# training step (stages 0-3 and the bottleneck), then DW_SHAPES' ragged cases
DW_TRAIN_SHAPES = [((2, 32, 128, 128, 128), 3), ((2, 64, 64, 64, 64), 3),
                   ((2, 128, 32, 32, 32), 3), ((2, 256, 16, 16, 16), 3),
                   ((2, 512, 8, 8, 8), 3)] + DW_SHAPES[5:]
# ... and in a b2 128³ SwinUnet3D training step
SWIN_DW_TRAIN_SHAPES = [((2,) + shape[1:], k) for shape, k in SWIN_DW_SHAPES]
# stride-1 depthwise convs of one MedNeXt-S pass at stages 0-3 (2 encoder
# and 2 decoder blocks each) and the bottleneck (2 blocks): 18 in all
DW_STAGE_LAUNCHES = [4, 4, 4, 4, 2]
# dw and db: sums of up to 8.4 M exact f32 products in another order (f32),
# then one rounding to bf16 (bf16)
DW_WGRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-3),
                torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}
# ([B, C, L, L, L], k): the inputs of MedNeXt-S's four transposed depthwise
# up convs in a b2 128³ training step, one launch of their wgrad kernel each
DWT2_TRAIN_SHAPES = [((2, 512, 8, 8, 8), 3), ((2, 256, 16, 16, 16), 3),
                     ((2, 128, 32, 32, 32), 3), ((2, 64, 64, 64, 64), 3)]
# the kernel and the plain version both multiply in f32 (bf16 products are
# exact) and sum in another order: 1e-4 of the largest dw or db
DWT2_WGRAD_REL_TOL = 1e-4
# (N, T, h, d): SwinUNETR's window attention at the four stages of a forward
# of 4 tiles of 128³ (feature 48, heads 3-6-12-24, window 7³), each run by one
# plain and one shifted block, and the padded grid whose shifted windows give
# the stage's region ids; a served call is two forwards (16 launches)
BWA_SHAPES = [(4000, 343, 3, 16), (500, 343, 6, 16), (108, 343, 12, 16), (32, 343, 24, 16)]
BWA_GRIDS = [70, 35, 21, 14]
# SwinUNETR at the benchmark's widths (perfbench/configs/swinunetr.json, the
# paper's model): a served request's 16 window attentions (two forwards of 8,
# 4 of them with the shifted blocks' region ids) all take the kernel
SWINUNETR_SERVED = {"feature_size": 48, "depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24],
                    "window_size": [7, 7, 7], "in_channels": 2, "input_size": 128}
SWINUNETR_REQUEST_BWA = 16
# exponentials a second on one H100 SXM: the special-function units' rate
# (FlashAttention-3, arXiv:2407.08608 §3), as perfbench's swin_attn_roofline
EXP_PER_S = 3.9e12
# the kernel and the plain version each round P once to bf16 and the output
# once: at most 2^-9 of max |v| each, so 2^-7 of max |v| between them
BWA_REL_TOL = 2.0 ** -7
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
# 18 K3 launches for dx, 18 wgrad launches and 4 of the up convs' wgrad)
TRAIN_STEP = {False: expect(window_attention=96, window_attention_backward=96),
              True: expect(fused_window_attention=96, fused_window_attention_backward=96),
              "mednext": expect(dw_conv3=36, dw_conv3_wgrad=18, dw_transpose2_wgrad=4),
              "generic_unet": expect(),
              # the zoo: SwinUnet3D's 14 gated convs a forward, K3 again for
              # their dx and the wgrad kernel for dw and db
              "nnformer": expect(), "unet3d": expect(),
              "swinunet3d": expect(dw_conv3=28, dw_conv3_wgrad=14),
              "vtunet": expect(), "swinunetr": expect(), "transbts": expect(),
              "transunet": expect(), "unet_conv": expect(), "halfunet": expect(),
              "unet_patchify": expect()}
ZOO_TRAIN = ("nnformer", "unet3d", "swinunet3d", "vtunet", "swinunetr", "transbts",
             "transunet", "unet_conv", "halfunet", "unet_patchify")


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
# MedNeXt's up convs' wgrad at roi 128 (L_W 8-64, multiples of 4): 16-byte loads
DWT2_PATH_ROUTES = ["vector"]
# the biased window attention's routes (the mask's kind) where a model has
# shifted blocks beside plain ones: region ids and no mask
BWA_PATH_ROUTES = ["ids", "none"]
# the zoo's runs whose bf16 validation forwards (no gradient) put their
# windows through the biased window attention kernel
BWA_VALIDATED = ("nnformer", "swinunet3d", "vtunet")


def all_routes():
    """The routes a run used, per K3-family, up-conv wgrad and attention
    (K1, K2, biased window attention) kernel."""
    from micformer_tpu_torch.kernels.biased_window_attention import ROUTES as BWA_ROUTES
    from micformer_tpu_torch.kernels.dw_conv3 import ROUTES
    from micformer_tpu_torch.kernels.dw_transpose2 import ROUTES as DWT2_ROUTES
    from micformer_tpu_torch.kernels.window_attention import ROUTES as ATTN_ROUTES

    return path_routes({**ROUTES, "dw_transpose2_wgrad": DWT2_ROUTES, **ATTN_ROUTES,
                        "biased_window_attention": BWA_ROUTES})


def reset_all_routes():
    from micformer_tpu_torch.kernels.biased_window_attention import reset_routes as reset_bwa
    from micformer_tpu_torch.kernels.dw_conv3 import reset_routes
    from micformer_tpu_torch.kernels.dw_transpose2 import reset_routes as reset_dwt2
    from micformer_tpu_torch.kernels.window_attention import reset_routes as reset_attn

    reset_routes()
    reset_dwt2()
    reset_attn()
    reset_bwa()


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
    from micformer_tpu_torch import native
    from micformer_tpu_torch.kernels import _build

    sources = sorted({os.path.basename(k["source"])[:-3] for k in KERNELS.values()})
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        # the native host library (g++) beside the kernels: its failure
        # fails nothing, the Python reader reads instead
        host = pool.submit(native.available)
        results = dict(zip(sources, pool.map(_build.build, sources)))
    for name, r in results.items():
        log(f"build: {name} {r['seconds']:.2f} s\n{r['log'].strip()}")
    log(f"build: all kernels in {time.perf_counter() - t0:.2f} s; the native host library "
        + ("built" if host.result() else f"not built: {native.BUILD_ERROR}"))
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
            DW_SHAPES + SWIN_DW_SHAPES, (torch.float32, torch.bfloat16)):
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


def dw_pass_sums(name, rows, shapes, launches=DW_STAGE_LAUNCHES):
    """Kernel, library and bound time of one pass of a K3-family kernel:
    each stage shape's row times its launches (MedNeXt-S's by default)."""
    sums = {}
    for dt in ("float32", "bfloat16"):
        sel = [next(r for r in rows if r["shape"] == list(shape) and r["dtype"] == dt)
               for shape, _ in shapes[:len(launches)]]
        sums[dt] = {key: sum(n * r[key] for n, r in zip(launches, sel))
                    for key in ("ms", "library_ms", "bound_ms")}
        log(f"pass sum {name} {dt}: kernel {1e3 * sums[dt]['ms']:.1f} us, library "
            f"{1e3 * sums[dt]['library_ms']:.1f} us, bound {1e3 * sums[dt]['bound_ms']:.1f} us "
            f"({sum(launches)} launches)")
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
            DW_TRAIN_SHAPES + SWIN_DW_TRAIN_SHAPES, (torch.float32, torch.bfloat16)):
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


def phase_dwt2_wgrad_kernel():
    """The up convs' weight-gradient kernel at MedNeXt-S's b2 training
    shapes, f32 and bf16: held against its plain version, run twice for the
    same bits, and timed against the plain version and cuDNN's wgrad (dw and
    db of `aten.convolution_backward` on the zero-padded gradient, as
    autograd ran it before the kernel)."""
    from micformer_tpu_torch.kernels.dw_transpose2 import (
        _dwt2_route, dw_transpose2_wgrad, dw_transpose2_wgrad_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for ((B, C, D, H, W), k), dt in itertools.product(
            DWT2_TRAIN_SHAPES, (torch.float32, torch.bfloat16)):
        x = torch.randn((B, C, D, H, W), generator=gen, device="cuda").to(dt)
        g = torch.randn((B, C, 2 * D, 2 * H, 2 * W), generator=gen, device="cuda").to(dt)
        got = dw_transpose2_wgrad(x, g, k)
        again = dw_transpose2_wgrad(x, g, k)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b, r in zip(("dw", "db"), got, again, dw_transpose2_wgrad_reference(x, g, k)):
            errs[name] = (a - r).abs().max().item()
            tol = DWT2_WGRAD_REL_TOL * r.abs().max().item()
            if not (errs[name] <= tol) or not torch.equal(a, b):
                raise AssertionError(f"dw_transpose2_wgrad {name} {[B, C, D, H, W]} k {k} {dt}: "
                                     f"max err {errs[name]} (limit {tol}), same bits twice "
                                     f"{torch.equal(a, b)}")
        del got, again
        # the transposed conv's output before the cut is 2L + 1 per axis
        gp = g.new_zeros((B, C, 2 * D + 1, 2 * H + 1, 2 * W + 1))
        gp[:, :, :2 * D, :2 * H, :2 * W] = g
        wf = torch.randn((C, 1, k, k, k), generator=gen, device="cuda").to(dt)
        ms, by, b_ms, o_ms = dw_bound((x.numel() + g.numel()) * x.element_size()
                                      + C * (k ** 3 + 1) * 4, 2 * k ** 3 * x.numel() + g.numel())
        with torch.no_grad():
            row = {"shape": [B, C, D, H, W], "k": k, "dtype": str(dt).replace("torch.", ""),
                   "route": _dwt2_route(x.shape, x.data_ptr(), g.data_ptr()),
                   "max_abs_err": max(errs.values()), "dw_err": errs["dw"],
                   "db_err": errs["db"],
                   "ms": time_ms(lambda: dw_transpose2_wgrad(x, g, k)),
                   "plain_ms": time_ms(lambda: dw_transpose2_wgrad_reference(x, g, k), reps=5),
                   "library_ms": time_ms(lambda: torch.ops.aten.convolution_backward(
                       gp, x, wf, [C], [2] * 3, [k // 2 - 1] * 3, [1] * 3, True, [0] * 3, C,
                       [False, True, True]), reps=5),
                   "bound_ms": ms, "bound_by": by, "bytes_bound_ms": b_ms,
                   "ops_bound_ms": o_ms}
        rows.append(row)
        log(f"kernel dw_transpose2_wgrad {row['shape']} k {k} {row['dtype']} {row['route']}: "
            f"err {row['max_abs_err']:.3g}, kernel {1e3 * row['ms']:.2f} us, plain "
            f"{1e3 * row['plain_ms']:.2f} us, cudnn wgrad {1e3 * row['library_ms']:.2f} us, "
            f"bound {1e3 * row['bound_ms']:.2f} us ({row['bound_by']}; bytes "
            f"{1e3 * row['bytes_bound_ms']:.2f} us, ops {1e3 * row['ops_bound_ms']:.2f} us)")
        del x, g, gp, wf
    return rows


def phase_bwa_kernel():
    """The biased window attention kernel at SwinUNETR's four stage shapes in
    bf16, q, k, v sliced from one fused qkv projection, with a bias and with
    and without the shifted blocks' region ids: held against its plain
    version (BWA_REL_TOL of max |v|), run twice for the same bits, counted by
    LAUNCHES, and timed after an L2 flush beside its bound (the longest of
    the exponentials at EXP_PER_S, the bytes of q, k, v, out and the bias,
    the products at the bf16 peak), the plain chain it replaced
    (`attention_chain`) and SDPA with bias and mask as one additive attn_mask
    (the yardstick: the port never calls it). Then the rows summed over one
    served call: two forwards of a plain and a shifted block at each stage.
    Returns the rows."""
    from micformer_tpu_torch.kernels import LAUNCHES
    from micformer_tpu_torch.kernels.biased_window_attention import (
        ROUTES, biased_window_attention, biased_window_attention_reference, reset_routes,
    )
    from micformer_tpu_torch.ops.attention import MASK_VALUE, attention_chain
    from micformer_tpu_torch.ops.windows import shifted_window_region_ids

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for (N, T, h, d), grid in zip(BWA_SHAPES, BWA_GRIDS):
        qkv = torch.randn((N, T, 3 * h * d), generator=gen, device="cuda").bfloat16()
        q, k, v = (t.view(N, T, h, d) for t in qkv.chunk(3, dim=-1))
        bias = torch.randn((h, T, T), generator=gen, device="cuda").bfloat16()
        ids = torch.from_numpy(shifted_window_region_ids((grid,) * 3, (7,) * 3, (3,) * 3)).cuda()
        for mask in (None, ids):
            kind = "none" if mask is None else "ids"
            reset_routes()
            before = LAUNCHES["biased_window_attention"]
            got = biased_window_attention(q, k, v, bias, mask)
            again = biased_window_attention(q, k, v, bias, mask)
            torch.cuda.synchronize()
            if LAUNCHES["biased_window_attention"] != before + 2 or ROUTES[kind] != 2:
                raise AssertionError(f"biased_window_attention {[N, T, h, d]} {kind}: launches "
                                     f"{LAUNCHES['biased_window_attention'] - before}, routes "
                                     f"{ROUTES} (want 2 on {kind})")
            ref = biased_window_attention_reference(q, k, v, bias, mask)
            err = (got.float() - ref.float()).abs().max().item()
            tol = BWA_REL_TOL * v.abs().max().item()
            del ref
            if not (err <= tol) or not torch.equal(got, again):
                raise AssertionError(f"biased_window_attention {[N, T, h, d]} {kind}: max err "
                                     f"{err} (limit {tol}), same bits twice "
                                     f"{torch.equal(got, again)}")
            del got, again
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            add = bias[None]
            if mask is not None:
                pair = torch.where(ids[:, :, None] == ids[:, None, :], 0.0, MASK_VALUE).bfloat16()
                add = (bias[None] + pair[:, None]).repeat(N // len(ids), 1, 1, 1)
            nbytes = 4 * q.numel() * 2 + bias.numel() * 2
            least = {"exponentials": N * h * T * T / EXP_PER_S,
                     "bytes": nbytes / HBM_BYTES_PER_S,
                     "operations": 4 * N * h * T * T * d / PEAK_OPS_PER_S[torch.bfloat16]}
            by = max(least, key=least.get)
            row = {"shape": [N, T, h, d], "mask": kind, "dtype": "bfloat16",
                   "max_abs_err": err, "route": kind,
                   "ms": time_ms(lambda: biased_window_attention(q, k, v, bias, mask)),
                   "plain_ms": time_ms(lambda: attention_chain(q, k, v, bias=bias, mask=mask),
                                       reps=5),
                   "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=add), reps=5),
                   "bound_ms": 1e3 * least[by], "bound_by": by}
            del add
            rows.append(row)
            log(f"kernel biased_window_attention {row['shape']} {kind} bf16: err {err:.3g} "
                f"(limit {tol:.3g}), kernel {1e3 * row['ms']:.2f} us, attention_chain "
                f"{1e3 * row['plain_ms']:.2f} us, sdpa {1e3 * row['library_ms']:.2f} us, "
                f"bound {1e3 * row['bound_ms']:.2f} us ({by}), "
                f"{100 * row['bound_ms'] / row['ms']:.2f} % of it")
        del q, k, v, qkv, bias
        torch.cuda.empty_cache()
    call = {key: 2 * sum(r[key] for r in rows) for key in ("ms", "plain_ms", "library_ms",
                                                            "bound_ms")}
    log(f"biased_window_attention (one served call, 16 launches): kernel {call['ms']:.3f} ms, "
        f"attention_chain {call['plain_ms']:.3f} ms, sdpa {call['library_ms']:.3f} ms, bound "
        f"{call['bound_ms']:.3f} ms ({100 * call['bound_ms'] / call['ms']:.2f} % of it)")
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
    from micformer_tpu_torch.kernels import ATTENTION_PATHS, LAUNCHES, reset_launches

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_all_routes()
    t0 = time.perf_counter()
    trainer = train.main(argv)
    wall = time.perf_counter() - t0
    launches, paths = dict(LAUNCHES), dict(ATTENTION_PATHS)
    routes = all_routes()
    dw_routes = PATH_ROUTES if key in ("mednext", "swinunet3d") else []
    k1_routes = ATTN_PATH_ROUTES if key is False else []
    k2_routes = ATTN_PATH_ROUTES if key is True else []
    want_routes = {"dw_conv3": dw_routes, "dw_conv3_wgrad": dw_routes,
                   "dw_transpose2_wgrad": DWT2_PATH_ROUTES if key == "mednext" else [],
                   "window_attention": k1_routes, "window_attention_backward": k1_routes,
                   "fused_window_attention": k2_routes,
                   "fused_window_attention_backward": k2_routes,
                   "biased_window_attention": BWA_PATH_ROUTES if key in BWA_VALIDATED else []}
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
           "launches_per_step": hist[0]["launches"] if hist else None, "routes": routes,
           "attention_paths": paths}
    log(f"train {name}: {len(hist)} steps of batch {batch} (to step {trainer.step}) in "
        f"{wall:.2f} s, first step {res['first_step_s']:.3f} s, warm "
        f"{res['warm_ms_per_step']:.2f} ms/step, {res['warm_vol_per_s']:.3f} vol/s, peak "
        f"{peak / 2 ** 30:.2f} GiB, step ms {res['step_ms']}, losses {losses}, launches "
        f"{launches}, per step "
        f"{res['launches_per_step']}, routes {routes}, attention paths {paths}")
    want = TRAIN_STEP[key]
    if routes != want_routes:
        raise AssertionError(f"train {name}: routes {routes} (want {want_routes})")
    if key in ZOO_TRAIN and (paths["k1"] or paths["k2"]):
        raise AssertionError(f"train {name}: attention paths {paths}: the zoo's windows "
                             f"at {TRAIN_SIZE}³ hold more than 16 tokens (the plain chain)")
    if ((len(hist), trainer.step) != want_steps
            or not all(np.isfinite(v) and not r["skipped"] for v, r in zip(losses, hist))
            or any(r["launches"] != want for r in hist)
            or any(launches[k] < n * len(hist) for k, n in want.items())):
        raise AssertionError(f"train {name}: steps {len(hist)} to {trainer.step} (want "
                             f"{want_steps}), losses {losses}, launches per step "
                             f"{[r['launches'] for r in hist]} (want {want})")
    return res, trainer


def phase_serve(name, model_cpu, work, want=None, want_routes=None, model_kwargs=None,
                tag=None):
    """One cold request, then three [2, 160³] requests in bf16 through the
    serve loop; each request's launches must be `want` (PATHS[name]'s
    request by default) and the three's routes `want_routes` (by default:
    MedNeXt's K3 on tma and volume, MicFormer's K1 on mma). model_kwargs:
    serve's --model-kwargs (the input a model was built for, or its widths);
    tag: the name of the run's files in `work` (default: name)."""
    from micformer_tpu_torch.cli import serve
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.kernels import ATTENTION_PATHS, LAUNCHES, reset_launches

    tag = tag or name
    weights = os.path.join(work, f"{tag}_bf16.pt")
    torch.save({k: v.bfloat16() for k, v in model_cpu.state_dict().items()}, weights)
    rng = np.random.default_rng(1)

    def serve_dir(sub, names):
        """Write one [2, 160³] request per name into a watch directory and
        serve them all; returns (latencies, out directory)."""
        watch = os.path.join(work, f"{tag}_{sub}")
        out = f"{watch}_out"
        os.makedirs(watch)
        for vol in names:
            path = os.path.join(watch, f"{vol}.npy")
            np.save(path, rng.normal(size=(2, 160, 160, 160)).astype(np.float32))
            os.utime(path, (time.time() - 5,) * 2)
        lat = serve.main(["--model", name, "--weights", weights,
                          "--model-kwargs", json.dumps(model_kwargs or {}),
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
    launches, paths = dict(LAUNCHES), dict(ATTENTION_PATHS)
    routes = all_routes()
    if want_routes is None:
        want_routes = {"dw_conv3": PATH_ROUTES if name == "mednext" else [],
                       "dw_conv3_wgrad": [], "dw_transpose2_wgrad": [],
                       "window_attention": ATTN_PATH_ROUTES if name == "micformer" else [],
                       "window_attention_backward": [], "fused_window_attention": [],
                       "fused_window_attention_backward": [], "biased_window_attention": []}
    peak = torch.cuda.max_memory_allocated()

    per_request = []
    for vol in names:
        seg = read_nifti(os.path.join(out, f"{vol}_seg.nii.gz"))
        if seg.shape != (160, 160, 160) or seg.max() >= 8:
            raise AssertionError(f"serve {tag}: bad segmentation for {vol}: {seg.shape}")
        with open(os.path.join(out, f"{vol}.done")) as f:
            per_request.append(json.load(f)["launches"])
    want = PATHS[name]["request"] if want is None else want
    res = {"model": name, "requests": len(lat), "cold_latency_s": cold,
           "latency_s": lat, "p50_s": statistics.median(lat),
           "vol_per_s": len(lat) / sum(lat), "wall_s": wall,
           "max_memory_allocated": peak, "launches": launches,
           "launches_per_request": per_request, "routes": routes, "attention_paths": paths}
    log(f"serve: {tag} {len(lat)} warm volumes 2x160³ bf16 roi 128 sw_batch 4: p50 "
        f"{res['p50_s']:.4f} s, {res['vol_per_s']:.3f} vol/s, latencies {lat}, "
        f"cold first request {cold:.4f} s, peak {peak / 2 ** 30:.2f} GiB, "
        f"launches {launches}, per request {per_request}, routes {routes}, attention "
        f"paths {paths}")
    if (len(lat) != 3 or per_request != [want] * 3
            or launches != {k: 3 * n for k, n in want.items()} or routes != want_routes):
        raise AssertionError(f"serve {tag}: {len(lat)} requests, launches {launches}, "
                             f"per request {per_request} (want 3 requests of {want}), "
                             f"routes {routes} (want {want_routes})")
    return res


def phase_swinunetr_serve(work):
    """SwinUNETR at the benchmark's widths (SWINUNETR_SERVED) through the
    serve loop as phase 5 serves its models: each request's window
    attentions all on the biased window attention kernel, half on each of
    the routes none and ids, none on the plain chain."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.kernels.biased_window_attention import ROUTES

    model_cpu = registry.build("swinunetr", device="cpu", num_classes=8,
                               generator=torch.Generator().manual_seed(0), **SWINUNETR_SERVED)
    log(f"model: swinunetr at the benchmark's widths "
        f"{sum(p.numel() for p in model_cpu.parameters())} parameters")
    n = SWINUNETR_REQUEST_BWA
    res = phase_serve("swinunetr", model_cpu, work, want=expect(biased_window_attention=n),
                      want_routes={k: BWA_PATH_ROUTES if k == "biased_window_attention" else []
                                   for k in KERNELS},
                      model_kwargs=SWINUNETR_SERVED, tag="swinunetr_bench")
    want_paths = {k: 3 * c for k, c in _paths(bwa=n).items()}
    want_routes = {"none": 3 * n // 2, "ids": 3 * n // 2, "additive": 0}
    if res["attention_paths"] != want_paths or dict(ROUTES) != want_routes:
        raise AssertionError(f"serve swinunetr_bench: attention paths {res['attention_paths']} "
                             f"(want {want_paths}), routes {dict(ROUTES)} (want {want_routes})")
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
                  "mednext": expect(dw_conv3=36, dw_conv3_wgrad=18, dw_transpose2_wgrad=4),
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


def _rank_tensor(rank, world, device, spec):
    """(11) this rank's shard of the full-width MicFormer (seed 0) through
    tensor_parallel_apply on spec["x"], f32 (TF32 off) and bf16: K1's
    launches and routes, the all-reduces' count and summed ms (host clock
    with a synchronise each side) and the wall ms of one forward after a
    warm-up, peak memory, the share of parameters this rank holds and the
    modules the plan keeps whole; rank 0 saves both outputs."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from micformer_tpu_torch.parallel import tensor as tp

    model = registry.build("micformer", device=device,
                           generator=torch.Generator().manual_seed(0))
    whole = sum(p.numel() for p in model.parameters())
    kept = tp.replicated_modules(model, world)
    shard = tp.shard_tensor_parallel(model, rank, world)
    del model
    res = {"share": sum(p.numel() for p in shard.parameters()) / whole, "replicated": kept}
    x = torch.load(spec["x"], weights_only=True).to(device)
    reduce_sum = tp.all_reduce_sum
    stats = {}

    def timed(y, group=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce_sum(y, group)
        torch.cuda.synchronize()
        stats["n"] = stats.get("n", 0) + 1
        stats["ms"] = stats.get("ms", 0.0) + 1e3 * (time.perf_counter() - t0)
        return out

    for dt in (torch.float32, torch.bfloat16):
        net, xin = shard.to(dt), x.to(dt)
        _set_tf32(False)
        try:
            with torch.no_grad():
                tp.tensor_parallel_apply(net, xin)           # warm-up (cuDNN, gloo)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                reset_all_routes()
                t0 = time.perf_counter()
                y = tp.tensor_parallel_apply(net, xin)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
                launches, routes = dict(LAUNCHES), all_routes()
                peak = torch.cuda.max_memory_allocated()
                stats.clear()
                tp.all_reduce_sum = timed
                try:
                    tp.tensor_parallel_apply(net, xin)
                finally:
                    tp.all_reduce_sum = reduce_sum
        finally:
            _set_tf32(True)
        key = str(dt).split(".")[-1]
        res[key] = {"wall_ms": wall, "launches": launches, "routes": routes,
                    "max_memory_allocated": peak, "all_reduces": stats.get("n", 0),
                    "all_reduce_ms": stats.get("ms", 0.0)}
        if rank == 0:
            torch.save(y.float().cpu(), os.path.join(spec["work"], f"tp_{key}.pt"))
        del y
    return res


RANK_TASKS = {"train": _rank_train, "parity": _rank_parity, "predict": _rank_predict,
              "tensor": _rank_tensor}


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
    if key == "mednext":
        want_routes["dw_transpose2_wgrad"] = DWT2_PATH_ROUTES
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


# phase 10: the zoo. Its models at their published widths (MM-WHS configs:
# UNet3D 4-8-16-32-64; nnFormer embed 96, heads 3-6-12-24, windows 4-4-8-4;
# SwinUnet3D hidden 96, heads 3-6-9-12, head_dim 32, window 4; VT-UNet embed
# 96, depths 2-2-2-1, heads 3-6-12-24, window 7; SwinUNETR feature size 12,
# depths 2-4-2-2, heads 2-4-8-12, window 7; TransBTS base 16, embed 512, 8
# heads, 4 layers, MLP 4096; TransUNet and its conv U-Nets channels
# 16-32-64-128-190-256, gates embed 64 with 8 heads): key -> (registry name,
# build kwargs for (a)'s 1x2x64³). The models built for an input are built
# for 64³ (nnFormer's two deepest windows, SwinUNETR's deepest, clamp there;
# TransBTS's pos_embed has 512 rows; TransUNet's gate patches 8-4-2-1-1)
ZOO_MODELS = {"unet3d": ("unet3d", {}),
              "nnformer": ("nnformer", {"deep_supervision": True, "input_size": 64}),
              "swinunet3d": ("swinunet3d", {}), "swinunet3d_pure": ("swinunet3d_pure", {}),
              "vtunet": ("vtunet", {}),
              "vtunet faithful_2d_merge": ("vtunet", {"faithful_2d_merge": True}),
              "swinunetr": ("swinunetr", {"input_size": 64}),
              "transbts": ("transbts", {"input_size": 64}),
              "transunet": ("transunet", {"input_size": 64}), "unet_conv": ("unet_conv", {}),
              "halfunet": ("halfunet", {}), "unet_patchify": ("unet_patchify", {})}
# (a) card against CPU at 1x2x64³, f32 without TF32: max |card - CPU| within
# this share of max |output| (f32 sums in another order through 20-50 layers;
# TransBTS's output is a probability)
ZOO_REL_BAR = 1e-4


def _paths(matmul=0, k1=0, bwa=0):
    return {"k1": k1, "k2": 0, "bwa": bwa, "matmul": matmul}


# launches and attention paths of one forward at 1x2x64³: SwinUnet3D's 14
# gated convs run K3; its window 4 clamps to the 2³ grid of the features
# stage, two unbiased blocks of 8 tokens, which is K1's regime (route ffma in
# f32); every other attention takes the plain chain: nnFormer's 14, all
# biased; SwinUnet3D's 16 of 64 tokens; VT-UNet's 7 encoder blocks and its 6
# decoder blocks' self and cross attention, all biased; SwinUNETR's 10
# biased blocks; TransBTS's 4 layers over 512 tokens; TransUNet's 5 gates
# (512 or 64 query tokens)
ZOO_SLICE = {"unet3d": (expect(), _paths()), "nnformer": (expect(), _paths(14)),
             "swinunet3d": (expect(dw_conv3=14, window_attention=2), _paths(16, 2)),
             "swinunet3d_pure": (expect(window_attention=2), _paths(16, 2)),
             "vtunet": (expect(), _paths(19)), "vtunet faithful_2d_merge": (expect(), _paths(19)),
             "swinunetr": (expect(), _paths(10)), "transbts": (expect(), _paths(4)),
             "transunet": (expect(), _paths(5)), "unet_conv": (expect(), _paths()),
             "halfunet": (expect(), _paths()), "unet_patchify": (expect(), _paths())}
# (c) one request: two forwards at sw_batch 4, roi 128 (no window clamps to
# 16 tokens or fewer); bf16 rows of 8 bytes at 4³ take K3's cp_async route.
# nnFormer's 14 windows a forward (64 and 512 tokens, heads of 16 and 32),
# SwinUnet3D's 18 (64 tokens, head 32) and VT-UNet's 19 (343 and 64 tokens,
# head 32) take the biased window attention kernel; SwinUNETR's heads of 6
# and 8, TransBTS's 4096 tokens and TransUNet's heads of 8 the plain chain.
# (launches, attention paths, routes, build kwargs of the served model)
ZOO_REQUEST = {"nnformer": (expect(biased_window_attention=28), _paths(bwa=28),
                            {"biased_window_attention": BWA_PATH_ROUTES}, {}),
               "swinunet3d": (expect(dw_conv3=28, biased_window_attention=36), _paths(bwa=36),
                              {"dw_conv3": ["cp_async", "tma", "volume"],
                               "biased_window_attention": BWA_PATH_ROUTES}, {}),
               "vtunet": (expect(biased_window_attention=38), _paths(bwa=38),
                          {"biased_window_attention": BWA_PATH_ROUTES}, {}),
               "swinunetr": (expect(), _paths(20), {}, {}),
               "transbts": (expect(), _paths(8), {}, {"input_size": 128}),
               "transunet": (expect(), _paths(10), {}, {})}
# (e) a seeded full-width 2D GenericUNet (base 32, five (2, 2) pools, k3,
# 512 features at most): 2 input channels for --engine 2d, 2 x 5 for p3d
UNET2D = {"base_num_features": 32, "pool_kernels": [[2, 2]] * 5,
          "conv_kernels": [[3, 3]] * 6, "max_features": 512}


def _zoo_slice(name, model_cpu):
    """(a): the model on the card against its CPU run at 1x2x64³ (f32, TF32
    off); the launches and attention paths of the card's forward."""
    from micformer_tpu_torch.kernels import ATTENTION_PATHS, LAUNCHES, reset_launches

    _set_tf32(False)
    try:
        model_gpu = copy.deepcopy(model_cpu).to("cuda")
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(1, 2, 64, 64, 64)).astype(np.float32))
        with torch.no_grad():
            reset_launches()
            reset_all_routes()
            out_gpu = model_gpu(x.cuda())
            torch.cuda.synchronize()
            launches, paths, routes = dict(LAUNCHES), dict(ATTENTION_PATHS), all_routes()
            out_cpu = model_cpu(x)
    finally:
        _set_tf32(True)
    outs = list(zip(out_gpu, out_cpu)) if isinstance(out_cpu, list) else [(out_gpu, out_cpu)]
    errs = []
    for g, c in outs:
        g = g.cpu()
        if g.shape[:2] != (1, 8) or not torch.isfinite(g).all():
            raise AssertionError(f"zoo slice {name}: bad output {tuple(g.shape)}")
        errs.append(((g - c).abs().max().item(), c.abs().max().item()))
    want_launches, want_paths = ZOO_SLICE[name]
    log(f"zoo (a) {name} 1x2x64³ f32, card vs CPU max |d| / max |logit| "
        f"{', '.join(f'{e:.3g} / {m:.3g}' for e, m in errs)} (bar {ZOO_REL_BAR} of max "
        f"|logit|), launches {launches}, routes {routes}, attention paths {paths}")
    if (any(not (e <= ZOO_REL_BAR * m) or m == 0.0 for e, m in errs)
            or launches != want_launches or paths != want_paths):
        raise AssertionError(f"zoo slice {name}: errors {errs}, launches {launches} (want "
                             f"{want_launches}), attention paths {paths} (want {want_paths})")
    del model_gpu
    torch.cuda.empty_cache()
    return {"errors": errs, "launches": launches, "attention_paths": paths, "routes": routes}


def _unet2d_run(run, in_channels, seed):
    """A run dir of a seeded full-width 2D GenericUNet (config.json and
    ckpt_best_dice.pt written through the port's modules)."""
    from micformer_tpu_torch import config as tcfg
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.train.checkpoint import CheckpointManager

    os.makedirs(run)
    cfg = tcfg.Config()
    cfg.model.name = "generic_unet"
    cfg.model.extra = dict(UNET2D, in_channels=in_channels)
    tcfg.save_config(cfg, os.path.join(run, "config.json"))
    model = registry.build("generic_unet", device="cpu", in_channels=in_channels,
                           generator=torch.Generator().manual_seed(seed), **UNET2D)
    CheckpointManager(run).save("best_dice", {"params": model.state_dict(), "step": 1})
    return run


def phase_zoo(work):
    """Phase 10: the zoo, see the module docstring."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.cli import predict
    from micformer_tpu_torch.data.mmwhs import get_datasets
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.infer import (
        sliding_window_inference, sliding_window_inference_2d,
    )
    from micformer_tpu_torch.kernels import ATTENTION_PATHS, LAUNCHES, reset_launches
    from micformer_tpu_torch.models.layers import RPE_COUNTS

    t_phase = time.perf_counter()
    res = {"slice": {}, "serve": {}, "train": {}, "predict": {}}
    # (a) and (c): each model built once on the CPU, seeded, at full width
    for key, (name, kwargs) in ZOO_MODELS.items():
        model_cpu = registry.build(name, device="cpu",
                                   generator=torch.Generator().manual_seed(0), **kwargs)
        log(f"zoo model: {key} {sum(p.numel() for p in model_cpu.parameters())} parameters")
        res["slice"][key] = _zoo_slice(key, model_cpu)
        if key in ZOO_REQUEST:
            want, want_paths, routes, served_kwargs = ZOO_REQUEST[key]
            if served_kwargs != kwargs:
                # the served model at roi 128 (nnFormer: its full-resolution head alone)
                del model_cpu
                model_cpu = registry.build(name, device="cpu", **served_kwargs,
                                           generator=torch.Generator().manual_seed(0))
            served = phase_serve(name, model_cpu, work, want=want, want_routes={
                k: routes.get(k, []) for k in KERNELS}, model_kwargs=served_kwargs)
            if served["attention_paths"] != {k: 3 * n for k, n in want_paths.items()}:
                raise AssertionError(f"serve {key}: attention paths "
                                     f"{served['attention_paths']} (want 3 x {want_paths})")
            res["serve"][key] = served
        del model_cpu

    # (d) cli/train on phase 6's root, bf16
    data, cache = os.path.join(work, "mmwhs"), os.path.join(work, "cache")
    common = ["--data", data, "--cache", cache, "--target-shape", str(TRAIN_SIZE), "--bf16",
              "--val", "1", "--workers", "2"]
    plan = [("nnformer", ["--cfg", os.path.join(ROOT, "configs", "nnformer_mmwhs.yaml"),
                          "--epochs", "2"], 1, (8, 8)),
            ("swinunet3d", ["--model", "swinunet3d", "--epochs", "1", "--batch-size", "2"], 2,
             (2, 2)),
            ("unet3d", ["--model", "unet3d", "--epochs", "1", "--batch-size", "2"], 2, (2, 2)),
            # VT-UNet as its config trains it (batch 2); the rest at batch 1,
            # as the reference's harnesses train them: one epoch of 4 steps
            ("vtunet", ["--cfg", os.path.join(ROOT, "configs", "vtunet_base.yaml"),
                        "--epochs", "1"], 2, (2, 2))]
    plan += [(name, ["--model", name, "--epochs", "1", "--batch-size", "1"], 1, (4, 4))
             for name in ("swinunetr", "transbts", "transunet", "unet_conv", "halfunet",
                          "unet_patchify")]
    for name, args, batch, steps in plan:
        run = ["--run-dir", os.path.join(work, f"run_{name}")]
        res["train"][name], trainer = train_run(f"zoo {name}", common + args + run, name,
                                                batch, steps)
        del trainer
        torch.cuda.empty_cache()

    # (e) predict on phase 7's root at 160³, roi 128, sw_batch 4, f32 (TF32 off)
    data, cache = os.path.join(work, "mmwhs_predict"), os.path.join(work, "cache_predict")
    size, roi, sw = 160, 128, 4
    _, _, test_ds = get_datasets(data, cache_dir=cache, target_shape=(size,) * 3)
    case = test_ds[0]
    vol = torch.tensor(case["image"][None], device="cuda")
    grid = ["--data", data, "--cache", cache, "--target-shape", str(size),
            "--sw-batch-size", str(sw), "--workers", "2"]
    runs = {"3d": os.path.join(work, "run_nnformer"),
            "transbts": os.path.join(work, "run_transbts"),
            "2d": _unet2d_run(os.path.join(work, "run_unet2d"), 2, 21),
            "p3d": _unet2d_run(os.path.join(work, "run_unet2d_p3d"), 10, 22)}
    plan = [("nnformer 3d", "3d", ["--roi", str(roi), "--mirror-tta", "--save-softmax"]),
            # TransBTS's output is already a probability: predict treats it as
            # it treats logits (its softmax file is the softmax of it)
            ("transbts 3d", "transbts", ["--roi", str(roi), "--mirror-tta", "--save-softmax"]),
            ("unet2d 2d", "2d", ["--roi", str(roi), "--engine", "2d"]),
            ("unet2d p3d", "p3d", ["--roi", str(roi), "--engine", "p3d",
                                   "--pseudo3d-slices", "5"])]
    _set_tf32(False)
    try:
        for name, run, extra in plan:
            out = os.path.join(work, f"pred_zoo_{run}")
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            reset_all_routes()
            rpe0 = dict(RPE_COUNTS)
            t0 = time.perf_counter()
            recs = predict.main(grid + extra + ["--out", out, "--run-dirs", runs[run]])
            wall = time.perf_counter() - t0
            launches, paths = dict(LAUNCHES), dict(ATTENTION_PATHS)
            rpe = {k: RPE_COUNTS[k] - rpe0[k] for k in rpe0}
            peak = torch.cuda.max_memory_allocated()
            r = {"wall_s": wall, "case_s": [x["seconds"] for x in recs],
                 "infer_s": [x["infer_seconds"] for x in recs], "launches": launches,
                 "attention_paths": paths, "max_memory_allocated": peak, "rel_pos": rpe}
            res["predict"][name] = r
            log(f"zoo (e) predict {name}: {len(recs)} cases 2x{size}³ f32 roi {roi} sw_batch "
                f"{sw}: seconds a case {r['case_s']} (to the label map {r['infer_s']}), wall "
                f"{wall:.2f} s, peak {peak / 2 ** 30:.2f} GiB, launches {launches}, "
                f"attention paths {paths}, rel-pos biases gathered / read from the cache {rpe}")
            # the 3d engine gathers each biased block's table once (materialize_rpe_cache)
            # and every forward after reads the cache; the other runs hold no table
            cache_ok = (rpe["gathered"] > 0 and rpe["cached"] > 0
                        and rpe["cached"] % rpe["gathered"] == 0) if run == "3d" else \
                rpe == {"gathered": 0, "cached": 0}
            if not cache_ok:
                raise AssertionError(f"predict {name}: rel-pos counts {rpe}")
            for x in recs:
                seg = read_nifti(os.path.join(out, f"{x['patient_id']}_pred.nii.gz"))
                if seg.shape != (size,) * 3 or seg.max() >= 8:
                    raise AssertionError(f"predict {name}: bad segmentation {seg.shape}")
            if len(recs) != 2 or launches != expect() or paths["k1"] or paths["k2"]:
                raise AssertionError(f"predict {name}: {len(recs)} cases, launches {launches}, "
                                     f"attention paths {paths}")

        # the 3d engine's softmax against a direct call on the checkpoint
        d3 = {}
        for run in ("3d", "transbts"):
            model = _run_model(runs[run], "cuda")
            sm = torch.softmax(sliding_window_inference(
                vol, (roi,) * 3, model, num_classes=8, overlap=0.5, sw_batch_size=sw,
                mirror_tta=True, tta_batched=False), dim=1)[0].cpu().numpy()
            saved = np.load(os.path.join(work, f"pred_zoo_{run}",
                                         f"{case['patient_id']}_softmax.npz"))[
                "softmax"].astype(np.float32)
            d3[run] = float(np.abs(sm - saved).max())
            del model
        # the 2d engine with one tile a slice (roi = the slice) against a dense
        # per-slice forward of the same network
        model = _run_model(runs["2d"], "cuda")
        with torch.no_grad():
            tiled = sliding_window_inference_2d(vol, (size, size), model, num_classes=8,
                                                sw_batch_size=sw)
            slices = vol[0].permute(1, 0, 2, 3)                  # [D, C, H, W]
            dense = torch.cat([model(part) for part in slices.split(32)])
            d2 = (tiled[0].permute(1, 0, 2, 3) - dense).abs().max().item()
            scale2 = dense.abs().max().item()
        del model, tiled, dense
    finally:
        _set_tf32(True)
    res["predict"]["3d vs direct"] = d3
    res["predict"]["2d one tile vs dense"] = {"max_abs": d2, "max_logit": scale2}
    log(f"zoo (e) 3d engine softmax vs a direct sliding_window_inference on "
        f"ckpt_best_dice.pt: nnFormer max |d| {d3['3d']:.3g}, TransBTS {d3['transbts']:.3g} "
        f"(limit 2e-3); 2d engine at roi {size}² (one "
        f"tile a slice) vs a dense per-slice forward: max |d| {d2:.3g} of max |logit| "
        f"{scale2:.3g} (limit 1e-4)")
    if not (max(d3.values()) <= 2e-3 and d2 <= 1e-4):
        raise AssertionError(f"zoo predict: 3d vs direct {d3}, 2d vs dense {d2}")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"zoo (phase 10): {res['wall_s']:.2f} s")
    return res


# phase 11: tensor parallelism. Full-width MicFormer at 1x2x128³ over two
# ranks sharing the card (gloo: NCCL takes one rank a device); each split
# attention runs its h/2 heads through K1 (f32: ffma; bf16: mma), the 3-head
# stage whole. Gate (f32, TF32 off): max |TP - single process| within
# TP_REL_BAR of max |logit| (the row-parallel sums split in two)
TP_SIZE = 128
TP_REL_BAR = 1e-5


def phase_tensor(work):
    """Phase 11: tensor parallelism, see the module docstring."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    tdir = os.path.join(work, "tensor")
    os.makedirs(tdir)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(1, 2) + (TP_SIZE,) * 3).astype(np.float32))
    torch.save(x, os.path.join(tdir, "x.pt"))
    # the single process's forward on the card, f32 (TF32 off) and bf16
    model = registry.build("micformer", generator=torch.Generator().manual_seed(0))
    single = {}
    _set_tf32(False)
    try:
        with torch.no_grad():
            for dt in (torch.float32, torch.bfloat16):
                net = model.to(dt)
                net(x.cuda().to(dt))
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                y = net(x.cuda().to(dt))
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                single[str(dt).split(".")[-1]] = (y.float().cpu(), ms, dict(LAUNCHES))
    finally:
        _set_tf32(True)
    del model, net, y
    torch.cuda.empty_cache()

    spec = {"work": tdir, "port": _free_port(), "device": "cuda", "size": TP_SIZE,
            "x": os.path.join(tdir, "x.pt"), "tasks": [("tensor", "tensor", {})]}
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(_rank_main, args=(2, spec), nprocs=2,
                                          start_method="spawn", join=True)
    ranks_wall = time.perf_counter() - t0
    outs = [torch.load(os.path.join(tdir, f"rank9_{r}.pt"), weights_only=False)["tensor"]
            for r in (0, 1)]
    res = {"ranks": outs, "ranks_wall_s": ranks_wall}
    want = PATHS["micformer"]["slice"]["window_attention"]
    log(f"tensor (11) the plan keeps {len(outs[0]['replicated'])} modules whole (3 heads "
        f"over 2 ranks): {outs[0]['replicated']}")
    for key in ("float32", "bfloat16"):
        got = torch.load(os.path.join(tdir, f"tp_{key}.pt"), weights_only=True)
        ref, ms, launches = single[key]
        err, top = (got - ref).abs().max().item(), ref.abs().max().item()
        res[key] = {"max_abs_err": err, "max_abs_logit": top, "single_ms": ms,
                    "single_launches": launches}
        route = "ffma" if key == "float32" else "mma"
        for r, o in enumerate(outs):
            q = o[key]
            log(f"tensor (11) MicFormer 1x2x{TP_SIZE}³ {key}, rank {r} of 2: K1 launches "
                f"{q['launches']['window_attention']} (single process "
                f"{launches['window_attention']}), routes {q['routes']['window_attention']}, "
                f"{q['all_reduces']} all-reduces in {q['all_reduce_ms']:.2f} ms, forward "
                f"{q['wall_ms']:.2f} ms (single process {ms:.2f} ms), peak "
                f"{q['max_memory_allocated'] / 2 ** 30:.2f} GiB, holds {o['share']:.4f} of the "
                "parameters")
            if (q["launches"]["window_attention"] != want
                    or q["routes"]["window_attention"] != [route]):
                raise AssertionError(f"tensor (11) rank {r} {key}: launches {q['launches']}, "
                                     f"routes {q['routes']} (want K1 {want} on {route})")
        log(f"tensor (11) {key}: max |TP - single process| {err:.3g} of max |logit| "
            f"{top:.3g} ({err / top:.3g}; bar {TP_REL_BAR} in f32, bf16 reported)")
        if key == "float32" and not err <= TP_REL_BAR * top:
            raise AssertionError(f"tensor (11): f32 max |d| {err} > {TP_REL_BAR} x {top}")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"tensor (phase 11): {res['wall_s']:.2f} s (ranks {ranks_wall:.2f} s)")
    return res


# phase 12: the serving artifacts. Launches a request at 160³, roi 128,
# sw_batch 4 (8 tiles, 2 forwards): K1's 192 (or K2's, fused) and K3's 36;
# the graph holds one op node a launch
EXPORT_SIZE = 160
EXPORT_ARTIFACTS = {
    "micformer": ("run", [], expect(window_attention=192)),
    "fused": ("run_fused", ["--fused-attention"], expect(fused_window_attention=192)),
    "mednext": ("run_mednext", [], expect(dw_conv3=36)),
}
# argmax agreement of artifact and live serving, and the f32 logits bar
EXPORT_AGREE = 0.9999
EXPORT_LOGITS_REL = 1e-5


def _wait(proc, t0):
    """(return code, seconds from start to exit) of a cli/export process."""
    proc.wait(timeout=900)
    return proc.returncode, time.perf_counter() - t0


def phase_export(work, live5):
    """cli/export from phase 6's runs at the bench protocol (bf16, 160³, roi
    128, overlap 0.5, gaussian, sw_batch 4, argmax) and an f32 --logits
    MicFormer artifact at 128³ (one tile), the four export processes started
    together; each artifact is checked as soon as its export ends, while
    the others still export: an argmax one served from disk by cli/serve
    --exported (one cold request, then three [2, 160³]) and held against
    serve's live composition of the same run on the same requests
    (`build_inference_fn`, in-process, each request timed as serve times
    it, run while the exports run), the logits one (TF32 off) against the live pipeline; then the
    host-side tools over phase 7's root (cli/plan, verify_dataset_integrity,
    the native reader and resizers). live5: phase 5's serve results."""
    from micformer_tpu_torch.cli import serve
    from micformer_tpu_torch.cli.serve import build_model
    from micformer_tpu_torch.convert.aot_export import build_inference_fn, load_artifact, op_nodes
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from micformer_tpu_torch.kernels.window_attention import ROUTES as ATTN_ROUTES

    t_phase = time.perf_counter()
    size, roi = EXPORT_SIZE, 128
    proto = ["--target-shape", str(size), "--roi", str(roi), "--overlap", "0.5",
             "--sw-batch-size", "4"]
    jobs = {key: ["--run-dir", os.path.join(work, run), "--out",
                  os.path.join(work, f"art_{key}"), "--bf16", *proto, *extra]
            for key, (run, extra, _) in EXPORT_ARTIFACTS.items()}
    jobs["logits"] = ["--run-dir", os.path.join(work, "run"), "--out",
                      os.path.join(work, "art_logits"), "--logits", "--target-shape",
                      str(roi), "--roi", str(roi), "--sw-batch-size", "4"]
    procs, started = {}, {}
    for key, argv in jobs.items():
        with open(os.path.join(work, f"export_{key}.log"), "w") as f:
            started[key] = time.perf_counter()
            procs[key] = subprocess.Popen(
                [sys.executable, "-m", "micformer_tpu_torch.cli.export", *argv], cwd=ROOT,
                stdout=f, stderr=subprocess.STDOUT)

    watch = os.path.join(work, "export_in")
    os.makedirs(watch)
    rng = np.random.default_rng(12)
    names = [f"q{i}" for i in range(4)]       # q0 is the cold request
    for n in names:
        np.save(os.path.join(watch, f"{n}.npy"),
                rng.normal(size=(2, size, size, size)).astype(np.float32))
        os.utime(os.path.join(watch, f"{n}.npy"), (time.time() - 5,) * 2)
    res = {"launches": expect()}

    def live_composition(key):
        """serve --run-dir's composition (build_model, build_inference_fn)
        of the run on the four requests, each timed as serve times it:
        (latencies, launches of each, peak memory, segmentations)."""
        run, extra, _ = EXPORT_ARTIFACTS[key]
        torch.cuda.reset_peak_memory_stats()
        _, model = build_model(run_dir=os.path.join(work, run), bf16=True,
                               fused_attention="--fused-attention" in extra, device="cuda")
        live = build_inference_fn(model, roi=(roi,) * 3, overlap=0.5, sw_batch_size=4)
        lat, per, segs = [], [], []
        for n in names:
            img = np.load(os.path.join(watch, f"{n}.npy"))
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            with torch.no_grad():
                segs.append(live(torch.from_numpy(img[None]).to("cuda"))[0].cpu().numpy())
            lat.append(time.perf_counter() - t0)
            per.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        peak = torch.cuda.max_memory_allocated()
        del model, live
        torch.cuda.empty_cache()
        return lat, per, peak, segs

    def argmax_artifact(key, export_s, live):
        """serve --exported on the four requests, held against `live`, the
        live composition's results on them."""
        run, extra, want = EXPORT_ARTIFACTS[key]
        art, out = os.path.join(work, f"art_{key}"), os.path.join(work, f"art_{key}_out")
        with open(os.path.join(art, "meta.json")) as f:
            meta = json.load(f)
        mb = sum(os.path.getsize(os.path.join(art, f)) for f in meta["programs"].values()) / 1e6
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_all_routes()
        report = {}
        lat = serve.main(["--exported", art, "--out", out, "--watch", watch, "--max-requests",
                          str(len(names)), "--poll", "0.05", "--idle-exit", "300"],
                         report=report)
        launches, routes = dict(LAUNCHES), all_routes()
        peak = torch.cuda.max_memory_allocated()
        per, segs = [], []
        for n in names:
            with open(os.path.join(out, f"{n}.done")) as f:
                per.append(json.load(f)["launches"])
            segs.append(read_nifti(os.path.join(out, f"{n}_seg.nii.gz")))
        shutil.rmtree(art)
        live_lat, live_per, live_peak, live_segs = live
        differ = int(sum(np.count_nonzero(a != b) for a, b in zip(segs, live_segs)))
        total = len(names) * size ** 3
        want_nodes = dict({k: want[k] for k in report["op_nodes"] if k in want}, softmax=0)
        want_routes = {k: [] for k in KERNELS}
        for k, n in want.items():
            if n:
                want_routes[k] = PATH_ROUTES if k == "dw_conv3" else ATTN_PATH_ROUTES
        row = {"export_s": export_s, "artifact_mb": mb, "load_s": report["load_s"],
               "cold_s": lat[0], "p50_s": statistics.median(lat[1:]), "latency_s": lat,
               "max_memory_allocated": peak, "live_cold_s": live_lat[0],
               "live_p50_s": statistics.median(live_lat[1:]), "live_latency_s": live_lat,
               "live_max_memory_allocated": live_peak, "op_nodes": report["op_nodes"],
               "launches_per_request": per, "routes": routes, "voxels_differ": differ,
               "voxels": total, "agree": 1 - differ / total, "platforms": meta["platforms"]}
        phase5 = live5.get(key)
        log(f"export {key}: cli/export {export_s:.2f} s, {mb:.1f} MB; serve --exported: load "
            f"{row['load_s']:.2f} s, op nodes {row['op_nodes']}, cold {lat[0]:.4f} s, p50 "
            f"{row['p50_s']:.4f} s, latencies {lat}, peak {peak / 2 ** 30:.2f} GiB, launches "
            f"per request {per}, routes {routes}; serve's live composition of the run on "
            f"the same requests (while the exports ran): cold {live_lat[0]:.4f} s, p50 {row['live_p50_s']:.4f} s, "
            f"latencies {live_lat}, peak {live_peak / 2 ** 30:.2f} GiB"
            + (f" (phase 5's live serve of the same model, random weights: p50 "
               f"{phase5['p50_s']:.4f} s)" if phase5 else "")
            + f"; voxels that differ {differ} of {total} (agree {row['agree']:.6f}); at "
            f"{time.perf_counter() - t_phase:.2f} s of the phase")
        if (row["op_nodes"] != want_nodes or per != [want] * len(names)
                or launches != {k: len(names) * n for k, n in want.items()}
                or live_per != [want] * len(names) or routes != want_routes
                or row["agree"] < EXPORT_AGREE or meta["platforms"] != ["cuda"]):
            raise AssertionError(f"export {key}: op nodes {row['op_nodes']} (want "
                                 f"{want_nodes}), launches per request {per} and live "
                                 f"{live_per} (want {want}), routes {routes} (want "
                                 f"{want_routes}), agree {row['agree']} (want >= "
                                 f"{EXPORT_AGREE}), platforms {meta['platforms']}")
        for k in KERNELS:
            res["launches"][k] += launches[k]
        return row

    def logits_artifact(export_s):
        """The f32 logits artifact at 128³, TF32 off, against the live
        pipeline on q1's first 128³."""
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        art = os.path.join(work, "art_logits")
        t0 = time.perf_counter()
        fn, _ = load_artifact(art)
        load_s = time.perf_counter() - t0
        nodes = op_nodes(fn)
        x = torch.from_numpy(np.load(os.path.join(watch, "q1.npy"))[None, :, :roi, :roi, :roi]
                             .copy()).cuda()
        reset_launches()
        reset_all_routes()
        with torch.no_grad():
            got = fn(x)
            torch.cuda.synchronize()
            launches, k1_routes = dict(LAUNCHES), dict(ATTN_ROUTES["window_attention"])
            _, model = build_model(run_dir=os.path.join(work, "run"), device="cuda")
            ref = build_inference_fn(model, roi=(roi,) * 3, sw_batch_size=4, argmax=False)(x)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        row = {"export_s": export_s, "load_s": load_s, "op_nodes": nodes, "max_abs_err": err,
               "max_abs_logit": scale, "launches": launches, "routes": k1_routes}
        log(f"export logits f32: cli/export {export_s:.2f} s, load {load_s:.2f} s, op nodes "
            f"{nodes}; max |artifact - live| {err:.3e} of max |logit| {scale:.3e} (bar "
            f"{EXPORT_LOGITS_REL:g} of it); launches {launches}, K1 routes {k1_routes}; at "
            f"{time.perf_counter() - t_phase:.2f} s of the phase")
        del fn, model, got, ref
        shutil.rmtree(art)
        torch.cuda.empty_cache()
        if (not err <= EXPORT_LOGITS_REL * scale or launches != expect(window_attention=96)
                or k1_routes["ffma"] != 96
                or nodes != {k: n for k, n in expect(window_attention=96).items()
                             if k in nodes} | {"softmax": 0}):
            raise AssertionError(f"export logits: max |d| {err} of {scale}, launches "
                                 f"{launches}, routes {k1_routes}, op nodes {nodes}")
        res["launches"]["window_attention"] += launches["window_attention"]
        return row

    pool = concurrent.futures.ThreadPoolExecutor(len(procs))
    try:
        waits = {pool.submit(_wait, procs[k], started[k]): k for k in procs}
        # the live references, while the exports run (each takes longer)
        lives = {key: live_composition(key) for key in EXPORT_ARTIFACTS}
        log(f"export: the live compositions of {list(lives)} done at "
            f"{time.perf_counter() - t_phase:.2f} s of the phase")
        for fut in concurrent.futures.as_completed(waits):
            key = waits[fut]
            rc, export_s = fut.result()
            with open(os.path.join(work, f"export_{key}.log")) as f:
                said = f.read()
            log(f"export {key}: rc {rc} after {export_s:.2f} s\n{said.strip()[-4000:]}")
            if rc != 0:
                raise AssertionError(f"export {key}: cli/export failed (rc {rc})")
            res[key] = logits_artifact(export_s) if key == "logits" else \
                argmax_artifact(key, export_s, lives[key])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        pool.shutdown()

    res["host"] = phase_host_tools(work)
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"export phase: {res['wall_s']:.2f} s")
    return res


def phase_host_tools(work):
    """cli/plan and verify_dataset_integrity over phase 7's root; whether
    the native library built (its compiler message when not), and where it
    did, its reader and resizers against the Python ones: reader within
    1e-6, trilinear within 1e-3, nearest exactly."""
    from micformer_tpu_torch import native
    from micformer_tpu_torch.cli import plan
    from micformer_tpu_torch.data import image_utils as iu
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.pipeline.sanity_checks import verify_dataset_integrity

    data, out = os.path.join(work, "mmwhs_predict"), os.path.join(work, "plans")
    t0 = time.perf_counter()
    plan.main(["--data", data, "--out", out])
    with open(os.path.join(out, "plan_3d.json")) as f:
        plan3d = json.load(f)
    report = verify_dataset_integrity(data)
    res = {"plan_s": time.perf_counter() - t0, "patch_size": plan3d["patch_size"],
           "integrity": report, "native_built": native.available(),
           "native_error": native.BUILD_ERROR}
    log(f"host: cli/plan and verify_dataset_integrity {res['plan_s']:.2f} s, 3D patch "
        f"{plan3d['patch_size']}, pools {plan3d['pool_op_kernel_sizes']}; integrity "
        f"{len(report['cases'])} cases, errors {report['errors']}, warnings "
        f"{report['warnings']}; native library built: {res['native_built']}"
        + (f" ({native.BUILD_ERROR})" if native.BUILD_ERROR else ""))
    if report["errors"] or not report["cases"] or len(plan3d["patch_size"]) != 3:
        raise AssertionError(f"host tools: integrity {report}, plan {plan3d}")
    if not res["native_built"]:
        return res
    path = sorted(glob.glob(os.path.join(data, "ct_*_image.nii.gz")))[0]
    py = read_nifti(path, with_header=True)[0].astype(np.float32)
    t0 = time.perf_counter()
    nat = native.read_nifti_f32(path)
    read_s = time.perf_counter() - t0
    vol = np.random.default_rng(4).normal(size=(30, 40, 25)).astype(np.float32)
    errs = {"read": float(np.abs(nat - py).max()),
            "trilinear": max(float(np.abs(native.resize_trilinear_f32(vol, s)
                                          - iu._resize_trilinear_py(vol, s)).max())
                             for s in ((64, 64, 64), (16, 16, 16))),
            "nearest": max(float(np.abs(native.resize_nearest_f32(vol, s)
                                        - iu.resize_nearest(vol, s)).max())
                           for s in ((48, 48, 48), (16, 16, 16)))}
    res.update(native_errors=errs, native_read_s=read_s)
    log(f"host: native against Python: max |d| {errs}, native read {read_s:.4f} s")
    if not (errs["read"] <= 1e-6 and errs["trilinear"] <= 1e-3 and errs["nearest"] == 0):
        raise AssertionError(f"host: native against Python: {errs}")
    return res


# phase 13: the reference's checkpoints. Per model: the port's rules, its
# importer, the launches of the imported model's forward and the reference
# keys that no rule reads (name -> shape; MicFormer's Head builds
# concat_back_dim.0, Linear(2·8E, 8E) at embed E = 48, and never uses it)
REFERENCE_DEVICE = "cuda"
REFERENCE_IMPORTS = {
    "micformer": ("convert.torch_import", "micformer", expect(window_attention=96),
                  {"swin.concat_back_dim.0.weight": (384, 768),
                   "swin.concat_back_dim.0.bias": (384,)}),
    "mednext": ("convert.zoo_import", "mednext", expect(dw_conv3=18), {}),
}


def phase_reference(work):
    """Phase 13: see the module docstring."""
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_reference import reference_state_dict

    from micformer_tpu_torch import registry
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    dev = REFERENCE_DEVICE
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, 64, 64, 64)).astype(np.float32)).to(dev)
    res = {"launches": expect()}
    try:
        for name, (module, family, want, dead) in REFERENCE_IMPORTS.items():
            mod = importlib.import_module(f"micformer_tpu_torch.{module}")
            src = registry.build(name, device=dev, generator=torch.Generator().manual_seed(0))
            gen = torch.Generator().manual_seed(1)
            extra = {k: torch.randn(shape, generator=gen).to(dev) for k, shape in dead.items()}
            ref = reference_state_dict(src.state_dict(), getattr(mod, f"{family}_rules")(src),
                                       extra)
            opt = torch.optim.AdamW(src.parameters(), lr=1e-4, weight_decay=1e-5)
            sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=100)
            path = os.path.join(work, f"reference_{name}", "model_best.pth.tar")
            os.makedirs(os.path.dirname(path))
            torch.save({"epoch": 100, "state_dict": ref, "optimizer": opt.state_dict(),
                        "scheduler": sched.state_dict()}, path)
            del ref, opt, sched
            dst = registry.build(name, device=dev, generator=torch.Generator().manual_seed(1))
            t0 = time.perf_counter()
            ckpt = torch.load(path, map_location=dev, weights_only=True)
            load_s = time.perf_counter() - t0
            state, unused = getattr(mod, f"{family}_state_from_torch")(ckpt["state_dict"], dst)
            dst.load_state_dict(state)
            if dev == "cuda":
                torch.cuda.synchronize()
            import_s = time.perf_counter() - t0
            theirs = dict(dst.named_parameters())
            differ = [k for k, p in src.named_parameters() if not torch.equal(p, theirs[k])]
            with torch.no_grad():
                want_out = src(x)
                reset_launches()
                got = dst(x)
                launches = dict(LAUNCHES)
            bitwise = torch.equal(got, want_out)
            res[name] = {"load_s": load_s, "import_s": import_s, "unused": unused,
                         "launches": launches, "bitwise": bitwise, "differ": differ,
                         "file_mb": os.path.getsize(path) / 2 ** 20}
            log(f"reference {name}: model_best.pth.tar {res[name]['file_mb']:.1f} MB, "
                f"torch.load onto {dev} {load_s:.3f} s, load and import {import_s:.3f} s; "
                f"unread keys {unused}; parameters differing from the source "
                f"{len(differ)}; forward 1x2x64³ f32 bitwise equal to the source's: "
                f"{bitwise}, launches {launches}")
            if (differ or not bitwise or launches != want or unused != sorted(dead)
                    or got.shape != (1, 8, 64, 64, 64) or not torch.isfinite(got).all()):
                raise AssertionError(
                    f"reference {name}: differing parameters {differ[:5]}, bitwise "
                    f"{bitwise}, launches {launches} (want {want}), unread {unused} "
                    f"(want {sorted(dead)}), output {tuple(got.shape)}")
            res["launches"] = {k: res["launches"][k] + launches[k] for k in launches}
            del src, dst, state, ckpt
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"reference phase: {res['wall_s']:.2f} s")
    return res


# phase 14: the last JAX features. (a) The inference rel-pos cache on the
# biased zoo models phase 10 serves, at its roi and build kwargs; the f32 bar
# (TF32 off): cached against uncached within this share of max |logit| (the
# same bias values, so equal but for the order of sums)
FEATURE_CACHE_MODELS = ("swinunetr", "vtunet", "nnformer")
FEATURE_CACHE_REL = 1e-5
# (b) the two-platform artifact: phase 6's MedNeXt-S run, f32, 64³ at roi 64
# (one tile, one forward at sw_batch 4): 18 K3 op nodes in each program, 18
# launches a request from the cuda program, none from the cpu one. Its
# cli/export starts with phase 12's exports and runs behind them; live cpu
# serving (a MedNeXt-S forward of seconds on the host's cores) runs in a
# thread beside the cuda request; (a)'s timed forwards run before it starts
FEATURE_EXPORT_SIZE = 64


def start_platforms_export(work):
    """cli/export --platforms cuda cpu of phase 6's MedNeXt-S run, in the
    background: (process, start time, log path)."""
    size = FEATURE_EXPORT_SIZE
    log_path = os.path.join(work, "export_platforms.log")
    with open(log_path, "w") as f:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "micformer_tpu_torch.cli.export", "--run-dir",
             os.path.join(work, "run_mednext"), "--out", os.path.join(work, "art_platforms"),
             "--target-shape", str(size), "--roi", str(size), "--sw-batch-size", "4",
             "--platforms", "cuda", "cpu"], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    return proc, t0, log_path


def _event_ms(fn, reps=5):
    """Median device ms of fn() between CUDA events, after one call."""
    fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def phase_features(work, platforms_export):
    """Phase 14: see the module docstring. platforms_export: what
    start_platforms_export returned."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.cli import serve
    from micformer_tpu_torch.cli.serve import build_model
    from micformer_tpu_torch.convert.aot_export import build_inference_fn
    from micformer_tpu_torch.data.nifti import read_nifti
    from micformer_tpu_torch.kernels import LAUNCHES, reset_launches
    from micformer_tpu_torch.models.layers import (
        RPE_COUNTS, clear_rpe_cache, materialize_rpe_cache,
    )

    t_phase = time.perf_counter()
    size = FEATURE_EXPORT_SIZE
    run, art = os.path.join(work, "run_mednext"), os.path.join(work, "art_platforms")
    res = {"cache": {}, "artifact": {}, "launches": expect()}
    proc, t_export, log_path = platforms_export
    rc = proc.wait(timeout=600)
    export_s = time.perf_counter() - t_export
    with open(log_path) as f:
        said = f.read().strip()
    log(f"features (b) cli/export --platforms cuda cpu (started with phase 12's exports): rc "
        f"{rc}, done {export_s:.2f} s after its start\n{said[-2000:]}")
    if rc != 0:
        raise AssertionError(f"features: cli/export --platforms cuda cpu failed (rc {rc})")
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    watch = os.path.join(work, "features_in")
    os.makedirs(watch)
    img = np.random.default_rng(15).normal(size=(2, size, size, size)).astype(np.float32)
    np.save(os.path.join(watch, "q.npy"), img)
    os.utime(os.path.join(watch, "q.npy"), (time.time() - 5,) * 2)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    threads = torch.get_num_threads()

    def live(dev):
        """Live serving's segmentation of the request on `dev`."""
        _, model = build_model(run_dir=run, device=dev)
        with torch.no_grad():
            return build_inference_fn(model, roi=(size,) * 3, sw_batch_size=4)(
                torch.from_numpy(img[None]).to(dev))[0].cpu().numpy()

    try:
        # (a) the cache, with nothing else running on the host: its bf16
        # forwards are launch-bound and would feel a concurrent cpu forward
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        x = torch.from_numpy(np.random.default_rng(14).normal(
            size=(1, 2, 128, 128, 128)).astype(np.float32)).cuda()
        for name in FEATURE_CACHE_MODELS:
            model = registry.build(name, device="cuda", generator=torch.Generator().manual_seed(0),
                                   **ZOO_REQUEST[name][3])
            n = sum(getattr(m, "rel_pos_bias_table", None) is not None for m in model.modules())
            counts = []
            with torch.no_grad():
                c0 = dict(RPE_COUNTS)
                want = model(x)
                counts.append({k: RPE_COUNTS[k] - c0[k] for k in c0})
                materialize_rpe_cache(model, x)
                c0 = dict(RPE_COUNTS)
                got = model(x)
                counts.append({k: RPE_COUNTS[k] - c0[k] for k in c0})
                err, scale = (got - want).abs().max().item(), want.abs().max().item()
                del got, want
                clear_rpe_cache(model)
                model.to(torch.bfloat16)       # registry.build's bf16 model: the cast weights
                xb = x.bfloat16()
                ms_gathered = _event_ms(lambda: model(xb))
                materialize_rpe_cache(model, xb)
                ms_cached = _event_ms(lambda: model(xb))
            del model, xb
            torch.cuda.empty_cache()
            row = {"biased_blocks": n, "max_abs_err": err, "max_abs_logit": scale,
                   "counts_uncached": counts[0], "counts_cached": counts[1],
                   "bf16_ms_gathered": ms_gathered, "bf16_ms_cached": ms_cached}
            res["cache"][name] = row
            log(f"features (a) rel-pos cache {name} 1x2x128³: {n} biased blocks; f32 (TF32 off) "
                f"cached vs uncached max |d| {err:.3e} of max |logit| {scale:.3e} (bar "
                f"{FEATURE_CACHE_REL:g} of it); gathers / cache reads a forward uncached "
                f"{counts[0]}, cached {counts[1]}; bf16 forward {ms_gathered:.3f} ms gathering, "
                f"{ms_cached:.3f} ms from the cache (median of 5, CUDA events); at "
                f"{time.perf_counter() - t_phase:.2f} s of the phase")
            if (not err <= FEATURE_CACHE_REL * scale
                    or counts != [{"gathered": n, "cached": 0}, {"gathered": 0, "cached": n}]):
                raise AssertionError(f"features {name}: cached vs uncached {err} of {scale}, "
                                     f"counts {counts} (want {n} gathered, then {n} read)")

        # (b) each device's program served against live serving on that
        # device; live cpu serving runs beside the cuda request, two cores
        # left to the launching thread
        torch.set_num_threads(max(1, threads - 2))
        live_cpu = pool.submit(live, "cpu")
        torch.backends.cudnn.deterministic = True
        for dev in ("cuda", "cpu"):
            out, report = os.path.join(work, f"features_out_{dev}"), {}
            reset_launches()
            lat = serve.main(["--exported", art, "--device", dev, "--out", out, "--watch",
                              watch, "--max-requests", "1", "--poll", "0.05", "--idle-exit",
                              "300"], report=report)
            launches = dict(LAUNCHES)
            seg = read_nifti(os.path.join(out, "q_seg.nii.gz"))
            row = {"load_s": report["load_s"], "latency_s": lat[0],
                   "op_nodes": report["op_nodes"], "launches": launches}
            if dev == "cuda":
                reset_launches()
                want = live("cuda")
                row["live_launches"] = dict(LAUNCHES)
            else:
                want = live_cpu.result()
                torch.set_num_threads(threads)
            row["voxels_differ"] = int(np.count_nonzero(seg != want))
            res["artifact"][dev] = row
            log(f"features (b) serve --exported --device {dev}: load {row['load_s']:.2f} s, "
                f"request {row['latency_s']:.4f} s, op nodes {row['op_nodes']}, launches "
                f"{launches}" + (f" (live serving {row['live_launches']})" if dev == "cuda"
                                 else "") + f"; voxels that differ from live serving "
                f"{row['voxels_differ']} of {size ** 3}; at "
                f"{time.perf_counter() - t_phase:.2f} s of the phase")
            want_launches = expect(dw_conv3=18) if dev == "cuda" else expect()
            if (seg.shape != (size,) * 3 or row["voxels_differ"] or launches != want_launches
                    or row.get("live_launches", want_launches) != want_launches
                    or row["op_nodes"]["dw_conv3"] != 18):
                raise AssertionError(f"features {dev}: {row}")
        res["launches"]["dw_conv3"] += res["artifact"]["cuda"]["launches"]["dw_conv3"]
        if meta["platforms"] != ["cuda", "cpu"]:
            raise AssertionError(f"features: the artifact's platforms {meta['platforms']}")
        res["artifact"]["export_s"] = export_s
        res["artifact"]["mb"] = {p: os.path.getsize(os.path.join(art, f)) / 1e6
                                 for p, f in meta["programs"].items()}
    finally:
        pool.shutdown()
        torch.set_num_threads(threads)
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"features phase: {res['wall_s']:.2f} s")
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
    dw_pass_sums("dw_conv3 (SwinUnet3D b4 forward)", dw, SWIN_DW_SHAPES, SWIN_DW_STAGE_LAUNCHES)
    dw_pass_sums("dw_conv3 dx (SwinUnet3D b2 step)", dx, SWIN_DW_TRAIN_SHAPES,
                 SWIN_DW_STAGE_LAUNCHES)
    dw_pass_sums("dw_conv3_wgrad (SwinUnet3D b2 step)", wgrad, SWIN_DW_TRAIN_SHAPES,
                 SWIN_DW_STAGE_LAUNCHES)
    dwt2 = phase_dwt2_wgrad_kernel()
    dw_pass_sums("dw_transpose2_wgrad (b2 step)", dwt2, DWT2_TRAIN_SHAPES, [1, 1, 1, 1])
    bwa = phase_bwa_kernel()
    from micformer_tpu_torch import registry

    work = os.path.join(ROOT, ".chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    serve = {}
    platforms_export = None
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
        swin = phase_swinunetr_serve(work)
        train = phase_train(work)
        predicted = phase_predict(work)
        phase_train_rest(work)
        phase_parallel(work, predicted["direct"])
        zoo = phase_zoo(work)
        phase_tensor(work)
        platforms_export = start_platforms_export(work)
        exported = phase_export(work, serve)
        reference = phase_reference(work)
        features = phase_features(work, platforms_export)
    finally:
        if platforms_export is not None and platforms_export[0].poll() is None:
            platforms_export[0].kill()
            platforms_export[0].wait()
        shutil.rmtree(work, ignore_errors=True)

    # each kernel's line times its path's stage-0 call in bf16, q/k/v in the
    # layout of the path's self attention (sliced from the fused qkv
    # projection): K1 at serving's [16384, 8, 3, 16], its backward and K2 at
    # training's [4096, 8, 3, 16]; K3 on MedNeXt-S's [4, 32, 128³], the wgrad
    # kernel on its training [2, 32, 128³], the up convs' wgrad kernel on the
    # training up conv [2, 64, 64³] whose output is stage 0's, the biased
    # window attention kernel on SwinUNETR's [4000, 343, 3, 16] with the
    # shifted blocks' region ids. Launches are
    # each path's: K1 and K3 from the serve phase's three volumes, the
    # backwards and K2 from the train phase's runs that use them, both wgrad
    # kernels from the three MedNeXt runs; the biased window attention
    # kernel from the served SwinUNETR at the benchmark's widths and the
    # zoo's served requests;
    # K1, K2 and K3 add the export phase's (its artifacts' requests), K1
    # and K3 the reference phase's, K3 the features phase's (the cuda
    # request of the two-platform artifact)
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
                                     if n.startswith("mednext"))}),
             ("dw_transpose2_wgrad", stage0(dwt2, DWT2_TRAIN_SHAPES[-1][0]), dwt2,
              {"dw_transpose2_wgrad": sum(r["launches"]["dw_transpose2_wgrad"]
                                          for n, r in train.items() if n.startswith("mednext"))}),
             ("biased_window_attention", next(r for r in bwa if r["shape"] == list(BWA_SHAPES[0])
                                              and r["mask"] == "ids"), bwa,
              {"biased_window_attention": sum(r["launches"]["biased_window_attention"]
                                              for r in (swin, *zoo["serve"].values()))})]
    kernels = [{"name": name, **KERNELS[name],
                "launches": (launches[name] + exported["launches"][name]
                             + reference["launches"][name] + features["launches"][name]),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                **{k: row[k] for k in timed + ("layout", "k", "route") if k in row}}
               for name, row, rows, launches in lines]
    for kern in kernels:
        if not kern["launches"] > 0:
            raise AssertionError(f"{kern['name']} was not launched on its path")
    log(smi)
    log(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
