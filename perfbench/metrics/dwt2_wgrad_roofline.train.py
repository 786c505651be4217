"""dwt2_wgrad_roofline.train (%): the least time of the traced training
steps' weight gradients of MedNeXt's transposed depthwise up convs (x and
dy read, dy at twice each extent; dw and db written in f32; 2·k³
operations per x voxel and one per dy voxel) over the device time of the
kernels named `dw_transpose2_wgrad` (`csrc/dw_transpose2_wgrad.cu`: the
kernel and its reduction). The shapes are the up blocks' inputs in one
forward of the reference model."""

import re

DWT2 = re.compile(r"dw_transpose2_wgrad")


def _up_blocks(model):
    from perfbench.reference.mednext import Block

    return [m for m in model.modules() if isinstance(m, Block) and m.mode == "up"]


def _input_shape(m, args, out):
    B, C, L = args[0].shape[:3]
    return B, C, L


def read(ctx):
    seconds = sum(e.dur for e in ctx.kernels(DWT2)) * 1e-6
    if seconds <= 0 or ctx.stretch_steps == 0:
        return None
    k = ctx.config["kwargs"]["kernel"]
    least = 0.0
    for B, C, L in ctx.work._reference_calls(ctx.config, ctx.train_batch, ctx.mix["side"],
                                              _up_blocks, _input_shape):
        nx, ng = B * C * L ** 3, B * C * 8 * L ** 3
        nbytes = (nx + ng) * 2 + C * (k ** 3 + 1) * 4
        ops = 2 * k ** 3 * nx + ng
        least += ctx.work.least_seconds(nbytes, ops, ctx.work.PEAK_F32_CUDA_CORE_FLOPS)
    return 100.0 * ctx.stretch_steps * least / seconds
