"""Reference PyTorch checkpoints of the zoo -> the port's state_dicts.

Counterpart of `micformer_tpu/convert/zoo_import.py`, without its loaders of
the reference's model code: for MedNeXt, TransBTS, nnFormer, SwinUnet3D,
TransUNet, VT-UNet and one VT-UNet block, `<family>_rules(model)` names the
reference keys that fill each parameter of the port's `model`, and
`<family>_state_from_torch(state_dict, model)` applies them
(`torch_import.import_state`: the transforms, the errors, and the reference
keys no rule read). Every size the mapping needs (block counts, depths, deep
supervision, the windows of the relative-position tables) is read from the
port model, which must be built as the reference was.

Where the layouts differ:
  - MedNeXt: decoder stage s of the port is the reference's `up_{3-s}` and
    `dec_block_{3-s}`; an up block's depthwise ConvTranspose3d takes a
    spatial flip, its 1³ ConvTranspose3d residual the swap of its first two
    axes (either port form of the up block takes them; `faithful_up=True`
    is the reference's, border planes included); the heads `out_{i}.conv_out`
    are `out` (i = 0) and `ds{i}`.
  - TransBTS: the reference's qkv has no bias, the port's is set to zeros;
    BatchNorm weight and bias go to the InstanceNorms; `pre_head_ln` is
    unused (the decoder reads the transformer's output before it).
  - nnFormer: each relative-position table is re-indexed from the
    reference's scrambled radix (`nnformer_rpe_remap`) for the window the
    port's table was built for (the window clamped to the crop, as the
    reference clamps at construction); decoder stage s of the port is the
    reference's `decoder.layers.{n-2-s}`.
  - SwinUnet3D: the shifted-window mask buffers are derived constants in
    the port, so they are unused.
  - TransUNet: nn.MultiheadAttention's packed in_proj weight and bias split
    three ways onto q, k and v; BatchNorm goes to InstanceNorm.
  - VT-UNet (`faithful_2d_merge=True`): the standard relative-position
    index, tables copied as they are.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from micformer_tpu_torch.convert.torch_import import Rule, Rules, import_state

# ---------------------------------------------------------------------------
# MedNeXt (MedNeXt/nnunet_mednext/network_architecture/mednextv1/)
# ---------------------------------------------------------------------------

_MEDNEXT_BLOCK = {"dw": "conv1", "expand": "conv2", "compress": "conv3", "res": "res_conv"}


def mednext_rules(model: nn.Module) -> Rules:
    """The reference MedNextV1's keys for the port's MedNeXt."""
    rules = Rules(model)
    bc = model.block_counts
    rules.module("stem", "stem")
    rules.module("out", "out_0.conv_out")
    for s in range(4):
        for b in range(bc[s]):
            rules.module(f"enc{s}_{b}", f"enc_block_{s}.{b}", _MEDNEXT_BLOCK)
        rules.module(f"down{s}", f"down_{s}", _MEDNEXT_BLOCK)
        up, ref = f"up{s}", f"up_{3 - s}"
        rules.module(up, ref, _MEDNEXT_BLOCK)
        rules[f"{up}.dw.weight"] = Rule((f"{ref}.conv1.weight",), "flip")
        rules[f"{up}.res.weight"] = Rule((f"{ref}.res_conv.weight",), "swap")
        for b in range(bc[5 + s]):
            rules.module(f"dec{s}_{b}", f"dec_block_{3 - s}.{b}", _MEDNEXT_BLOCK)
    for b in range(bc[4]):
        rules.module(f"bottleneck_{b}", f"bottleneck.{b}", _MEDNEXT_BLOCK)
    if model.deep_supervision:
        for i in range(1, 5):
            rules.module(f"ds{i}", f"out_{i}.conv_out")
    return rules


def mednext_state_from_torch(state_dict, model: nn.Module):
    """(state_dict, unused reference keys) for the port's MedNeXt."""
    return import_state(state_dict, model, mednext_rules(model))


# ---------------------------------------------------------------------------
# TransBTS (TransBTS/TransBTS/{TransBTS,Transformer,Unet_skipconnection}.py)
# ---------------------------------------------------------------------------

# EnBlock (GroupNorm) and the decoder's blocks (BatchNorm) name their norms so
_BN = {"norm1": "bn1", "norm2": "bn2"}


def transbts_rules(model: nn.Module) -> Rules:
    """The reference BTS's keys for the port's TransBTS."""
    rules = Rules(model)
    rules.module("init_conv", "Unet.InitConv.conv")
    for name, _ in model.named_children():
        if name.startswith("en"):                       # en1, en2_1, ..., en4_4
            rules.module(name, f"Unet.EnBlock{name[2:]}", _BN)
    for j in (1, 2, 3):
        rules.module(f"down{j}", f"Unet.EnDown{j}.conv")
    rules.module("pre_vit_norm", "bn")
    rules.module("conv_x", "conv_x")
    rules["pos_embed"] = Rule(("position_encoding.position_embeddings",))
    for i in range(model.num_layers):
        attn, ffn = f"transformer.net.{2 * i}.fn", f"transformer.net.{2 * i + 1}.fn"
        rules.module(f"vit{i}", "", {
            "norm1": f"{attn}.norm", "qkv": f"{attn}.fn.qkv", "proj": f"{attn}.fn.proj",
            "norm2": f"{ffn}.norm", "mlp.fc1": f"{ffn}.fn.net.0", "mlp.fc2": f"{ffn}.fn.net.3"})
        rules[f"vit{i}.qkv.bias"] = Rule((), "zeros")
    rules.module("bneck", "Enblock8_1", _BN)
    rules.module("deblock8", "Enblock8_2", _BN)
    for j, t in enumerate((4, 3, 2)):                   # deepest first
        rules.module(f"deup{j}_c1", f"DeUp{t}.conv1")
        rules.module(f"deup{j}_up", f"DeUp{t}.conv2")
        rules.module(f"deup{j}_c3", f"DeUp{t}.conv3")
        rules.module(f"deblock{j}", f"DeBlock{t}", _BN)
    rules.module("endconv", "endconv")
    return rules


def transbts_state_from_torch(state_dict, model: nn.Module):
    """(state_dict, unused reference keys) for the port's TransBTS."""
    return import_state(state_dict, model, transbts_rules(model))


# ---------------------------------------------------------------------------
# nnFormer (nnFormer/nnformer/nnFormer_tumor.py)
# ---------------------------------------------------------------------------

def _rpe_index(window) -> torch.Tensor:
    """For each displacement in the standard 3D Swin index (row
    (dz·(2wh-1) + dy)·(2ww-1) + dx), the reference's row: dz·(3wh-1) +
    dy·(2wh-1) + dx (nnFormer_tumor.py:184-186, :262-264)."""
    wd, wh, ww = window
    dz, dy, dx = np.meshgrid(np.arange(2 * wd - 1), np.arange(2 * wh - 1),
                             np.arange(2 * ww - 1), indexing="ij")
    return torch.from_numpy((dz * (3 * wh - 1) + dy * (2 * wh - 1) + dx).reshape(-1))


def nnformer_rpe_remap(table: torch.Tensor, window) -> torch.Tensor:
    """A reference nnFormer relative-position table re-indexed onto the
    standard index of `window`: row standard(d) takes row scrambled(d) for
    every displacement d. The scrambled index is not injective, so rows
    whose displacements collide share their values, as they do in the
    reference's lookup."""
    return table[_rpe_index(window).to(table.device)]


def _remap_tables(rules: Rules):
    """Re-index every relative-position table for the window its port table
    was built for."""
    for name in [n for n in rules if n.endswith("rel_pos_bias_table")]:
        window = rules.model.get_submodule(name.rpartition(".")[0]).table_window
        rules[name] = Rule(rules[name].refs, "rows", _rpe_index(window))


def nnformer_rules(model: nn.Module) -> Rules:
    """The reference nnFormer's keys for the port's NnFormer."""
    rules = Rules(model)
    rules.module("stem1", "model_down.patch_embed.proj1")
    rules.module("stem2", "model_down.patch_embed.proj2")
    rules.module("patch_norm", "model_down.patch_embed.norm")
    n = len(model.depths)
    for i in range(n):
        for b in range(model.depths[i]):
            rules.module(f"enc{i}_b{b}", f"model_down.layers.{i}.blocks.{b}")
        rules.module(f"skip_norm{i}", f"model_down.norm{i}")
        if i < n - 1:
            rules.module(f"merge_norm{i}", f"model_down.layers.{i}.downsample.norm")
            rules.module(f"merge{i}", f"model_down.layers.{i}.downsample.reduction")
    for s in range(n - 1):
        ref = f"decoder.layers.{n - 2 - s}"             # built shallow to deep
        rules.module(f"up_norm{s}", f"{ref}.Upsample.norm")
        rules.module(f"up{s}", f"{ref}.Upsample.up")
        rules.module(f"dec{s}_kv", f"{ref}.blocks.0",
                     {"": "attn", "kv": "attn.kv", "proj": "attn.proj"})
        for b in range(1, model.dec_depths[s]):
            rules.module(f"dec{s}_b{b}", f"{ref}.blocks.{b}")
    for name, _ in model.named_children():
        if name.startswith("head"):                     # head0, and the pyramid's
            rules.module(name, f"final.{name[4:]}.up")
    _remap_tables(rules)
    return rules


def nnformer_state_from_torch(state_dict, model: nn.Module):
    """(state_dict, unused reference keys) for the port's NnFormer."""
    return import_state(state_dict, model, nnformer_rules(model))


# ---------------------------------------------------------------------------
# SwinUnet3D (SwinUnet/SwinUnet_3DV1/SwinUnet_3D.py)
# ---------------------------------------------------------------------------

# SwinBlock3D: Residual(PreNorm(attention)), Residual(PreNorm(MLP)); the
# gated ConvBlock: conv, Norm, PReLU twice (a Norm's LayerNorm is its net.1)
_SWIN_BLOCK = {"norm1": "attention_block.fn.norm", "attn.qkv": "attention_block.fn.fn.to_qkv",
               "attn.proj": "attention_block.fn.fn.to_out", "norm2": "mlp_block.fn.norm",
               "mlp.fc1": "mlp_block.fn.fn.net.0", "mlp.fc2": "mlp_block.fn.fn.net.2"}
_GATE = {"conv1": "net.0", "norm1.norm": "net.1.net.1", "act1": "net.2",
         "conv2": "net.3", "norm2.norm": "net.4.net.1", "act2": "net.5"}
_SWIN_STAGES = {"down12": "down_stage12", "down3": "down_stage3", "down4": "down_stage4",
                "features": "features", "up4": "up_stage4", "up3": "up_stage3",
                "up12": "up_stage12"}


def swinunet3d_rules(model: nn.Module) -> Rules:
    """The reference SwinUnet3D's keys for the port's SwinUnet3D (the
    reference's form: gated convs, conv patch merging)."""
    rules = Rules(model)
    for dst, src in _SWIN_STAGES.items():
        stage = model.get_submodule(dst)
        resample = "patch_expand" if stage.up else "patch_partition"
        renames = {"expand": f"{resample}.net.0", "merge": f"{resample}.net.0",
                   "norm.norm": f"{resample}.net.1.net.1",
                   **{f"conv_block.{k}": f"conv_block.{v}" for k, v in _GATE.items()}}
        for i in range(stage.pairs):
            for kind, j in (("reg", 0), ("shift", 1)):
                renames.update({f"swin{i}_{kind}.{k}": f"swin_layers.{i}.{j}.{v}"
                                for k, v in _SWIN_BLOCK.items()})
        rules.module(dst, src, renames)
    for name in ("converge4", "converge3", "converge12"):
        rules.module(name, name, {"norm": "norm.net.1"})
    rules.module("final_expand", "final.net.0")
    rules.module("final_norm", "final.net.1", {"norm": "net.1"})
    rules.module("final_act", "final.net.2")
    rules.module("head", "out.0")
    return rules


def swinunet3d_state_from_torch(state_dict, model: nn.Module):
    """(state_dict, unused reference keys) for the port's SwinUnet3D."""
    return import_state(state_dict, model, swinunet3d_rules(model))


# ---------------------------------------------------------------------------
# TransUNet (TransUnet/models/segmentation/trans_unet.py)
# ---------------------------------------------------------------------------

_DOUBLE = {"conv1": "conv_block_1.convolution", "norm1": "conv_block_1.normalization",
           "conv2": "conv_block_2.convolution", "norm2": "conv_block_2.normalization"}
_GATE_MHA = "vision_attention.multihead_attention_block"


def transunet_rules(model: nn.Module) -> Rules:
    """The reference TransUNet's keys for the port's TransUNet."""
    rules = Rules(model)
    for i in range(model.levels):
        rules.module(f"enc{i}", f"encoder.conv_blocks.{i}", _DOUBLE)
    for j in range(model.levels - 1):
        if model.attention_gates:
            gate, ref = f"gate{j}", f"decoder.attention_blocks.{j}"
            rules.module(gate, ref, {"embed_skip": "patch_embed_skip.convolution",
                                     "embed_dec": "patch_embed_decoder.convolution",
                                     "out": f"{_GATE_MHA}.out_proj",
                                     "upscale": "upscale_attention.transpose_conv"})
            E = model.get_submodule(gate).q.out_features
            for t, name in enumerate("qkv"):
                for leaf in ("weight", "bias"):
                    rules[f"{gate}.{name}.{leaf}"] = Rule(
                        (f"{ref}.{_GATE_MHA}.in_proj_{leaf}",), "rows", slice(t * E, (t + 1) * E))
        rules.module(f"up{j}", f"decoder.upscaling_layers.{j}.transpose_conv")
        rules.module(f"dec{j}", f"decoder.conv_blocks.{j}", _DOUBLE)
    rules.module("head", "output_layer")
    return rules


def transunet_state_from_torch(state_dict, model: nn.Module):
    """(state_dict, unused reference keys) for the port's TransUNet."""
    return import_state(state_dict, model, transunet_rules(model))


# ---------------------------------------------------------------------------
# VT-UNet (VT-Unet/vtunet/vt_unet.py, SwinTransformerSys3D)
# ---------------------------------------------------------------------------

def vtunet_block_rules(block: nn.Module) -> Rules:
    """A reference SwinTransformerBlock3D's keys (its own state_dict) for
    the port's VTBlock: the same names, the table in the standard index."""
    rules = Rules(block)
    rules.module("", "")
    return rules


def vtunet_block_state_from_torch(state_dict, block: nn.Module):
    """(state_dict, unused reference keys) for the port's VTBlock from a
    reference block's state_dict."""
    return import_state(state_dict, block, vtunet_block_rules(block))


def vtunet_rules(model: nn.Module) -> Rules:
    """The reference SwinTransformerSys3D's keys for the port's VTUNet built
    with faithful_2d_merge=True."""
    rules = Rules(model)
    for name in ("patch_embed", "norm", "norm_up"):
        rules.module(name, name)
    rules.module("up0", "layers_up.0")
    rules.module("final_expand", "up")
    rules.module("head", "output")
    n = len(model.depths)
    for i in range(n):
        for b in range(model.depths[i]):
            rules.module(f"enc{i}_b{b}", f"layers.{i}.blocks.{b}")
        if i < n - 1:
            rules.module(f"merge{i}", f"layers.{i}.downsample")
    for inx in range(1, n):
        rules.module(f"concat_back{inx}", f"concat_back_dim.{inx}")
        for b in range(model.depths[n - 1 - inx]):
            rules.module(f"dec{inx}_b{b}", f"layers_up.{inx}.blocks.{b}")
        if inx < n - 1:
            rules.module(f"up{inx}", f"layers_up.{inx}.upsample")
    return rules


def vtunet_state_from_torch(state_dict, model: nn.Module):
    """(state_dict, unused reference keys) for the port's VTUNet."""
    return import_state(state_dict, model, vtunet_rules(model))
