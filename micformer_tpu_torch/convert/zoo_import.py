"""Reference PyTorch checkpoints of the zoo -> the port's state_dicts.

Counterpart of `micformer_tpu/convert/zoo_import.py`: for MedNeXt, TransBTS,
nnFormer, SwinUnet3D, TransUNet, VT-UNet and one VT-UNet block,
`<family>_rules(model)` names the reference keys that fill each parameter of
the port's `model`, and
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

`load_reference_<family>(reference_root, ...)` builds the reference's own
torch model from its source under `reference_root` (default
`torch_import.REFERENCE`) and returns it in eval mode: its modules are imported
read-only under synthetic packages (`torch_import._synthetic_package`,
`_load_module`), and the packages the reference imports but this
environment lacks are stand-ins (timm's DropPath, to_2tuple, to_3tuple and
trunc_normal_; positional_encodings' PositionalEncodingPermute3D; mmcv's
load_checkpoint; nnFormer's network base class and initialiser).
"""

from __future__ import annotations

import importlib
import os
import sys
import types

import numpy as np
import torch
import torch.nn as nn

from micformer_tpu_torch.convert.torch_import import (
    REFERENCE, Rule, Rules, _install_timm_shim, _load_module, _synthetic_package, import_state,
)

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


# ---------------------------------------------------------------------------
# the reference's own models, imported read-only for comparison
# ---------------------------------------------------------------------------

def _extend_timm_shim():
    """nnFormer, SwinUnet3D and VT-UNet also import to_3tuple, to_2tuple and
    trunc_normal_ from timm.models.layers: added to the stand-in (timm's
    semantics; trunc_normal_ as the stand-in the JAX package uses: a normal
    draw clamped to [a·std, b·std])."""
    _install_timm_shim()
    layers = sys.modules["timm.models.layers"]
    if hasattr(layers, "to_3tuple"):
        return

    def _to_ntuple(n):
        def cast(x):
            if isinstance(x, (tuple, list)):
                return tuple(x)
            return (x,) * n
        return cast

    def trunc_normal_(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0):
        with torch.no_grad():
            tensor.normal_(mean, std).clamp_(min=a * std, max=b * std)
        return tensor

    layers.to_2tuple = _to_ntuple(2)
    layers.to_3tuple = _to_ntuple(3)
    layers.trunc_normal_ = trunc_normal_


def _install_positional_encodings_shim():
    """TransUNet imports `positional_encodings.torch_encodings
    .PositionalEncodingPermute3D`; the package is not installed. The
    stand-in adds the package's encoding: per axis ceil(C/6)·2 channels of
    interleaved (sin, cos) pairs (`ops.pe.sinusoidal_pe_3d_interleaved`).
    Nothing is installed if a `positional_encodings` is imported already."""
    if "positional_encodings" in sys.modules:
        return
    from micformer_tpu_torch.ops.pe import sinusoidal_pe_3d_interleaved

    class PositionalEncodingPermute3D(nn.Module):
        def __init__(self, channels):
            super().__init__()
            self.channels = channels

        def forward(self, tensor):          # [N, C, D, H, W]
            _, c, d, h, w = tensor.shape
            pe = sinusoidal_pe_3d_interleaved(d, h, w, c)        # [D, H, W, C]
            pe = torch.from_numpy(np.moveaxis(pe, -1, 0)).to(tensor)
            return pe[None].expand_as(tensor)

    pkg = types.ModuleType("positional_encodings")
    te = types.ModuleType("positional_encodings.torch_encodings")
    te.PositionalEncodingPermute3D = PositionalEncodingPermute3D
    pkg.torch_encodings = te
    sys.modules["positional_encodings"] = pkg
    sys.modules["positional_encodings.torch_encodings"] = te


def _batch_stat_batchnorms(model: nn.Module) -> nn.Module:
    """Every BatchNorm3d of `model` normalises with the batch's statistics,
    in eval mode too (running statistics dropped): at batch 1 that is the
    InstanceNorm the port (and the JAX package) put in its place."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm3d):
            m.track_running_stats = False
            m.running_mean = None
            m.running_var = None
    return model


def load_reference_mednext(reference_root: str = REFERENCE, size: str = "S",
                           in_channels: int = 2, num_classes: int = 8,
                           kernel_size: int = 3, deep_supervision: bool = False):
    """The reference MedNeXt from its `create_mednext_v1`, in eval mode
    (activation checkpointing off: its path needs grad-enabled tensors)."""
    base = os.path.join(reference_root, "MedNeXt", "nnunet_mednext",
                        "network_architecture", "mednextv1")
    _synthetic_package("nnunet_mednext", os.path.dirname(os.path.dirname(base)))
    _synthetic_package("nnunet_mednext.network_architecture", os.path.dirname(base))
    pfx = "nnunet_mednext.network_architecture.mednextv1"
    _synthetic_package(pfx, base)
    _load_module(pfx + ".blocks", os.path.join(base, "blocks.py"))
    _load_module(pfx + ".MedNextV1", os.path.join(base, "MedNextV1.py"))
    create = _load_module(pfx + ".create_mednext_v1", os.path.join(base, "create_mednext_v1.py"))
    model = create.create_mednext_v1(in_channels, num_classes, size, kernel_size,
                                     deep_supervision)
    model.outside_block_checkpointing = False
    return model.eval()


def load_reference_transbts(reference_root: str = REFERENCE, img_dim: int = 32,
                            num_channels: int = 2, num_classes: int = 8,
                            embedding_dim: int = 512, num_heads: int = 8,
                            num_layers: int = 4, hidden_dim: int = 4096):
    """The reference TransBTS `BTS` at `img_dim`, in eval mode, with the two
    quirks the JAX loader neutralises: InitConv's dropout (F.dropout3d with
    no training flag, so it drops in eval too) set to 0, and the learned
    position embedding (hard-coded to 4096 tokens, all zeros) re-drawn from
    a normal of std 0.02 for the input's token count. Its BatchNorms use
    the batch's statistics (`_batch_stat_batchnorms`)."""
    base = os.path.join(reference_root, "TransBTS", "TransBTS")
    pkg = "_ref_transbts"
    _synthetic_package(pkg, base)
    for mod in ("IntmdSequential", "PositionalEncoding", "Unet_skipconnection", "Transformer",
                "TransBTS"):
        _load_module(f"{pkg}.{mod}", os.path.join(base, mod + ".py"))
    bts = sys.modules[f"{pkg}.TransBTS"].BTS
    model = bts(img_dim=img_dim, patch_dim=8, num_channels=num_channels,
                num_classes=num_classes, embedding_dim=embedding_dim, num_heads=num_heads,
                num_layers=num_layers, hidden_dim=hidden_dim, dropout_rate=0.0,
                attn_dropout_rate=0.0)
    n_tokens = (img_dim // 8) ** 3
    model.position_encoding.position_embeddings = nn.Parameter(
        0.02 * torch.randn(1, n_tokens, embedding_dim))
    model.Unet.InitConv.dropout = 0.0
    return _batch_stat_batchnorms(model).eval()


def load_reference_nnformer(reference_root: str = REFERENCE, crop_size=(64, 64, 64),
                            embed_dim: int = 96, in_channels: int = 2, num_classes: int = 8,
                            depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                            patch_size=(4, 4, 4), window_sizes=(4, 4, 8, 4),
                            deep_supervision: bool = False):
    """The reference nnFormer (nnFormer_tumor.py, the MM-WHS configuration),
    in eval mode. Its relative imports `.neural_network` and
    `.initialization` are stand-ins: the SegmentationNetwork base class (an
    nn.Module) and an InitWeights_He that leaves modules as they are."""
    _extend_timm_shim()
    pkg = "_ref_nnformer"
    base = os.path.join(reference_root, "nnFormer", "nnformer")
    _synthetic_package(pkg, base)
    if f"{pkg}.neural_network" not in sys.modules:
        nn_mod = types.ModuleType(f"{pkg}.neural_network")

        class SegmentationNetwork(nn.Module):
            pass

        nn_mod.SegmentationNetwork = SegmentationNetwork
        sys.modules[f"{pkg}.neural_network"] = nn_mod
        init_mod = types.ModuleType(f"{pkg}.initialization")

        class InitWeights_He:
            def __init__(self, neg_slope=1e-2):
                self.neg_slope = neg_slope

            def __call__(self, module):
                return module

        init_mod.InitWeights_He = InitWeights_He
        sys.modules[f"{pkg}.initialization"] = init_mod
    mod = _load_module(f"{pkg}.nnFormer_tumor", os.path.join(base, "nnFormer_tumor.py"))
    model = mod.nnFormer(
        crop_size=list(crop_size), embedding_dim=embed_dim, input_channels=in_channels,
        num_classes=num_classes, depths=list(depths), num_heads=list(num_heads),
        patch_size=list(patch_size), window_size=list(window_sizes),
        deep_supervision=deep_supervision)
    return model.eval()


def load_reference_swinunet3d(reference_root: str = REFERENCE, hidden_dim: int = 96,
                              layers=(2, 2, 4, 2), heads=(3, 6, 9, 12), in_channels: int = 2,
                              num_classes: int = 8, head_dim: int = 32, window_size: int = 4,
                              downscaling_factors=(4, 2, 2, 2)):
    """The reference SwinUnet3D (SwinUnet_3D.py), in eval mode."""
    _extend_timm_shim()
    base = os.path.join(reference_root, "SwinUnet", "SwinUnet_3DV1")
    mod = _load_module("_ref_swinunet3d", os.path.join(base, "SwinUnet_3D.py"))
    model = mod.SwinUnet3D(
        hidden_dim=hidden_dim, layers=list(layers), heads=list(heads), in_channel=in_channels,
        num_classes=num_classes, head_dim=head_dim, window_size=window_size,
        downscaling_factors=tuple(downscaling_factors))
    return model.eval()


def load_reference_transunet(reference_root: str = REFERENCE, input_shape=(2, 32, 32, 32),
                             num_classes: int = 8, num_channels_list=(8, 16, 32, 64),
                             patch_size_factor: int = 8):
    """The reference TransUNet (trans_unet.py), in eval mode. Its absolute
    imports resolve through synthetic `models` and `utils` packages over the
    reference tree; its BatchNorms use the batch's statistics."""
    base = os.path.join(reference_root, "TransUnet")
    for name in ("models", "models.segmentation", "models.encoders", "models.decoders",
                 "models.blocks", "utils"):
        _synthetic_package(name, os.path.join(base, *name.split(".")))
    _install_positional_encodings_shim()
    tu = importlib.import_module("models.segmentation.trans_unet")
    model = tu.TransUNet(input_shape=tuple(input_shape), num_classes=num_classes,
                         num_channels_list=list(num_channels_list),
                         patch_size_factor=patch_size_factor)
    return _batch_stat_batchnorms(model).eval()


def load_reference_vtunet_module(reference_root: str = REFERENCE):
    """The reference's vt_unet.py as a module (mmcv's load_checkpoint, the
    one mmcv name it uses, is a stand-in that does nothing)."""
    _extend_timm_shim()
    if "mmcv" not in sys.modules:
        mmcv = types.ModuleType("mmcv")
        runner = types.ModuleType("mmcv.runner")
        runner.load_checkpoint = lambda *a, **k: None
        mmcv.runner = runner
        sys.modules["mmcv"] = mmcv
        sys.modules["mmcv.runner"] = runner
    base = os.path.join(reference_root, "VT-Unet", "vtunet")
    return _load_module("_ref_vtunet", os.path.join(base, "vt_unet.py"))


def load_reference_vtunet(reference_root: str = REFERENCE, img_size=(128, 64, 64),
                          in_chans: int = 2, num_classes: int = 8, embed_dim: int = 48,
                          window_size=(7, 7, 7)):
    """The reference SwinTransformerSys3D in the VTUNet wrapper's
    configuration, in eval mode. Its PatchExpand_Up pins the token depth to
    32, so img_size's D must be 128; H, W and embed_dim may shrink."""
    mod = load_reference_vtunet_module(reference_root)
    model = mod.SwinTransformerSys3D(
        img_size=tuple(img_size), patch_size=(4, 4, 4), in_chans=in_chans,
        num_classes=num_classes, embed_dim=embed_dim, depths=[2, 2, 2, 1],
        depths_decoder=[1, 2, 2, 2], num_heads=[3, 6, 12, 24], window_size=tuple(window_size),
        mlp_ratio=4.0, qkv_bias=True, qk_scale=None, drop_rate=0.0, attn_drop_rate=0.0,
        drop_path_rate=0.1, patch_norm=True, use_checkpoint=False, frozen_stages=-1,
        final_upsample="expand_first")
    return model.eval()
