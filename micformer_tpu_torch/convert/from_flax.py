"""flax parameter tree -> the port's state_dict.

Inverts the layout rules of `micformer_tpu/convert/torch_import.py`:
  - Dense kernel [in, out]                 -> Linear.weight = kernel.T
  - Conv kernel [kd, kh, kw, in, out]      -> Conv3d.weight = permute(4, 3, 0, 1, 2)
    ([kh, kw, in, out] -> Conv2d.weight = permute(3, 2, 0, 1))
  - ConvTranspose kernel [kd, kh, kw, in, out] (flax correlates the dilated
    input with the kernel as is)           -> ConvTranspose3d.weight =
                                              permute(3, 4, 0, 1, 2), spatially flipped
    (2D likewise: permute(2, 3, 0, 1), flipped)
  - Conv3x3ViaDot taps [27, in, out]       -> Conv3d.weight[:, :, dz, dy, dx] =
                                              taps[dz*9 + dy*3 + dx].T
  - LayerNorm, InstanceNorm, GroupNorm scale / bias -> weight / bias
  - rel_pos_bias_table, PReLU alpha, pos_embed -> the same name, as is

The walk follows the flax tree alongside the torch modules: a flax name is
the torch attribute name, except flax's automatic names, which are renamed per
torch module class below. A flax leaf that no torch parameter takes, or a
torch parameter that no flax leaf fills, raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from micformer_tpu_torch.models.layers import InstanceNorm

# the flax auto-names of two (conv k3, InstanceNorm) pairs
_DOUBLE = {"Conv_0": "conv1", "InstanceNorm_0": "norm1", "Conv_1": "conv2",
           "InstanceNorm_1": "norm2"}
# flax auto-names -> torch attribute names (dotted: a submodule's), per
# torch module class
_RENAMES = {
    "SwinBlock3D": {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2", "Mlp_0": "mlp"},
    "Mlp": {"Dense_0": "fc1", "Dense_1": "fc2"},
    "PatchEmbed3D": {"Conv_0": "proj", "LayerNorm_0": "norm"},
    "PatchMergingConv": {"Conv_0": "conv", "LayerNorm_0": "norm"},
    "PatchExpandConv": {"ConvTranspose_0": "conv", "LayerNorm_0": "norm"},
    "ConvInLRelu": {"Conv_0": "conv", "InstanceNorm_0": "norm"},
    "ConvNormAct": {"Conv_0": "conv", "ConvTranspose_0": "conv", "PReLU_0": "act"},
    "ConvStem": {"Conv_0": "conv1", "LayerNorm_0": "norm1", "Conv_1": "conv2",
                 "LayerNorm_1": "norm2"},
    "ChannelNorm": {"LayerNorm_0": "norm"},
    "GatedConvBlock": {"Conv_0": "conv1", "ChannelNorm_0": "norm1", "PReLU_0": "act1",
                       "Conv_1": "conv2", "ChannelNorm_1": "norm2", "PReLU_1": "act2"},
    "SwinStage": {"ChannelNorm_0": "norm"},
    "SwinUnet3D": {"ChannelNorm_0": "final_norm", "PReLU_0": "final_act"},
    "PatchMergingLinear": {"LayerNorm_0": "norm", "Dense_0": "reduction"},
    "PatchExpandLinear": {"Dense_0": "expand", "LayerNorm_0": "norm"},
    "FinalPatchExpand": {"Dense_0": "expand", "LayerNorm_0": "norm"},
    "ResConvBlock": _DOUBLE,
    "UpBlock": {"ConvTranspose_0": "up", "ResConvBlock_0": "block"},
    "DoubleConv": _DOUBLE,
    "EnBlock": {"GroupNorm_0": "norm1", "Conv_0": "conv1", "GroupNorm_1": "norm2",
                "Conv_1": "conv2"},
    "ViTBlock": {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2", "Mlp_0": "mlp"},
    # the bottleneck's double conv, unnamed at TransBTS's level in flax
    "TransBTS": {k: f"bneck.{v}" for k, v in _DOUBLE.items()},
}
# leaves kept as they are, by flax name: relative-position bias tables
# [rows, heads], PReLU slopes and TransBTS's positional embedding [1, N, E]
_AS_IS = ("rel_pos_bias_table", "alpha", "pos_embed")


def _convert_leaf(mod: nn.Module, key: str, a: np.ndarray, path: str):
    """(torch parameter name within mod, tensor) for flax leaf `key`."""
    if key in _AS_IS:
        return key, a
    if isinstance(mod, (nn.LayerNorm, InstanceNorm)):
        return {"scale": "weight", "bias": "bias"}[key], a
    if key == "bias":
        return "bias", a
    if key != "kernel":
        raise KeyError(f"{path}: unexpected flax leaf for {type(mod).__name__}")
    if isinstance(mod, nn.Linear):
        return "weight", a.T
    if isinstance(mod, nn.ConvTranspose3d):
        return "weight", a.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1]
    if isinstance(mod, nn.ConvTranspose2d):
        return "weight", a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if isinstance(mod, nn.Conv3d):
        if a.ndim == 3:                       # Conv3x3ViaDot taps [27, in, out]
            return "weight", a.reshape(3, 3, 3, *a.shape[1:]).transpose(4, 3, 0, 1, 2)
        return "weight", a.transpose(4, 3, 0, 1, 2)
    if isinstance(mod, nn.Conv2d):
        return "weight", a.transpose(3, 2, 0, 1)
    raise KeyError(f"{path}: no rule for a kernel on {type(mod).__name__}")


def _leaves(params: dict, model: nn.Module):
    """(flax path joined by "/", torch parameter name, array in the torch
    layout) for every leaf of the flax tree, walking `model` alongside."""

    def walk(mod: nn.Module, tree: dict, prefix: str, fpath: str):
        renames = _RENAMES.get(type(mod).__name__, {})
        for key, val in tree.items():
            path = f"{fpath}{key}"
            if isinstance(val, dict):
                name = renames.get(key, key)
                try:
                    child = mod.get_submodule(name)
                except AttributeError:
                    raise KeyError(f"flax subtree {path} has no torch module") from None
                yield from walk(child, val, f"{prefix}{name}.", f"{path}/")
                continue
            name, arr = _convert_leaf(mod, key, np.asarray(val, np.float32), path)
            yield path, f"{prefix}{name}", arr

    yield from walk(model, params, "", "")


def state_dict_from_flax(params: dict, model: nn.Module) -> dict[str, torch.Tensor]:
    """Map a flax parameter tree (nested dicts of arrays) onto `model`'s
    parameters. Returns a state_dict that `model.load_state_dict` takes."""
    out: dict[str, torch.Tensor] = {}
    want = dict(model.named_parameters())
    for path, full, arr in _leaves(params, model):
        if full not in want:
            raise KeyError(f"flax leaf {path} -> {full}: no such torch parameter")
        if tuple(arr.shape) != tuple(want[full].shape):
            raise ValueError(f"flax leaf {path}: shape {arr.shape} does not fit "
                             f"{full} {tuple(want[full].shape)}")
        # a copy: a flip over unit axes keeps negative strides that numpy
        # still calls contiguous and torch refuses
        out[full] = torch.tensor(arr.copy())
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"torch parameters not filled from flax: {missing}")
    return out


def flax_names(params: dict, model: nn.Module) -> dict[str, str]:
    """Torch parameter name -> the path of the flax leaf that fills it."""
    return {full: path for path, full, _ in _leaves(params, model)}
