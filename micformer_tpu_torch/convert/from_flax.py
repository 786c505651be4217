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
  - LayerNorm, InstanceNorm scale / bias   -> weight / bias

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

# flax auto-names -> torch attribute names, per torch module class
_RENAMES = {
    "SwinBlock3D": {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2", "Mlp_0": "mlp"},
    "Mlp": {"Dense_0": "fc1", "Dense_1": "fc2"},
    "PatchEmbed3D": {"Conv_0": "proj", "LayerNorm_0": "norm"},
    "PatchMergingConv": {"Conv_0": "conv", "LayerNorm_0": "norm"},
    "PatchExpandConv": {"ConvTranspose_0": "conv", "LayerNorm_0": "norm"},
    "ConvInLRelu": {"Conv_0": "conv", "InstanceNorm_0": "norm"},
}


def _convert_leaf(mod: nn.Module, key: str, a: np.ndarray, path: str):
    """(torch parameter name within mod, tensor) for flax leaf `key`."""
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


def state_dict_from_flax(params: dict, model: nn.Module) -> dict[str, torch.Tensor]:
    """Map a flax parameter tree (nested dicts of arrays) onto `model`'s
    parameters. Returns a state_dict that `model.load_state_dict` takes."""
    out: dict[str, torch.Tensor] = {}
    want = dict(model.named_parameters())

    def walk(mod: nn.Module, tree: dict, prefix: str):
        renames = _RENAMES.get(type(mod).__name__, {})
        for key, val in tree.items():
            path = f"{prefix}{key}"
            if isinstance(val, dict):
                child = getattr(mod, renames.get(key, key), None)
                if not isinstance(child, nn.Module):
                    raise KeyError(f"flax subtree {path} has no torch module")
                walk(child, val, f"{prefix}{renames.get(key, key)}.")
                continue
            name, arr = _convert_leaf(mod, key, np.asarray(val, np.float32), path)
            full = f"{prefix}{name}"
            if full not in want:
                raise KeyError(f"flax leaf {path} -> {full}: no such torch parameter")
            if tuple(arr.shape) != tuple(want[full].shape):
                raise ValueError(f"flax leaf {path}: shape {arr.shape} does not fit "
                                 f"{full} {tuple(want[full].shape)}")
            out[full] = torch.tensor(np.ascontiguousarray(arr))

    walk(model, params, "")
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"torch parameters not filled from flax: {missing}")
    return out
