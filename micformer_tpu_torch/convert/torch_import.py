"""A reference PyTorch checkpoint -> the port's state_dict: MicFormer, and
the machinery the zoo's importers share (`convert/zoo_import.py`); and the
reference's own MicFormer model (`load_reference_micformer`).

Counterpart of `micformer_tpu/convert/torch_import.py`. A MicFormer trained
with the reference's own trainer is saved as `torch.save({"epoch", "state_dict", "optimizer",
"scheduler"})` (`model_best.pth.tar`); its "state_dict" holds the `Head`'s
`swin.*` and `out_conv.*` keys. `micformer_state_from_torch` maps those keys
straight onto the port's parameter names, never through the flax layout:

    ckpt = torch.load("model_best.pth.tar", map_location="cuda", weights_only=True)
    model = registry.build("micformer", device="cuda")
    state, unused = micformer_state_from_torch(ckpt["state_dict"], model)
    model.load_state_dict(state)

Both sides are torch modules, so most tensors copy as they are. A `Rule`
names the reference keys that fill one port parameter, and how:
  - copy:  as is. Linear, Conv3d, ConvTranspose3d (torch's layout on both
           sides: no flip), LayerNorm, a BatchNorm3d's weight and bias into
           an InstanceNorm, nn.PReLU's weight into PReLU.alpha, and
           relative-position tables in the standard index.
  - cat:   the reference tensors' rows concatenated. MicFormer's self blocks
           keep q [C, C] and kv [2C, C] apart; the port's one qkv Linear
           holds [q; kv] (kv's rows are [k; v]), biases likewise.
  - flip:  spatially flipped. A depthwise ConvTranspose3d [C, 1, k, k, k]
           onto DepthwiseConv3D's correlation kernel (MedNeXt's up blocks).
  - swap:  the first two axes swapped. A 1³ ConvTranspose3d [in, out, 1, 1,
           1] onto a 1³ Conv3d [out, in, 1, 1, 1] (MedNeXt's up residuals).
  - rows:  the rows `arg` (a slice or an index tensor) of one tensor.
           nn.MultiheadAttention's packed in_proj [3E, E] onto q, k and v;
           nnFormer's relative-position tables re-indexed
           (`zoo_import.nnformer_rpe_remap`).
  - zeros: no reference tensor: zeros. TransBTS's bias-free qkv onto the
           port's biased Linear.
`import_state` applies a family's rules. It raises KeyError naming a port
parameter that no rule fills or a reference key a rule needs and the
state_dict lacks, and ValueError naming a tensor whose shape does not fit.
It returns the new state_dict, on the model's device and in its dtype, and
the reference keys that no rule read, which are reported, not refused: the
dead `swin.concat_back_dim.0` (the reference's forward never uses it),
BatchNorm running statistics and `num_batches_tracked` (the port normalises
with the batch's statistics, as the JAX package does), SwinUnet3D's
shifted-window mask buffers, TransBTS's `pre_head_ln`.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types
from typing import Any, NamedTuple

import torch
import torch.nn as nn

# the reference's source tree, read by the load_reference_* functions by
# default: the JAX package's default location of it
REFERENCE = "/root/reference"

# leaf names that differ: port -> reference
_LEAVES = {"alpha": "weight", "rel_pos_bias_table": "relative_position_bias_table"}


class Rule(NamedTuple):
    """The reference keys that fill one port parameter, and how (see the
    module docstring)."""
    refs: tuple[str, ...]
    how: str = "copy"
    arg: Any = None


class Rules(dict):
    """Port parameter name -> Rule, filled module by module from `model`."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def module(self, dst: str, src: str, renames: dict | None = None):
        """Every parameter under the port module `dst` copied from the
        reference module `src`: a parameter's module path below `dst` takes
        its name in `renames` (else keeps it; "" is `dst` itself), its leaf
        the name in `_LEAVES` (else keeps it)."""
        renames = renames or {}
        for name, _ in self.model.get_submodule(dst).named_parameters():
            path, _, leaf = name.rpartition(".")
            ref = ".".join(x for x in (src, renames.get(path, path), _LEAVES.get(leaf, leaf)) if x)
            self[f"{dst}.{name}" if dst else name] = Rule((ref,))


def _rows(t: torch.Tensor, arg) -> torch.Tensor:
    return t[arg] if isinstance(arg, slice) else t[arg.to(t.device)]


_HOW = {
    "copy": lambda ts, arg: ts[0],
    "cat": lambda ts, arg: torch.cat(ts, 0),
    "flip": lambda ts, arg: ts[0].flip((2, 3, 4)),
    "swap": lambda ts, arg: ts[0].transpose(0, 1),
    "rows": lambda ts, arg: _rows(ts[0], arg),
}


def import_state(state_dict, model: nn.Module, rules: dict[str, Rule]):
    """(state_dict for `model`, sorted reference keys no rule read): every
    parameter of `model` filled from the reference `state_dict` by `rules`."""
    params = dict(model.named_parameters())
    unfilled = sorted(set(params) - set(rules))
    if unfilled:
        raise KeyError(f"no reference tensor fills the port parameters {unfilled}")
    out, used = {}, set()
    for name, p in params.items():
        rule = rules[name]
        missing = [k for k in rule.refs if k not in state_dict]
        if missing:
            raise KeyError(f"port parameter {name!r} needs the reference keys {missing}, "
                           "which the state_dict lacks")
        if rule.how == "zeros":
            t = torch.zeros_like(p)
        else:
            ts = [torch.as_tensor(state_dict[k]).detach().to(p.device) for k in rule.refs]
            t = _HOW[rule.how](ts, rule.arg)
            if tuple(t.shape) != tuple(p.shape):
                shapes = [tuple(x.shape) for x in ts]
                raise ValueError(f"reference {list(rule.refs)} {shapes} ({rule.how}) gives "
                                 f"{tuple(t.shape)}, but port parameter {name!r} is "
                                 f"{tuple(p.shape)}")
        out[name] = t.to(dtype=p.dtype).contiguous()
        used.update(rule.refs)
    return out, sorted(set(state_dict) - used)


# the self block's projections (qkv is set apart) and the cross block's
# offset net: port module path -> the reference's
_SELF = {"attn.proj": "self_attn.proj"}
_CROSS = {"offset_conv1": "conv_offset.0", "offset_norm": "conv_offset.1.norm",
          "offset_conv2": "conv_offset.3"}


def _dual_stage(rules: Rules, dst: str, src: str):
    """A port DualStreamStage from the reference BasicLayer `src`: self
    blocks (TransformerBlock3D), cross blocks (CrossTransformerBlock3D) and
    the one resample module, the reference's `downsample` in both
    directions."""
    stage = rules.model.get_submodule(dst)
    for d in range(stage.depth):
        for s in (1, 2):
            blk, ref = f"{dst}.self{s}_{d}", f"{src}.self_blocks{s}.{d}"
            rules.module(blk, ref, _SELF)
            for leaf in ("weight", "bias"):
                if f"{blk}.attn.qkv.{leaf}" in rules:
                    rules[f"{blk}.attn.qkv.{leaf}"] = Rule(
                        (f"{ref}.self_attn.q.{leaf}", f"{ref}.self_attn.kv.{leaf}"), "cat")
            rules.module(f"{dst}.cross{s}_{d}", f"{src}.blocks{s}.{d}", _CROSS)
    if stage.downsample is not None:
        rules.module(f"{dst}.downsample", f"{src}.downsample", {"conv": "down_conv"})
    if stage.upsample is not None:
        rules.module(f"{dst}.upsample", f"{src}.downsample", {"conv": "up_conv"})


def micformer_rules(model: nn.Module) -> Rules:
    """The reference Head's keys (MICFormer_self.py's `swin.*`, `out_conv.*`)
    for each parameter of the port's MicFormer: encoder stage i is
    `swin.layers.{i}`, decoder stage inx `swin.up_layers.{inx}`, skip
    projection inx `swin.concat_back_dim.{inx}` (inx >= 1)."""
    rules = Rules(model)
    rules.module("patch_embed", "swin.patch_embed")
    rules.module("norm", "swin.norm")
    rules.module("norm2", "swin.norm2")
    rules.module("reverse_patch_embed", "swin.reverse_patch_embedding")
    rules.module("out_conv", "out_conv")
    for i in range(model.n_layers):
        _dual_stage(rules, f"enc{i}", f"swin.layers.{i}")
        _dual_stage(rules, f"dec{i}", f"swin.up_layers.{i}")
        if i > 0:
            rules.module(f"concat_back{i}", f"swin.concat_back_dim.{i}")
    return rules


def micformer_state_from_torch(state_dict, model: nn.Module):
    """(state_dict, unused reference keys) for the port's MicFormer `model`
    from a reference Head's state_dict. The depths, widths and heads are
    `model`'s."""
    return import_state(state_dict, model, micformer_rules(model))


# ---------------------------------------------------------------------------
# the reference's own model code, imported read-only for comparison
# ---------------------------------------------------------------------------

def _synthetic_package(name: str, path: str):
    """Register an empty package `name` whose submodules are found under
    `path`, so they import without running the real `__init__.py` (whose
    imports need packages this environment lacks)."""
    if name in sys.modules:
        return sys.modules[name]
    pkg = types.ModuleType(name)
    pkg.__path__ = [path]
    sys.modules[name] = pkg
    return pkg


def _load_module(full_name: str, file_path: str):
    """Execute `file_path` as module `full_name` (once: an imported module is
    returned as it is); a module whose execution fails is not kept."""
    if full_name in sys.modules:
        return sys.modules[full_name]
    spec = importlib.util.spec_from_file_location(full_name, file_path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[full_name]
        raise
    return mod


def _install_timm_shim():
    """The reference imports `from timm.models.layers import DropPath`;
    timm is not installed, so `timm.models.layers` is a stand-in module with
    a DropPath of timm's semantics (identity in eval; in training each
    sample kept with probability 1 - drop_prob from the global generator,
    scaled by 1 / keep). Nothing is installed if a `timm` is imported
    already."""
    if "timm" in sys.modules:
        return

    class DropPath(nn.Module):
        def __init__(self, drop_prob: float = 0.0):
            super().__init__()
            self.drop_prob = drop_prob

        def forward(self, x):
            if self.drop_prob == 0.0 or not self.training:
                return x
            keep = 1.0 - self.drop_prob
            shape = (x.shape[0],) + (1,) * (x.ndim - 1)
            mask = torch.bernoulli(torch.full(shape, keep, device=x.device))
            return x / keep * mask

    timm = types.ModuleType("timm")
    models = types.ModuleType("timm.models")
    layers = types.ModuleType("timm.models.layers")
    layers.DropPath = DropPath
    models.layers = layers
    timm.models = models
    sys.modules["timm"] = timm
    sys.modules["timm.models"] = models
    sys.modules["timm.models.layers"] = layers


def load_reference_micformer(reference_root: str = REFERENCE, embed_dim: int = 48,
                             num_classes: int = 8, window_size=(2, 2, 2)):
    """The reference's torch `Head` (MICFormer_self.py), built from its own
    source under `reference_root` and returned in eval mode. Its modules
    `STN` and `MICFormer_self` are imported under a synthetic package, so
    MICFormer_self's relative import of STN resolves."""
    _install_timm_shim()
    models_dir = os.path.join(reference_root, "MicFormer", "models")
    pkg = "_ref_micformer_models"
    _synthetic_package(pkg, models_dir)
    for name in ("STN", "MICFormer_self"):
        _load_module(f"{pkg}.{name}", os.path.join(models_dir, name + ".py"))
    head = sys.modules[f"{pkg}.MICFormer_self"].Head
    model = head(n_channels=1, embed_dim=embed_dim, num_classes=num_classes,
                 window_size=tuple(window_size))
    return model.eval()
