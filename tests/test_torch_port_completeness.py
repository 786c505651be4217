"""The port's public surface against the JAX package's, read with `ast`
(neither package is imported; nothing is built).

From every `micformer_tpu/**/*.py` it collects each public top-level `def`
and `class`, each public method of those classes, each public name a package
`__init__.py` imports or assigns, and each `add_argument` flag of
`micformer_tpu/cli/*.py`. Each must have a counterpart in
`micformer_tpu_torch/`:
  - the same name in the same relative module (a flag: the same flag in the
    same CLI); a port `__init__.py` counts the names it imports, defines,
    assigns or lists in `__all__` (those it loads on first use);
  - or an entry of RENAMED: the port's module and name, which must exist;
  - or an entry of NOT_PORTED, whose reason names where the counterpart or
    the rule lives. It holds TPU layout forms, Pallas-kernel plumbing and
    JAX sharding or pytree plumbing only, never a feature.
A table entry that names nothing in the JAX package fails too. One case a
JAX module.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "micformer_tpu", REPO / "micformer_tpu_torch"

# (JAX module, name) -> (port module, name): the same feature under the
# port's name or in the port's module
RENAMED = {
    # the reference-checkpoint mappers write the port's state_dict, not a flax tree
    ("convert/__init__.py", "micformer_params_from_torch"):
        ("convert/__init__.py", "micformer_state_from_torch"),
    ("convert/__init__.py", "load_pretrained_params"):
        ("convert/__init__.py", "load_pretrained_state"),
    ("convert/torch_import.py", "micformer_params_from_torch"):
        ("convert/torch_import.py", "micformer_state_from_torch"),
    ("convert/torch_import.py", "load_pretrained_params"):
        ("convert/pretrained.py", "load_pretrained_state"),
    ("convert/torch_import.py", "vtunet_params_from_swin2d"):
        ("convert/swin2d.py", "vtunet_params_from_swin2d"),
    ("convert/torch_import.py", "inflate_patch_embed_2d_to_3d"):
        ("convert/swin2d.py", "inflate_patch_embed_2d_to_3d"),
    ("convert/torch_import.py", "inflate_rel_pos_table_2d_to_3d"):
        ("convert/swin2d.py", "inflate_rel_pos_table_2d_to_3d"),
    **{("convert/zoo_import.py", f"{family}_params_from_torch"):
       ("convert/zoo_import.py", f"{family}_state_from_torch")
       for family in ("mednext", "transbts", "nnformer", "swinunet3d", "transunet", "vtunet",
                      "vtunet_block")},
    # per-sample draws become batched draw-then-apply pairs (one draw for the batch)
    ("data/transforms.py", "train_augment"): ("data/transforms.py", "batched_train_augment"),
    ("data/transforms.py", "nnunet_train_augment"):
        ("data/transforms.py", "batched_nnunet_train_augment"),
    ("data/transforms.py", "rand_affine"): ("data/transforms.py", "affine_transform"),
    ("data/transforms.py", "rand_gamma"): ("data/transforms.py", "gamma_transform"),
    ("data/transforms.py", "rand_gaussian_blur"): ("data/transforms.py", "gaussian_blur"),
    ("data/transforms.py", "rand_gaussian_noise"): ("data/transforms.py", "gaussian_noise"),
    # the Pallas kernels' entry points: the wrappers of the hand-written kernels
    ("ops/pallas/window_attention_v2.py", "window_attention_v2"):
        ("kernels/window_attention.py", "window_attention"),
    ("ops/pallas/window_attention.py", "fused_window_attention"):
        ("kernels/fused_window_attention.py", "fused_window_attention"),
    ("ops/pallas/dw_stencil.py", "dw_conv3_pallas"): ("kernels/dw_conv3.py", "dw_conv3"),
    # torch.distributed forms of the mesh's placements
    ("parallel/__init__.py", "shard_params_tensor_parallel"):
        ("parallel/__init__.py", "shard_tensor_parallel"),
    ("parallel/__init__.py", "tensor_parallel_shardings"):
        ("parallel/__init__.py", "tensor_parallel_plan"),
    ("parallel/__init__.py", "shard_batch"): ("parallel/__init__.py", "rank_rows"),
    ("parallel/__init__.py", "zero1_shardings"): ("parallel/__init__.py", "zero1"),
    ("parallel/mesh.py", "shard_batch"): ("parallel/mesh.py", "rank_rows"),
    ("parallel/mesh.py", "zero1_shardings"): ("parallel/mesh.py", "zero1"),
    ("parallel/tensor.py", "shard_params_tensor_parallel"):
        ("parallel/tensor.py", "shard_tensor_parallel"),
    ("parallel/tensor.py", "tensor_parallel_shardings"):
        ("parallel/tensor.py", "tensor_parallel_plan"),
    ("train/checkpoint.py", "CheckpointManager.restore_any"):
        ("train/checkpoint.py", "CheckpointManager.restore"),
}

_LAYOUT = "TPU layout form, off by default (ROADMAP conventions): "
_WPACK = _LAYOUT + "W-packing; the port writes the plain math"
_SHARDING = "JAX sharding plumbing: "
_PYTREE = "JAX pytree plumbing: "

# (JAX module, name) -> where its counterpart or its rule lives
NOT_PORTED = {
    **{("convert/__init__.py", n): _PYTREE + "torch -> flax kernel layout; the port keeps "
       "torch's layout (convert/torch_import.py rules copy), convert/from_flax.py inverts it"
       for n in ("linear_kernel", "conv3d_kernel", "conv_transpose3d_kernel")},
    **{("convert/torch_import.py", n): _PYTREE + "torch -> flax kernel layout; the port keeps "
       "torch's layout (convert/torch_import.py rules copy), convert/from_flax.py inverts it"
       for n in ("linear_kernel", "conv3d_kernel", "conv_transpose3d_kernel")},
    ("convert/torch_import.py", "conv3x3_via_dot_kernel"):
        _LAYOUT + "Conv3x3ViaDot's kernel; the port's convs are nn.Conv3d",
    ("models/layers.py", "Conv3x3ViaDot"): _LAYOUT + "MICFORMER_*_VIA_DOT; nn.Conv3d",
    ("models/layers.py", "ConvTranspose2x2ViaDot"): _LAYOUT + "MICFORMER_*_VIA_DOT; "
                                                              "nn.ConvTranspose3d",
    ("models/layers.py", "conv3_dots"): _LAYOUT + "the via-dot 3³ conv; nn.Conv3d",
    ("models/layers.py", "apply_layer_norm"): _LAYOUT + "the LN variants "
                                                        "(MICFORMER_LN_*); nn.LayerNorm",
    ("models/layers.py", "to_channels_first"): _LAYOUT + "the flax channels-last boundary; "
                                                         "the port's MedNeXt is channels-first "
                                                         "(models/layers.py)",
    ("models/layers.py", "to_channels_last"): _LAYOUT + "the flax channels-last boundary; "
                                                        "the window blocks permute at their "
                                                        "convs (models/layers.py conv_cl)",
    ("models/layers.py", "dw_conv_stencil"): _LAYOUT + "shift-and-add depthwise conv; "
                                                       "DepthwiseConv3D runs K3 "
                                                       "(csrc/dw_conv3.cu)",
    ("models/layers.py", "dw_transpose2_stencil"): _LAYOUT + "parity-class transposed conv; "
                                                             "F.conv_transpose3d",
    ("models/layers.py", "dw_transpose2_blocked"): _LAYOUT + "parity-class transposed conv; "
                                                             "F.conv_transpose3d",
    ("models/layers.py", "parity_block"): _LAYOUT + "parity-class layout; F.conv_transpose3d",
    ("models/layers.py", "parity_interleave"): _LAYOUT + "parity-class layout; "
                                                         "F.conv_transpose3d",
    ("models/mednext.py", "MedNeXtBlockW"): _WPACK + " (models/mednext.py MedNeXtBlock)",
    ("models/swinunetr.py", "ResConvBlockW"): _WPACK + " (models/swinunetr.py)",
    ("models/swinunetr.py", "UpBlockW"): _WPACK + " (models/swinunetr.py)",
    ("models/transunet.py", "DoubleConvW"): _WPACK + " (models/transunet.py)",
    ("ops/attention.py", "lane_major_attention_core"): _LAYOUT + "lane-major attention; "
                                                               "K1 (csrc/window_attention.cu)",
    **{("ops/wpack.py", n): _WPACK for n in (
        "band_matrix", "blockdiag_matrix", "conv3_wpack", "convtranspose2_wpack",
        "dw_conv_wpack", "dw_conv_wpack_banded", "dw_densify", "instance_norm_wpack",
        "maxpool2_wpack", "pack", "parity_interleave_packed", "pointwise_slots",
        "pointwise_wpack", "repack", "slot_shift", "slots", "unpack")},
    ("ops/pallas/window_attention_v2.py", "should_use_v2"):
        "Pallas kernel dispatch: K1 (csrc/window_attention.cu) is the default of its regime, "
        "chosen in ops/attention.py multi_head_attention",
    ("ops/pallas/window_attention.py", "should_use_fused"):
        "Pallas kernel dispatch: K2 (csrc/window_attention.cu) is chosen by "
        "--fused-attention, in ops/attention.py multi_head_attention",
    ("parallel/__init__.py", "replicate"): _SHARDING + "DDP replicates (parallel/mesh.py, "
                                                      "train/trainer.py)",
    ("parallel/__init__.py", "data_parallel_shardings"): _SHARDING + "DDP on torch.distributed "
                                                                     "(parallel/mesh.py)",
    ("parallel/mesh.py", "replicate"): _SHARDING + "DDP replicates (parallel/mesh.py, "
                                                   "train/trainer.py)",
    ("parallel/mesh.py", "data_parallel_shardings"): _SHARDING + "DDP on torch.distributed "
                                                                 "(parallel/mesh.py)",
    ("parallel/mesh.py", "spatial_sharding"): _SHARDING + "D slabs with halo exchange "
                                                          "(parallel/spatial.py)",
    ("train/trainer.py", "TrainState"): _PYTREE + "the torch Trainer holds its model and "
                                                  "optimizer (train/trainer.py)",
    ("train/trainer.py", "TrainState.apply_gradients"): _PYTREE + "optimizer.step "
                                                                  "(train/trainer.py)",
    ("train/trainer.py", "Trainer.init_state"): _PYTREE + "Trainer.__init__ builds the "
                                                          "optimizer (train/trainer.py)",
}
# a NOT_PORTED reason names one of these kinds
KINDS = (_LAYOUT, "Pallas kernel dispatch: ", _SHARDING, _PYTREE)


def _public(name: str) -> bool:
    return not name.startswith("_")


def jax_surface(path: pathlib.Path) -> set[str]:
    """Public defs and classes, public methods of those classes ("Class.m"),
    and, in an __init__.py, the public names it imports or assigns."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not _public(node.name):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                          and _public(m.name)}
        elif path.name == "__init__.py":
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names |= {(a.asname or a.name).split(".")[0] for a in node.names}
            elif isinstance(node, ast.Assign):
                names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if _public(n) and not n.startswith("__")}


def port_surface(path: pathlib.Path) -> set[str]:
    """What a module offers by name: defs, classes and their methods,
    assigned and imported names, and `__all__` entries."""
    if not path.exists():
        return set()
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__" and node.value is not None:
                        names |= {e.value for e in getattr(node.value, "elts", ())
                                  if isinstance(e, ast.Constant)}
    return names


def cli_flags(path: pathlib.Path) -> set[str]:
    """The option strings of every add_argument call in a module."""
    flags = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            flags |= {a.value for a in node.args
                      if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return flags


JAX_MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def _missing(rel: str) -> list[str]:
    port = port_surface(PORT / rel)
    missing = []
    for name in sorted(jax_surface(JAX / rel)):
        key = (rel, name)
        if name in port or key in NOT_PORTED:
            continue
        if key in RENAMED:
            where, new = RENAMED[key]
            if new not in port_surface(PORT / where):
                missing.append(f"{name} -> {where}::{new}, which is not there")
            continue
        missing.append(name)
    if rel.startswith("cli/"):
        port_flags = cli_flags(PORT / rel) if (PORT / rel).exists() else set()
        missing += [f"flag {f}" for f in sorted(cli_flags(JAX / rel) - port_flags)]
    return missing


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    assert _missing(rel) == []


def test_tables_name_jax_features_and_not_ported_names_its_rule():
    """Every table entry names something of the JAX package; no name is in
    both tables; every NOT_PORTED reason is one of the allowed kinds and
    names a file of the port or of its kernels."""
    for rel, name in list(RENAMED) + list(NOT_PORTED):
        assert name in jax_surface(JAX / rel), (rel, name)
    assert not set(RENAMED) & set(NOT_PORTED)
    for key, why in NOT_PORTED.items():
        assert why.startswith(KINDS), (key, why)
        assert ".py" in why or ".cu" in why or "ROADMAP" in why, (key, why)
