"""Serving artifacts: the whole inference pipeline as one `torch.export`
program.

Counterpart of `micformer_tpu/convert/aot_export.py`. The sliding-window
pipeline (tiling, the model, gaussian blending, optional mirror TTA, argmax)
is exported with `torch.export` as one graph, the trained weights and the
blending map held in it as constants; the tile loop is unrolled for the
artifact's one input shape. The kernels K1, K2, K3 and the biased window
attention are custom ops of the `micformer_tpu_torch` namespace (`kernels/`),
so each launch is a node of the graph whose real implementation launches the
kernel when the artifact runs.
Serving an artifact needs torch, `micformer_tpu_torch.kernels` (imported by
`load_artifact`, which registers the ops) and the artifact directory, not the
model zoo, the checkpoint tree or the config system.

An artifact holds one program for each of its platforms (`cuda`, `cpu`; the
JAX package's `platforms`): a `torch.export` graph is traced on one device,
and a custom op's CUDA path launches the kernel where its CPU path runs the
plain version. The load picks the program of the device it is asked for.

Layout of an artifact directory:
    module.<platform>.pt2   torch.export.save of each platform's program
    meta.json               protocol metadata (shapes, roi, blending, model
                            name, platforms and their programs)
Version 1 artifacts hold one program, `module.pt2`, for `platforms[0]`.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import typing

import torch
import torch.nn as nn

from micformer_tpu_torch.infer.sliding_window import sliding_window_inference
from micformer_tpu_torch.tracing import span

VERSION = 2
# the devices an artifact can hold a program for
PLATFORMS = ("cuda", "cpu")
# the forward wrappers whose calls become op nodes (`kernels.CALLS`)
OPS = ("window_attention", "fused_window_attention", "biased_window_attention", "dw_conv3")


class InferenceModule(nn.Module):
    """The serving program: volume [B, 2, D, H, W] f32 -> seg [B, D, H, W]
    uint8 (argmax) or logits [B, C, D, H, W] f32, the composition of
    cli/serve.py. A call is the span `serve.infer`, its argmax
    `serve.argmax` (`tracing.span`)."""

    def __init__(self, model, *, roi, num_classes=8, overlap=0.5, sw_batch_size=4,
                 step_mode="monai", mirror_tta=False, argmax=True):
        super().__init__()
        self.model = model
        self.roi = tuple(roi)
        self.num_classes = num_classes
        self.overlap = overlap
        self.sw_batch_size = sw_batch_size
        self.step_mode = step_mode
        self.mirror_tta = mirror_tta
        self.argmax = argmax

    def predictor(self, win):
        out = self.model(win)
        return out[0] if isinstance(out, (list, tuple)) else out

    def forward(self, volume):
        # sliding_window_inference is decorated with no_grad; with grad off
        # already (an export runs under no_grad) its body is called as it
        # is, since the decorator's grad switches would be traced as graph
        # nodes that export then splits the graph at and inlines again
        swi = sliding_window_inference if torch.is_grad_enabled() \
            else sliding_window_inference.__wrapped__
        with span("serve.infer"):
            logits = swi(
                volume, self.roi, self.predictor, num_classes=self.num_classes,
                overlap=self.overlap, sw_batch_size=self.sw_batch_size,
                step_mode=self.step_mode, mirror_tta=self.mirror_tta)
            if not self.argmax:
                return logits
            with span("serve.argmax"):
                return logits.argmax(dim=1).to(torch.uint8)


def build_inference_fn(model, *, roi, num_classes=8, overlap=0.5, sw_batch_size=4,
                       step_mode="monai", mirror_tta=False, argmax=True):
    """The serving program as an `nn.Module` (`InferenceModule`)."""
    return InferenceModule(model, roi=roi, num_classes=num_classes, overlap=overlap,
                           sw_batch_size=sw_batch_size, step_mode=step_mode,
                           mirror_tta=mirror_tta, argmax=argmax)


def op_nodes(program) -> dict[str, int]:
    """Nodes of each of the port's ops (OPS) in an exported program's graph
    (or its module), and its aten softmax nodes as "softmax": K1's and K2's
    plain version is an einsum-softmax-einsum chain, so a MicFormer graph
    whose attention is all op nodes holds none."""
    counts = dict.fromkeys(OPS + ("softmax",), 0)
    for node in program.graph.nodes:
        if node.op != "call_function" or not isinstance(node.target, torch._ops.OpOverload):
            continue
        ns, name = node.target.name().split("::")
        if ns == "micformer_tpu_torch":
            counts[name] = counts.get(name, 0) + 1
        elif ns == "aten" and "softmax" in name:
            counts["softmax"] += 1
    return counts


def check_platforms(platforms) -> list[str]:
    """`platforms` as a list of PLATFORMS, each one this host can run;
    raises ValueError for another name and RuntimeError for cuda without a
    card (nothing falls back to the CPU)."""
    from micformer_tpu_torch.registry import resolve_device

    platforms = list(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms {platforms}: each one of {list(PLATFORMS)}, once")
    for p in platforms:
        resolve_device(p)
    return platforms


def _export_program(module, example):
    """torch.export of `module` on `example` under no_grad; raises if a
    forward wrapper was traced into anything but its op node."""
    from micformer_tpu_torch.kernels import CALLS

    before = dict(CALLS)
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    calls = {name: CALLS[name] - before[name] for name in OPS}
    nodes = op_nodes(program)
    missing = {name: (calls[name], nodes[name]) for name in OPS if nodes[name] < calls[name]}
    if missing:
        raise RuntimeError("export_artifact: kernels traced as plain math, not as op nodes "
                           f"(wrapper calls, op nodes): {missing}")
    program.example_inputs = None          # not the artifact's: a volume of zeros
    return program


def export_artifact(out_dir: str, model, *, target_shape, roi, num_classes=8,
                    overlap=0.5, sw_batch_size=4, step_mode="monai", mirror_tta=False,
                    argmax=True, batch=1, platforms=None, model_name=None):
    """Export the inference pipeline for `target_shape` volumes to `out_dir`,
    one program for each of `platforms` (default: the model's device).
    Weights are held in each program as constants. Raises before anything
    is written if a platform cannot run here, and if a forward wrapper was
    traced into anything but its op node (K1, K2, K3 or the biased window
    attention inlined as plain math). Returns the meta dict."""
    here = next(model.parameters()).device.type
    platforms = check_platforms([here] if platforms is None else platforms)
    programs = {}
    for p in platforms:
        m = model if p == here else copy.deepcopy(model).to(p)
        module = build_inference_fn(m.eval(), roi=roi, num_classes=num_classes,
                                    overlap=overlap, sw_batch_size=sw_batch_size,
                                    step_mode=step_mode, mirror_tta=mirror_tta, argmax=argmax)
        example = torch.zeros((batch, 2) + tuple(target_shape), dtype=torch.float32, device=p)
        programs[p] = _export_program(module, example)

    os.makedirs(out_dir, exist_ok=True)
    files = {p: f"module.{p}.pt2" for p in platforms}
    for p, program in programs.items():
        torch.export.save(program, os.path.join(out_dir, files[p]))
    meta = {
        "version": VERSION,
        "model": model_name or type(model).__name__,
        "input_shape": [batch, 2] + list(target_shape),
        "output": "argmax_uint8" if argmax else "logits_f32",
        "num_classes": num_classes,
        "roi": list(roi),
        "overlap": overlap,
        "sw_batch_size": sw_batch_size,
        "step_mode": step_mode,
        "mirror_tta": mirror_tta,
        "platforms": platforms,
        "programs": files,
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def read_meta(artifact_dir: str) -> dict:
    """An artifact's meta dict, with "programs" ({platform: file}) filled in
    for a version 1 artifact; raises for a version newer than this code's."""
    with open(os.path.join(artifact_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version", 0) > VERSION:
        raise ValueError(
            f"artifact version {meta['version']} is newer than this "
            f"framework's supported version {VERSION}")
    meta.setdefault("programs", {meta["platforms"][0]: "module.pt2"})
    return meta


@contextlib.contextmanager
def _type_hints_once():
    """`typing.get_type_hints` computed once per class while the block runs.
    `torch.export.load` turns the program's JSON into its schema's
    dataclasses and asks the hints of the same few classes again for every
    object it builds; the hints of a class do not change during a load."""
    get = typing.get_type_hints
    cache = {}

    def hints(obj, *args, **kwargs):
        key = (obj, tuple(map(id, args)), tuple((k, id(v)) for k, v in sorted(kwargs.items())))
        try:
            hash(key)
        except TypeError:       # an unhashable object: not cached
            return get(obj, *args, **kwargs)
        if key not in cache:
            cache[key] = get(obj, *args, **kwargs)
        return cache[key]

    typing.get_type_hints = hints
    try:
        yield
    finally:
        typing.get_type_hints = get


def load_artifact(artifact_dir: str, device=None):
    """-> (callable volume -> output, meta dict): the program of `device`
    (default: the artifact's one platform, or of several the card's, which
    raises where there is none), its weights on that device. Raises
    ValueError for a device the artifact holds no program for. Imports
    `micformer_tpu_torch.kernels`, which registers the ops the program
    calls."""
    import micformer_tpu_torch.kernels  # noqa: F401  (registers the ops)
    from micformer_tpu_torch.registry import resolve_device

    meta = read_meta(artifact_dir)
    platforms = meta["platforms"]
    if device is not None:
        platform = torch.device(device).type
    elif len(platforms) == 1:
        platform = platforms[0]
    else:
        platform = resolve_device("cuda").type
    if platform not in meta["programs"]:
        raise ValueError(f"the artifact runs on {platforms}, not on {platform}")
    with _type_hints_once():
        program = torch.export.load(os.path.join(artifact_dir, meta["programs"][platform]))
    return program.module(), meta
