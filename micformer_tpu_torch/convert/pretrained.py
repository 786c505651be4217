"""Seed a model from another run's weights: nnU-Net's non-strict transfer.

Counterpart of `load_pretrained_params` in
`micformer_tpu/convert/torch_import.py` over the port's flat state_dicts: a
tensor is copied when the source holds its name with the same shape, and a
name any of whose dotted segments contains a head marker ("seg", "head",
"out_conv") is never transferred. The markers are the JAX rule's, applied to
names that equal flax's paths but for the renamed auto-names of
`convert/from_flax.py`, none of which holds a marker. So, as in JAX,
MicFormer's `out_conv` is held back while MedNeXt's heads (`out`, `ds1`-`ds3`)
transfer whenever their shapes match.
"""

from __future__ import annotations

HEAD_MARKERS = ("seg", "head", "out_conv")


def load_pretrained_state(state: dict, pretrained: dict):
    """(new state_dict, report) for destination `state` seeded from
    `pretrained` (both name -> tensor). The report lists "loaded" names,
    "skipped" ones with the reason ("name: head (not transferred)" or
    "name: ckpt(shape) != model(shape)") and "missing" ones (absent from
    the source). Tensors taken from the source keep the destination's dtype
    and device."""
    out = dict(state)
    report = {"loaded": [], "skipped": [], "missing": []}
    for name, dst in state.items():
        if any(m in seg for seg in name.split(".") for m in HEAD_MARKERS):
            report["skipped"].append(f"{name}: head (not transferred)")
            continue
        src = pretrained.get(name)
        if src is None:
            report["missing"].append(name)
        elif tuple(src.shape) != tuple(dst.shape):
            report["skipped"].append(f"{name}: ckpt{tuple(src.shape)} != model{tuple(dst.shape)}")
        else:
            out[name] = src.detach().to(dtype=dst.dtype, device=dst.device)
            report["loaded"].append(name)
    return out, report
