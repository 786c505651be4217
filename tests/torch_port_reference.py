"""A port model's weights written in the reference's names and layout, for
holding the port's importers (`convert/torch_import.py`,
`convert/zoo_import.py`) against the JAX package's mappers. No JAX: the
on-card check writes its reference checkpoints with it too.

It inverts an importer's rules, so a round trip through it shows nothing by
itself; the tests read what it writes with the JAX package's mappers as
well."""

from __future__ import annotations

import torch


def reference_state_dict(state: dict, rules: dict, extra: dict | None = None) -> dict:
    """Reference key -> tensor, from which `rules` (port parameter name ->
    Rule) fill `state` (a port state_dict), plus the `extra` tensors a
    reference checkpoint holds and no rule reads. Where a rule loses
    information the reference tensor is one of those that give the port's:
    a "zeros" rule reads nothing; a table re-indexed by an index tensor
    ("rows") is written as the port's table, any table of its shape being a
    valid reference one."""
    out, parts = {}, {}
    for name, rule in rules.items():
        t = state[name].detach()
        if rule.how == "copy":
            out[rule.refs[0]] = t
        elif rule.how == "flip":
            out[rule.refs[0]] = t.flip((2, 3, 4))
        elif rule.how == "swap":
            out[rule.refs[0]] = t.transpose(0, 1).contiguous()
        elif rule.how == "cat":                  # MicFormer's [q; kv]: q is a third
            q, kv = torch.tensor_split(t, [t.shape[0] // 3])
            out.update(zip(rule.refs, (q, kv)))
        elif rule.how == "rows" and isinstance(rule.arg, slice):
            parts.setdefault(rule.refs[0], []).append((rule.arg.start, t))
        elif rule.how == "rows":
            out[rule.refs[0]] = t
        elif rule.how != "zeros":
            raise ValueError(f"{name}: no inverse for {rule.how!r}")
    for key, pieces in parts.items():
        out[key] = torch.cat([t for _, t in sorted(pieces, key=lambda p: p[0])])
    out.update(extra or {})
    return out
