"""VT-UNet from a 2D Swin-Transformer checkpoint: load, mirror and inflate.

Counterpart of `micformer_tpu/convert/torch_import.py`'s VT-UNet inflation
(`inflate_patch_embed_2d_to_3d`, `inflate_rel_pos_table_2d_to_3d`,
`vtunet_params_from_swin2d`), on the port's VT-UNet `state_dict` names. The
reference's `load_from` (VT-Unet/vtunet/vision_transformer.py:52-86) copies
the official 2D Swin keys (patch_embed.proj, layers.{i}.blocks.{b}.{norm1,
attn.qkv, attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1,
mlp.fc2}, norm), mirrors the encoder into the decoder (layers.X ->
layers_up.(3-X): here enc{i}_b{b} -> dec{n-1-i}_b{b}) and drops what does
not fit. Beyond it, as in the JAX package, the genuinely 2D tensors are
inflated: the patch-embed conv by replication over depth divided by kd, the
relative-position tables by replication over the depth-delta axis.
"""

from __future__ import annotations

import numpy as np
import torch


def inflate_patch_embed_2d_to_3d(w2d, kd: int, in_channels: int) -> np.ndarray:
    """2D Swin patch-embed conv [E, C2d, kh, kw] -> the port's Conv3d weight
    [E, in_channels, kd, kh, kw].

    The pretrained input channels (RGB) are averaged into one filter,
    repeated per target modality, then replicated over kd and divided by kd,
    so a depth-constant input reproduces the 2D response (I3D's 'mean'
    inflation)."""
    w2d = np.asarray(w2d)
    gray = w2d.mean(axis=1, keepdims=True)                    # [E, 1, kh, kw]
    w = np.repeat(gray, in_channels, axis=1)                  # [E, in, kh, kw]
    return np.repeat(w[:, :, None], kd, axis=2) / float(kd)   # [E, in, kd, kh, kw]


def inflate_rel_pos_table_2d_to_3d(table2d, window_size) -> np.ndarray | None:
    """2D relative-position bias table [(2wh-1)(2ww-1), h] -> 3D
    [(2wd-1)(2wh-1)(2ww-1), h], replicated over the depth-delta axis (the
    Video-Swin rule for additive biases). None when the 2D table does not
    factor as (2wh-1)(2ww-1) of the target window."""
    t = np.asarray(table2d)
    wd, wh, ww = window_size
    nh, nw = 2 * wh - 1, 2 * ww - 1
    if t.shape[0] != nh * nw:
        return None
    t = t.reshape(nh, nw, -1)
    t3 = np.broadcast_to(t[None], (2 * wd - 1, nh, nw, t.shape[-1]))
    return np.ascontiguousarray(t3.reshape((2 * wd - 1) * nh * nw, -1))


def _set_if_match(params: dict, name: str, value, report: dict) -> None:
    """Overwrite params[name] when the shapes agree (the reference's
    load_from drops shape-mismatched keys, vision_transformer.py:75-80)."""
    if name not in params:
        report["missing"].append(name)
        return
    value = np.asarray(value)
    if tuple(params[name].shape) != tuple(value.shape):
        report["skipped"].append(f"{name}: ckpt{tuple(value.shape)} != "
                                 f"model{tuple(params[name].shape)}")
        return
    params[name] = torch.as_tensor(value.copy(), dtype=params[name].dtype)
    report["loaded"].append(name)


def vtunet_params_from_swin2d(state_dict, params, *, depths=(2, 2, 2, 1),
                              window_size=(7, 7, 7), patch_size=(4, 4, 4),
                              in_channels: int = 2):
    """Inflate a 2D Swin-Transformer checkpoint into the port's VT-UNet.

    state_dict: the 2D checkpoint's tensors or arrays (ckpt['model']
    unwrapped); params: a VT-UNet `state_dict()` (not changed). Returns
    (state_dict, report): a new state_dict for `load_state_dict`, and
    {"loaded", "skipped", "missing"}: the names filled (decoder mirrors
    included), the shape-mismatched ones dropped with their shapes, and the
    ones the model does not have."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
          for k, v in state_dict.items()}
    params = {k: v.detach().clone() for k, v in params.items()}
    report = {"loaded": [], "skipped": [], "missing": []}
    n = len(depths)

    if "patch_embed.proj.weight" in sd:
        _set_if_match(params, "patch_embed.proj.weight",
                      inflate_patch_embed_2d_to_3d(sd["patch_embed.proj.weight"],
                                                   patch_size[0], in_channels), report)
        for key in ("patch_embed.proj.bias", "patch_embed.norm.weight",
                    "patch_embed.norm.bias"):
            if key in sd:
                _set_if_match(params, key, sd[key], report)
    if "norm.weight" in sd:
        _set_if_match(params, "norm.weight", sd["norm.weight"], report)
        _set_if_match(params, "norm.bias", sd["norm.bias"], report)

    def load_block(src, dst):
        if src + ".norm1.weight" not in sd:
            return
        # the 2D Swin block's names are the port's, bar the bias table
        for leaf in ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                     "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
                     "attn.proj.bias"):
            if leaf == "attn.qkv.bias" and f"{src}.{leaf}" not in sd:
                continue
            _set_if_match(params, f"{dst}.{leaf}", sd[f"{src}.{leaf}"], report)
        tkey = src + ".attn.relative_position_bias_table"
        if tkey in sd:
            t3 = inflate_rel_pos_table_2d_to_3d(sd[tkey], window_size)
            if t3 is None:
                report["skipped"].append(f"{dst}.attn.rel_pos_bias_table: 2D table "
                                         f"{sd[tkey].shape} does not factor for window "
                                         f"{window_size}")
            else:
                _set_if_match(params, f"{dst}.attn.rel_pos_bias_table", t3, report)
        for leaf in ("mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"):
            _set_if_match(params, f"{dst}.{leaf}", sd[f"{src}.{leaf}"], report)

    for i in range(n):
        for b in range(depths[i]):
            src = f"layers.{i}.blocks.{b}"
            load_block(src, f"enc{i}_b{b}")
            # the encoder mirrored into the decoder (layers.X -> layers_up.(3-X))
            inx = n - 1 - i
            if inx >= 1:
                load_block(src, f"dec{inx}_b{b}")
    return params, report
