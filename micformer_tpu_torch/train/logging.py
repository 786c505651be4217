"""Metric logging as JSON lines, and segmentation overlays as PNG.

Counterpart of `MetricsWriter`, `save_metrics`, `overlay_slice` and
`save_overlay_png` in `micformer_tpu/train/logging.py`, JSONL only: scalars
go to `<run_dir>/events.jsonl`, one {"tag", "value", "step"} object a line,
and per-class validation Dice is also appended to `<run_dir>/val.txt`. The
overlay PNG (8-bit RGB) is encoded here with zlib and struct, so neither PIL
nor matplotlib is needed.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np


class MetricsWriter:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._path = os.path.join(run_dir, "events.jsonl")

    def scalar(self, tag: str, value: float, step: int):
        """Append one scalar (the file is opened for each line: a few a
        epoch, and no handle is left open)."""
        with open(self._path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")


def save_metrics(writer: MetricsWriter, per_class_dice, class_names, epoch: int,
                 run_dir: str):
    """Per-class mean Dice as scalars, and one line appended to val.txt.
    per_class_dice: [n_patients, C]."""
    per_class_dice = np.asarray(per_class_dice)
    means = per_class_dice.mean(0) if len(per_class_dice) else np.zeros(len(class_names))
    for name, v in zip(class_names, means):
        writer.scalar(f"val/dice_{name}", float(v), epoch)
    with open(os.path.join(run_dir, "val.txt"), "a") as f:
        f.write(f"Epoch {epoch}: "
                + ", ".join(f"{n}={v:.4f}" for n, v in zip(class_names, means)) + "\n")


# nnU-Net's overlay colour cycle: label 0 (background) black, then distinct
# hues for up to 14 foreground classes
_OVERLAY_COLORS = (
    "000000", "4363d8", "f58231", "3cb44b", "e6194B", "911eb4", "ffe119",
    "bfef45", "42d4f4", "f032e6", "000075", "9A6324", "808000", "800000",
    "469990",
)


def overlay_slice(image_2d: np.ndarray, seg_2d: np.ndarray,
                  intensity: float = 0.6) -> np.ndarray:
    """Colour segmentation overlay on one grayscale slice -> uint8 [H, W, 3]:
    the image rescaled to [0, 255], each label's colour added at
    `intensity`, the sum rescaled to [0, 255] again."""
    img = np.asarray(image_2d, np.float32)
    img = img - img.min()
    img = img / (img.max() + 1e-8) * 255.0
    rgb = np.tile(img[:, :, None], (1, 1, 3))
    for lab in np.unique(seg_2d):
        hexcol = _OVERLAY_COLORS[int(lab) % len(_OVERLAY_COLORS)]
        col = np.array([int(hexcol[i:i + 2], 16) for i in (0, 2, 4)], np.float32)
        rgb[seg_2d == lab] += intensity * col
    rgb = rgb / (rgb.max() + 1e-8) * 255.0
    return rgb.astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png_rgb(path: str, rgb: np.ndarray) -> None:
    """Write a uint8 [H, W, 3] array as an 8-bit RGB PNG: one IDAT of
    unfiltered rows (filter byte 0)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def save_overlay_png(image: np.ndarray, seg: np.ndarray, path: str,
                     intensity: float = 0.6) -> int:
    """Overlay the axial slice with the most foreground voxels and write it
    as a PNG. `image` [D, H, W] or [C, D, H, W] (channel 0 is drawn), `seg`
    [D, H, W] labels. Returns the slice index."""
    img = np.asarray(image)
    if img.ndim == 4:
        img = img[0]
    seg = np.asarray(seg)
    k = int(np.argmax((seg != 0).sum(axis=(1, 2))))
    write_png_rgb(path, overlay_slice(img[k], seg[k], intensity))
    return k
