"""Metric logging: JSON lines with a TensorBoard mirror, the per-class Dice
box plot, slice montages, CSV export, and segmentation overlays as PNG.

Counterpart of `micformer_tpu/train/logging.py`. Scalars go to
`<run_dir>/events.jsonl`, one {"tag", "value", "step"} object a line, and
are mirrored, with figures and images, to `torch.utils.tensorboard` when
`MetricsWriter(run_dir, tensorboard=True)` can import it (else JSONL only,
as in JAX). Per-class validation Dice is also appended to `<run_dir>/val.txt`
and drawn as a box plot (matplotlib, where the mirror is on). The overlay
PNG (8-bit RGB) is encoded here with zlib and struct, so neither PIL nor
matplotlib is needed for it.

The trainer's writer is JSONL only (`train/trainer.py`): importing
`torch.utils.tensorboard` takes seconds and hundreds of MB of host memory
where TensorFlow is installed, which each training process would pay.

Under data parallelism only the primary rank writes scalars and val.txt;
`MetricsWriter.scalar` and `save_metrics` do nothing on the others.
"""

from __future__ import annotations

import csv
import json
import os
import struct
import zlib

import numpy as np

from micformer_tpu_torch.parallel.mesh import is_primary


class MetricsWriter:
    def __init__(self, run_dir: str, tensorboard: bool = True):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._path = os.path.join(run_dir, "events.jsonl")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(run_dir)
            except Exception:       # no tensorboard: JSONL only
                self._tb = None

    def scalar(self, tag: str, value: float, step: int):
        """Append one scalar (the file is opened for each line: a few a
        epoch, and no handle is left open), and mirror it."""
        with open(self._path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")
        if self._tb:
            self._tb.add_scalar(tag, float(value), step)

    def figure(self, tag: str, fig, step: int):
        """A matplotlib figure, to the mirror only."""
        if self._tb:
            self._tb.add_figure(tag, fig, step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        """An [H, W, C] image, to the mirror only."""
        if self._tb:
            self._tb.add_image(tag, img_hwc, step, dataformats="HWC")

    def close(self):
        if self._tb:
            self._tb.close()


def save_metrics(writer: MetricsWriter, per_class_dice, class_names, epoch: int,
                 run_dir: str, teacher: bool = False):
    """Per-class mean Dice as scalars, one line appended to val.txt, and the
    per-class box plot to the writer's mirror (matplotlib; skipped without
    either). per_class_dice: [n_patients, C]. `teacher` is the JAX
    signature's, unused there too. Only on the primary rank."""
    if not is_primary():
        return
    per_class_dice = np.asarray(per_class_dice)
    if writer._tb:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots()
            ax.boxplot(list(per_class_dice.T))
            ax.set_xticks(range(1, len(class_names) + 1), list(class_names))
            ax.set_ylabel("Dice")
            ax.set_title(f"epoch {epoch}")
            writer.figure("val/dice_per_class", fig, epoch)
            plt.close(fig)
        except Exception:       # logging never stops a run
            pass
    means = per_class_dice.mean(0) if len(per_class_dice) else np.zeros(len(class_names))
    for name, v in zip(class_names, means):
        writer.scalar(f"val/dice_{name}", float(v), epoch)
    with open(os.path.join(run_dir, "val.txt"), "a") as f:
        f.write(f"Epoch {epoch}: "
                + ", ".join(f"{n}={v:.4f}" for n, v in zip(class_names, means)) + "\n")


def slice_montage(volume: np.ndarray, n_slices: int = 8, axis: int = 0) -> np.ndarray:
    """[D, H, W] (or [C, D, H, W]: channel 0) -> a grayscale grid [H, W * n, 1]
    of `n_slices` evenly spaced slices along `axis`, scaled to [0, 1]."""
    v = np.asarray(volume)
    if v.ndim == 4:
        v = v[0]
    v = np.moveaxis(v, axis, 0)
    sl = v[np.linspace(0, v.shape[0] - 1, n_slices).astype(int)]
    lo, hi = sl.min(), sl.max()
    sl = (sl - lo) / (hi - lo + 1e-8)
    return np.concatenate(list(sl), axis=1)[..., None]


def export_csv(rows: list[dict], path: str):
    """Write `rows` (dicts with the first row's keys) as a CSV with a header
    line; nothing for no rows."""
    if not rows:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


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
