"""On-device data augmentation, the "monai" stack of the reference protocol.

Counterpart of `micformer_tpu/data/transforms.py` (`"monai"`; `"nnunet"` is
not ported yet). Train: RandFlip of image and label on each spatial axis
with p 0.5, NormalizeIntensity (nonzero, channel-wise), RandScaleIntensity
(x·(1 + U(-0.1, 0.1))), RandShiftIntensity (x + U(-0.1, 0.1)); validation:
NormalizeIntensity only. The transforms run on the batch's device. Each
random one is split into the draw (from an explicit `torch.Generator`, which
cannot give JAX's numbers) and its application to given draws, so the
application is held against JAX on the same draws.
"""

from __future__ import annotations

import torch


def normalize_intensity_nonzero(image: torch.Tensor) -> torch.Tensor:
    """Per-channel z-score over the nonzero voxels of the trailing 3 axes;
    zeros stay zero."""
    axes = (-3, -2, -1)
    mask = image != 0
    cnt = mask.sum(axes, keepdim=True).clamp_min(1)
    mean = torch.where(mask, image, 0.0).sum(axes, keepdim=True) / cnt
    var = torch.where(mask, (image - mean) ** 2, 0.0).sum(axes, keepdim=True) / cnt
    std = var.clamp_min(1e-12).sqrt()
    return torch.where(mask, (image - mean) / std, image)


def flip(image, label, axis: int, do):
    """Flip image and label along spatial `axis` (0..2 of the last three)
    where `do` is true: a bool scalar, or one per sample [B] for batches."""
    def one(x):
        do_ = torch.as_tensor(do, device=x.device)
        do_ = do_.view(do_.shape + (1,) * (x.dim() - do_.dim()))
        return torch.where(do_, x.flip(x.dim() - 3 + axis), x)

    return one(image), one(label)


def rand_flip(generator, image, label, axis: int, prob: float = 0.5):
    do = torch.rand((), generator=generator, device=generator.device) < prob
    return flip(image, label, axis, do)


def scale_intensity(image, f):
    """x · (1 + f); f a scalar or one per sample [B]."""
    f = torch.as_tensor(f, dtype=image.dtype, device=image.device)
    return image * (1.0 + f.view(f.shape + (1,) * (image.dim() - f.dim())))


def rand_scale_intensity(generator, image, factors: float = 0.1):
    f = torch.rand((), generator=generator, device=generator.device) * 2 * factors - factors
    return scale_intensity(image, f)


def shift_intensity(image, o):
    """x + o; o a scalar or one per sample [B]."""
    o = torch.as_tensor(o, dtype=image.dtype, device=image.device)
    return image + o.view(o.shape + (1,) * (image.dim() - o.dim()))


def rand_shift_intensity(generator, image, offsets: float = 0.1):
    o = torch.rand((), generator=generator, device=generator.device) * 2 * offsets - offsets
    return shift_intensity(image, o)


def _split_modalities(image, num_modalities):
    """[B, C, ...] -> (intensity channels, pass-through channels or None)."""
    if num_modalities is None or num_modalities >= image.shape[1]:
        return image, None
    return image[:, :num_modalities], image[:, num_modalities:]


def _join_modalities(mod, rest):
    return mod if rest is None else torch.cat([mod, rest], dim=1)


def draw_train_augment(generator, batch: int, device=None) -> dict:
    """The train stack's random draws for `batch` samples: flip [B, 3] bool
    (p 0.5), scale [B] and shift [B], each U(-0.1, 0.1)."""
    dev = generator.device if device is None else device

    def u(shape):
        return torch.rand(shape, generator=generator, device=generator.device).to(dev)

    return {"flip": u((batch, 3)) < 0.5, "scale": u((batch,)) * 0.2 - 0.1,
            "shift": u((batch,)) * 0.2 - 0.1}


def apply_train_augment(images, labels, draws: dict, num_modalities=None):
    """The train stack on a batch ([B, C, D, H, W], one-hot [B, K, D, H, W])
    with the given draws: flips, then on the first num_modalities channels
    the nonzero normalisation, the scale and the shift."""
    for axis in range(3):
        images, labels = flip(images, labels, axis, draws["flip"][:, axis])
    mod, rest = _split_modalities(images, num_modalities)
    mod = normalize_intensity_nonzero(mod)
    mod = scale_intensity(mod, draws["scale"])
    mod = shift_intensity(mod, draws["shift"])
    return _join_modalities(mod, rest), labels


def batched_train_augment(generator, images, labels, num_modalities=None):
    """The train stack with independent draws per sample."""
    draws = draw_train_augment(generator, images.shape[0], images.device)
    return apply_train_augment(images, labels, draws, num_modalities)


def val_normalize(image, num_modalities=None):
    """The validation transform: the nonzero channel-wise z-score of the
    first num_modalities channels of [B, C, ...]."""
    mod, rest = _split_modalities(image, num_modalities)
    return _join_modalities(normalize_intensity_nonzero(mod), rest)
