"""On-device data augmentation: the "monai" stack of the reference protocol
and the "nnunet" stack of MedNeXt's native preset.

Counterpart of `micformer_tpu/data/transforms.py`. "monai", train: RandFlip
of image and label on each spatial axis with p 0.5, NormalizeIntensity
(nonzero, channel-wise), RandScaleIntensity (x·(1 + U(-0.1, 0.1))),
RandShiftIntensity (x + U(-0.1, 0.1)); validation: NormalizeIntensity only.
"nnunet" (batchgenerators' moreDA, train only): a random rotation and zoom
(p 0.2), Gaussian noise (p 0.1), Gaussian blur (p 0.2), intensity scale
(p 0.15), inverted gamma (p 0.1), gamma (p 0.3), then the three flips; the
elastic deformation is ported beside it but, as in JAX, not in the stack.
The transforms run on the batch's device. Each random one is split into the
draw (from an explicit `torch.Generator`, which cannot give JAX's numbers)
and its application to given draws, so the application is held against JAX
on the same draws. In a batch every sample has its own draws.
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


def _rows(draws: dict, rows, batch: int) -> dict:
    """The draws of rows [first, first + batch) of a global batch."""
    first = rows[0] if rows else 0
    return {k: v[first:first + batch] for k, v in draws.items()}


def batched_train_augment(generator, images, labels, num_modalities=None, rows=None):
    """The train stack with independent draws per sample. rows = (first,
    total): the batch is rows [first, first + B) of a global batch of
    `total`, whose draws are drawn, and those rows' kept (a data-parallel
    rank's share of what a single process draws)."""
    B = images.shape[0]
    draws = draw_train_augment(generator, rows[1] if rows else B, images.device)
    return apply_train_augment(images, labels, _rows(draws, rows, B), num_modalities)


def val_normalize(image, num_modalities=None):
    """The validation transform: the nonzero channel-wise z-score of the
    first num_modalities channels of [B, C, ...]."""
    mod, rest = _split_modalities(image, num_modalities)
    return _join_modalities(normalize_intensity_nonzero(mod), rest)


# -- the "nnunet" stack ----------------------------------------------------------

def _bcast(v, x):
    """A per-sample [B] tensor shaped to broadcast over x [B, ...]."""
    return v.view(v.shape + (1,) * (x.dim() - v.dim()))


def _per_sample(do, x, fn):
    """fn(x) for the samples whose flag in do [B] is set, x for the others;
    fn runs only when some sample needs it."""
    if not bool(do.any()):
        return x
    return torch.where(_bcast(do, x), fn(x), x)


def gaussian_noise(image, noise, sigma):
    """image + noise · sigma: noise a standard normal field of image's shape,
    sigma one per sample [B]."""
    return image + noise * _bcast(sigma, image)


def _gaussian_blur_1d(x, sigma, axis: int, radius: int = 3):
    """1-D Gaussian of `radius` along `axis` of x [B, ...], sigma [B] floored
    at 1e-3, with the weights normalised; the shift is circular (jnp.roll),
    not zero padded."""
    offs = torch.arange(-radius, radius + 1, dtype=x.dtype, device=x.device)
    w = torch.exp(-0.5 * (offs / sigma.clamp_min(1e-3)[:, None]) ** 2)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for i, o in enumerate(range(-radius, radius + 1)):
        out = out + _bcast(w[:, i], x) * torch.roll(x, o, dims=axis)
    return out


def gaussian_blur(image, sigma):
    """Separable Gaussian blur (radius 3) over the last three axes of
    image [B, ...], sigma [B] (GaussianBlurTransform)."""
    for ax in (-3, -2, -1):
        image = _gaussian_blur_1d(image, sigma, ax)
    return image


def gamma_transform(image, gamma, invert: bool = False):
    """batchgenerators' GammaTransform on image [B, C, D, H, W]: each sample
    min-max normalised over all its channels jointly, raised to gamma [B],
    restored to its range; `invert` flips the sign around it."""
    sign = -1.0 if invert else 1.0
    x = sign * image
    axes = tuple(range(1, x.dim()))
    mn = x.amin(axes, keepdim=True)
    rng = (x.amax(axes, keepdim=True) - mn).clamp_min(1e-7)
    return sign * (((x - mn) / rng) ** _bcast(gamma, x) * rng + mn)


def _resample(vol, coords):
    """Trilinear resampling (zeros padding) of vol [B, K, D, H, W] at voxel
    coords [B, 3, D, H, W]."""
    from micformer_tpu_torch.ops.warp import trilinear_sample

    return trilinear_sample(vol.permute(0, 2, 3, 4, 1), coords).permute(0, 4, 1, 2, 3)


def _grid(shape, device):
    """[3, D, H, W] f32 voxel coordinates (z, y, x)."""
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


def affine_transform(image, label, angles, zoom):
    """Rotation and isotropic zoom about the volume's centre ((n-1)/2 per
    axis, voxel units): each sample is resampled at rx(a) @ ry(b) @ rz(c) / s
    applied to its centred grid, image and one-hot label alike, trilinear
    with zeros padding; the label stays soft. angles [B, 3] (a, b, c), zoom
    [B] (s)."""
    B, C, D, H, W = image.shape
    one, nil = torch.ones_like(zoom), torch.zeros_like(zoom)
    (ca, cb, cc), (sa, sb, sc) = angles.cos().unbind(1), angles.sin().unbind(1)

    def mat(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], 1)   # [B, 3, 3]

    rx = mat((one, nil, nil), (nil, ca, -sa), (nil, sa, ca))
    ry = mat((cb, nil, sb), (nil, one, nil), (-sb, nil, cb))
    rz = mat((cc, -sc, nil), (sc, cc, nil), (nil, nil, one))
    m = (rx @ ry @ rz) / zoom.view(B, 1, 1)
    center = torch.tensor([(D - 1) / 2, (H - 1) / 2, (W - 1) / 2],
                          dtype=torch.float32, device=image.device)
    g = _grid((D, H, W), image.device).reshape(3, -1) - center[:, None]
    coords = (m @ g + center[:, None]).reshape(B, 3, D, H, W)
    return _resample(image, coords), _resample(label.to(image.dtype), coords)


def elastic_transform(image, label, noise, alpha, sigma):
    """batchgenerators' elastic core: the displacement field is noise
    [B, 3, D, H, W] (U(-1, 1)) blurred along each axis by a radius-4
    Gaussian of sigma / 3, times alpha; image and one-hot label are resampled
    at grid + field. alpha, sigma [B]."""
    field = noise
    for ax in (-3, -2, -1):
        field = _gaussian_blur_1d(field, sigma / 3.0, ax, radius=4)
    coords = _grid(image.shape[2:], image.device)[None] + field * _bcast(alpha, field)
    return _resample(image, coords), _resample(label.to(image.dtype), coords)


def rand_elastic(generator, image, label, alpha=(0.0, 200.0), sigma=(9.0, 13.0),
                 prob: float = 0.2):
    """The elastic deformation with per-sample draws: alpha and sigma
    uniform in their ranges, the noise field U(-1, 1), applied with p prob.
    Not part of the nnunet stack (nor is it in JAX)."""
    B, _, D, H, W = image.shape
    u = _uniform(generator, image.device)
    a, s = u((B,), *alpha), u((B,), *sigma)
    noise = u((B, 3, D, H, W), -1.0, 1.0)
    do = u((B,), 0.0, 1.0) < prob
    label = label.to(image.dtype)
    if not bool(do.any()):
        return image, label
    img, lab = elastic_transform(image, label, noise, a, s)
    return (torch.where(_bcast(do, image), img, image),
            torch.where(_bcast(do, label), lab, label))


def _uniform(generator, device):
    """u(shape, lo, hi): U(lo, hi) from the generator, moved to `device`."""
    def u(shape, lo, hi):
        r = torch.rand(shape, generator=generator, device=generator.device)
        return (r * (hi - lo) + lo).to(device)

    return u


def draw_nnunet_augment(generator, batch: int, mod_shape, device=None) -> dict:
    """The nnunet stack's draws for `batch` samples whose intensity channels
    have shape mod_shape (C_mod, D, H, W). Each transform t has its flag
    t [B] (applied or not, at its probability) and its parameters:
    affine_angles [B, 3] U(-0.26, 0.26), affine_zoom U(0.85, 1.25); noise_sigma
    U(0, 0.1) and noise_field [B, *mod_shape] standard normal; blur_sigma
    U(0.5, 1); scale_factor U(-0.25, 0.25); gamma_inv_gamma and gamma_gamma
    U(0.7, 1.5); flip [B, 3] (p 0.5)."""
    dev = generator.device if device is None else device
    u = _uniform(generator, dev)
    B = batch

    def coin(p, shape=(B,)):
        return u(shape, 0.0, 1.0) < p

    noise = torch.randn((B,) + tuple(mod_shape), generator=generator,
                        device=generator.device).to(dev)
    return {"affine": coin(0.2), "affine_angles": u((B, 3), -0.26, 0.26),
            "affine_zoom": u((B,), 0.85, 1.25),
            "noise": coin(0.1), "noise_sigma": u((B,), 0.0, 0.1), "noise_field": noise,
            "blur": coin(0.2), "blur_sigma": u((B,), 0.5, 1.0),
            "scale": coin(0.15), "scale_factor": u((B,), -0.25, 0.25),
            "gamma_inv": coin(0.1), "gamma_inv_gamma": u((B,), 0.7, 1.5),
            "gamma": coin(0.3), "gamma_gamma": u((B,), 0.7, 1.5),
            "flip": coin(0.5, (B, 3))}


def apply_nnunet_augment(images, labels, draws: dict, num_modalities=None):
    """The nnunet stack on a batch ([B, C, D, H, W], one-hot [B, K, D, H, W])
    with the given draws, in JAX's order: affine (every channel, the label
    turns float and soft), then on the first num_modalities channels noise,
    blur, scale, inverted gamma, gamma; then the three flips."""
    d = draws
    labels = labels.to(images.dtype)
    if bool(d["affine"].any()):
        img, lab = affine_transform(images, labels, d["affine_angles"], d["affine_zoom"])
        images = torch.where(_bcast(d["affine"], images), img, images)
        labels = torch.where(_bcast(d["affine"], labels), lab, labels)
    mod, rest = _split_modalities(images, num_modalities)
    mod = _per_sample(d["noise"], mod,
                      lambda x: gaussian_noise(x, d["noise_field"], d["noise_sigma"]))
    mod = _per_sample(d["blur"], mod, lambda x: gaussian_blur(x, d["blur_sigma"]))
    mod = _per_sample(d["scale"], mod, lambda x: scale_intensity(x, d["scale_factor"]))
    mod = _per_sample(d["gamma_inv"], mod,
                      lambda x: gamma_transform(x, d["gamma_inv_gamma"], invert=True))
    mod = _per_sample(d["gamma"], mod, lambda x: gamma_transform(x, d["gamma_gamma"]))
    images = _join_modalities(mod, rest)
    for axis in range(3):
        images, labels = flip(images, labels, axis, d["flip"][:, axis])
    return images, labels


def batched_nnunet_train_augment(generator, images, labels, num_modalities=None, rows=None):
    """The nnunet stack with independent draws per sample; `rows` as in
    batched_train_augment."""
    B = images.shape[0]
    mod, _ = _split_modalities(images, num_modalities)
    draws = draw_nnunet_augment(generator, rows[1] if rows else B, mod.shape[1:], images.device)
    return apply_nnunet_augment(images, labels, _rows(draws, rows, B), num_modalities)
