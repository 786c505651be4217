"""Synthetic paired CT/MR cases made on the device from a seed, in the style
of the program's `data/synthetic.make_case`: a label map of ellipsoid
structures (classes 1..K-1 over background 0), CT and MR intensity fields
correlated with it, Gaussian noise and a zero margin. Each modality is then
min-max scaled to [0, 1] over its whole volume, as the program's
preprocessing (`--normalisation minmax`, the default of `cli/serve` and of
the training loader) leaves a volume. Every case of a pool has the same
size, so every seed gives the same work."""

from __future__ import annotations

import torch


def make_cases(generator: torch.Generator, n: int, side: int, num_classes: int = 8):
    """(images [n, 2, side³] f32 in [0, 1], labels [n, side³] uint8) on
    the generator's device; a constant modality gives zeros."""
    dev = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    ax = torch.linspace(-1.0, 1.0, side, device=dev)
    zz, yy, xx = (a[None] for a in torch.meshgrid(ax, ax, ax, indexing="ij"))
    label = torch.zeros((n, side, side, side), dtype=torch.uint8, device=dev)
    intensity = torch.zeros((n, side, side, side), device=dev)
    centres = u(n, num_classes - 1, 3) * 0.9 - 0.45
    radii = u(n, num_classes - 1, 3) * 0.18 + 0.12
    for k in range(1, num_classes):
        c = centres[:, k - 1].view(n, 3, 1, 1, 1)
        r = radii[:, k - 1].view(n, 3, 1, 1, 1)
        d = (((zz - c[:, 0]) / r[:, 0]) ** 2 + ((yy - c[:, 1]) / r[:, 1]) ** 2
             + ((xx - c[:, 2]) / r[:, 2]) ** 2)
        label[d < 1.0] = k
        intensity += torch.exp(-2.0 * d) * (k / num_classes)
    base = torch.exp(-(zz ** 2 + yy ** 2 + xx ** 2))
    noise = torch.randn((2, n, side, side, side), generator=generator, device=dev)
    ct = 400.0 * (base + intensity) + 20.0 * noise[0]
    mr = 300.0 * (base + 0.7 * intensity ** 1.3) + 15.0 * noise[1]
    images = torch.stack([ct, mr], dim=1)
    m = max(2, side // 16)
    inside = torch.zeros((side,) * 3, dtype=torch.bool, device=dev)
    inside[m:-m, m:-m, m:-m] = True
    images = images * inside
    lo = images.amin(dim=(2, 3, 4), keepdim=True)
    scale = images.amax(dim=(2, 3, 4), keepdim=True) - lo
    images = torch.where(scale > 0, (images - lo) / scale.clamp_min(1e-30), 0.0)
    return images, label
