"""Model registry: each model family registers a factory under a name, and
callers build models with `build(name, **kwargs)`.

Counterpart of `micformer_tpu/registry.py`. `build` also places the model:
weights are drawn on the CPU from an explicit generator (the JAX package's
initialiser scheme: truncated LeCun-normal kernels, zero biases, unit norm
scales), so a seed gives the same weights on every device, then the model is
cast to `dtype` and moved to `device` in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn

_REGISTRY: dict = {}
# std of a standard normal truncated to [-2, 2]; dividing by it gives the
# truncated draw unit variance, as flax's variance_scaling does
_TRUNC_STD = 0.87962566103423978


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent,
    so a run never goes on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def register(name: str, **defaults):
    """Decorator: register a model factory under `name` with default kwargs."""

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"model '{name}' already registered")
        _REGISTRY[name] = (fn, dict(defaults))
        return fn

    return deco


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter: kernels from a truncated normal of variance
    1/fan_in, biases zero, norm weights one."""
    from micformer_tpu_torch.models.layers import InstanceNorm

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                            nn.ConvTranspose3d)):
            w = mod.weight
            k = w[0, 0].numel()
            fan_in = (w.shape[0] if isinstance(mod, (nn.ConvTranspose2d, nn.ConvTranspose3d))
                      else w.shape[1]) * k
            std = fan_in ** -0.5 / _TRUNC_STD
            with torch.no_grad():
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, InstanceNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


def build(name: str, *, dtype: torch.dtype = torch.float32, device="cuda",
          generator: torch.Generator | None = None, **kwargs) -> nn.Module:
    """Instantiate a registered model; kwargs override registered defaults.

    generator: CPU generator for the weights (default: seed 0)."""
    if name not in _REGISTRY:
        from micformer_tpu_torch import models  # noqa: F401  (registers)
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    dev = resolve_device(device)
    fn, defaults = _REGISTRY[name]
    model = fn(**{**defaults, **kwargs})
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(device=dev, dtype=dtype).eval()
