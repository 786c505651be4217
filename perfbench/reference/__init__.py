"""The plain f32 references of the benchmark's configurations, one module
each, named by a configuration's `reference` key. They import nothing of
the program under test."""

from __future__ import annotations

import importlib

import torch


def build_reference(config: dict, device="cpu", fp8: bool = False) -> torch.nn.Module:
    """The reference model of `config` (its `reference` module's class of
    the same name as `config["model_class"]`, built with `config["kwargs"]`)
    on `device` in eval mode; fp8: its matmul and conv operands rounded to
    fp8 (the lower-precision control)."""
    module = importlib.import_module(f"perfbench.reference.{config['reference']}")
    cls = getattr(module, config["model_class"])
    with torch.device(device):
        model = cls(**config["kwargs"], fp8=fp8)
    return model.eval()
