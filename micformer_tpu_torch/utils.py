"""Small utilities shared across the port.

Counterpart of `micformer_tpu/utils.py`.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch.nn as nn


def count_parameters(params) -> int:
    """Total element count of a module's parameters, of a state_dict's
    tensors or of an iterable of tensors (the number the reference reports
    for each model family, utils.py:141-142)."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, Mapping):
        params = params.values()
    return int(sum(t.numel() for t in params))
