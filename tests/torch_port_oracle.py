"""Weights for holding the port's zoo against the JAX package: a flax
parameter tree drawn with numpy at the shapes `init` would make (nothing is
compiled), with kernels scaled by 1/sqrt(fan in), norm scales near 1,
biases near 0, relative-position tables large enough to matter
and PReLU slopes near 0.25."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict


def flax_params(model, x, seed: int = 0, **kwargs) -> dict:
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.asarray(x), **kwargs)["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for key, sd in flatten_dict(shapes).items():
        z = rng.normal(size=sd.shape).astype(np.float32)
        if key[-1] == "kernel":
            flat[key] = z / np.sqrt(np.prod(sd.shape[:-1]))
        elif key[-1] == "rel_pos_bias_table":
            flat[key] = 0.5 * z
        elif key[-1] == "alpha":
            flat[key] = 0.25 + 0.05 * z
        else:
            flat[key] = 0.1 * z + (1.0 if key[-1] == "scale" else 0.0)
    return unflatten_dict(flat)
