"""Load weights exported from the JAX package into a port model.

``arrays`` maps the JAX dotted parameter names to numpy arrays — what
``{k: np.asarray(p.value) for k, p in jax_model.named_parameters()}``
produces.  The port keeps the JAX names and layouts (Linear weights
``[in, out]``), so the mapping is 1:1; any missing name, extra name or
shape mismatch raises.  Each array is copied into the parameter's own
dtype, so a bf16 model (JAX bf16 arrays arrive as ``ml_dtypes.bfloat16``
numpy) loads exactly.  Imports no JAX: only numpy crosses the boundary.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .framework.errors import InvalidArgumentError

__all__ = ["load_jax_params"]


def load_jax_params(model: torch.nn.Module,
                    arrays: Mapping[str, np.ndarray]) -> torch.nn.Module:
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise InvalidArgumentError(
            f"load_jax_params: missing {missing[:8]}, unexpected {extra[:8]}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise InvalidArgumentError(
                f"load_jax_params: {name} has shape {tuple(a.shape)}, the "
                f"model expects {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(arrays[name], np.float32)))
    return model
