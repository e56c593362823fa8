"""Load weights exported from the JAX package into a port model.

``arrays`` maps the JAX dotted parameter names to numpy arrays — what
``{k: np.asarray(p.value) for k, p in jax_model.named_parameters()}``
produces.  The port keeps the JAX names and layouts (Linear weights
``[in, out]``), so the mapping is 1:1; any missing name, extra name or
shape mismatch raises.  Each float array is copied into the parameter's
own dtype, so a bf16 model (JAX bf16 arrays arrive as
``ml_dtypes.bfloat16`` numpy) loads exactly.

``buffers`` maps JAX dotted buffer names to numpy arrays —
``{k: np.asarray(b.value) for k, b in jax_model.named_buffers()}``.  A
name that is a float buffer of the port model (BatchNorm's ``_mean`` and
``_variance``, a LoRA model's ``lora_A`` / ``lora_B`` / ``lora_scale``
tables) is copied into that buffer, in the buffer's own dtype, with a
shape check; a name that is neither such a buffer nor the
``…weight_scale`` of a quantized weight in ``arrays`` raises.

A JAX QUANTIZED tree (``slim.quantize_model_trees(model, mode)`` as
numpy) loads the same way: ``arrays`` is its parameter tree, whose
parallel-linear weights are int8 (numpy ``int8``) or fp8-e4m3 (either
``ml_dtypes.float8_e4m3fn`` or the raw bits as ``uint8``), and
``buffers`` its buffer tree, which holds each ``….weight_scale``.  Those
layers become quantized in the port model (``set_quantized``) with the
very same codes and scales, so both packages compute from identical
quantized weights.  Imports no JAX: only numpy crosses the boundary.

``load_jax_program(program, scope, buffers)`` carries a JAX static-graph
Program's scope and buffers (numpy, by scope name) into a port Program
(``static.Program``).  Names match with their ``_{idx}_`` prefix stripped:
both packages record the same builders in the same order, so the rest of
a name (``fc.weight_2``) is the same.  The values go into the scope and
into the initial values, so ``exe.run(startup)`` starts both packages
from the same point.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .framework.errors import InvalidArgumentError

__all__ = ["load_jax_params", "load_jax_program"]


def _quantized_tensor(a: np.ndarray) -> Optional[torch.Tensor]:
    """The torch tensor of a quantized numpy weight, ``None`` for a float
    one."""
    if a.dtype == np.int8:
        return torch.from_numpy(np.array(a))  # a writable copy
    if a.dtype == np.uint8 or a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a).view(np.uint8)).view(
            torch.float8_e4m3fn)
    return None


def load_jax_params(model: torch.nn.Module,
                    arrays: Mapping[str, np.ndarray],
                    buffers: Optional[Mapping[str, np.ndarray]] = None
                    ) -> torch.nn.Module:
    slots = dict(model.named_parameters())
    # an already-quantized layer holds its weight as a buffer, same name
    slots.update({n: b for n, b in model.named_buffers()
                  if n.endswith(".weight")})
    buffers = buffers or {}
    missing = sorted(set(slots) - set(arrays))
    extra = sorted(set(arrays) - set(slots))
    if missing or extra:
        raise InvalidArgumentError(
            f"load_jax_params: missing {missing[:8]}, unexpected {extra[:8]}")
    scales = {f"{n}_scale" for n in arrays
              if _quantized_tensor(np.asarray(arrays[n])) is not None}
    own = {n: b for n, b in model.named_buffers() if n not in slots}
    floats = {n: own[n] for n in buffers if n in own and n not in scales}
    unknown = sorted(n for n in buffers if n not in floats and n not in scales)
    if unknown:
        raise InvalidArgumentError(
            f"load_jax_params: buffers {unknown[:8]} are neither buffers of "
            f"the model nor scales of quantized weights in arrays")
    checks = [(n, arrays[n], p) for n, p in slots.items()]
    checks += [(n, buffers[n], b) for n, b in floats.items()]
    for name, a, p in checks:
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise InvalidArgumentError(
                f"load_jax_params: {name} has shape {tuple(a.shape)}, the "
                f"model expects {tuple(p.shape)}")
    with torch.no_grad():
        for name, b in floats.items():
            b.copy_(torch.from_numpy(np.array(buffers[name], np.float32)))
        for name, p in slots.items():
            a = np.asarray(arrays[name])
            q = _quantized_tensor(a)
            if q is None:
                if not p.is_floating_point() or p.element_size() == 1:
                    raise InvalidArgumentError(
                        f"load_jax_params: {name} is quantized "
                        f"({p.dtype}) in the model but {a.dtype} in arrays")
                p.copy_(torch.from_numpy(np.array(a, np.float32)))
                continue
            layer = model.get_submodule(name.rpartition(".")[0])
            scale = buffers.get(f"{name}_scale")
            if scale is None or not hasattr(layer, "set_quantized"):
                raise InvalidArgumentError(
                    f"load_jax_params: {name} arrives quantized ({a.dtype}); "
                    f"it needs {name}_scale in buffers and a parallel-linear "
                    f"layer to hold it")
            layer.set_quantized(
                q, torch.from_numpy(np.array(scale, np.float32)))
    return model


def _program_key(name: str) -> str:
    """A scope name without its program prefix: ``_3_fc.weight_2`` →
    ``fc.weight_2``."""
    return name.split("_", 2)[2] if name.startswith("_") else name


def load_jax_program(program, scope: Mapping[str, np.ndarray],
                     buffers: Optional[Mapping[str, np.ndarray]] = None):
    """Copy a JAX Program's ``scope`` and ``buffers`` (name → numpy) into
    the port ``program``'s parameters, buffers and initial values, each in
    its target's dtype; every name of either side must match, with the
    same shape."""
    pairs = []
    for mine, theirs in ((program.scope, scope),
                         (program.buffers, buffers or {})):
        by_key = {_program_key(n): n for n in mine}
        keys = {_program_key(n): n for n in theirs}
        missing = sorted(set(by_key) - set(keys))
        extra = sorted(set(keys) - set(by_key))
        if missing or extra:
            raise InvalidArgumentError(
                f"load_jax_program: missing {missing[:8]}, unexpected "
                f"{extra[:8]}")
        for k, n in by_key.items():
            a = np.asarray(theirs[keys[k]])
            if tuple(a.shape) != tuple(mine[n].shape):
                raise InvalidArgumentError(
                    f"load_jax_program: {k} has shape {tuple(a.shape)}, the "
                    f"program expects {tuple(mine[n].shape)}")
            pairs.append((n, mine[n], a))
    with torch.no_grad():
        for n, t, a in pairs:
            v = (torch.from_numpy(np.array(a, np.float32))
                 if t.is_floating_point() else torch.from_numpy(np.array(a)))
            t.copy_(v.to(t.dtype))
            program._init_values[n] = t.detach().to("cpu", copy=True)
    return program
