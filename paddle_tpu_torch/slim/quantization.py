"""Serving weight quantization (port of the serving half of
``paddle_tpu/slim/quantization.py``).

``quantize_weights(model, mode)`` turns every ``ColumnParallelLinear`` /
``RowParallelLinear`` weight (GPT ``qkv`` / ``out`` / ``fc1`` / ``fc2``)
into an int8 or float8_e4m3fn tensor plus a per-output-channel float32
``weight_scale`` buffer, IN PLACE; the layers' forwards dispatch on the
weight dtype (``distributed/meta_parallel.py``), so no layer is swapped.
``quantize_model(model, mode)`` is the non-mutating form serving engines
use (the JAX package returns quantized parameter trees to bind; here the
counterpart is a quantized deep copy of the module): ``model`` keeps its
float weights.

The expressions keep the JAX package's order of operations (``w / scale *
127``, ``scale`` floored at 1e-9, round half to even, fp8 clipped to
+-448 BEFORE the cast — e4m3fn has no inf, an overflowing cast is NaN),
so both packages produce the same codes and scales from the same weights.
``export_quantized(model, path, mode)`` writes the JAX package's
quantized weight artifact (``<path>.pdiparams`` plus its sha256 manifest)
for ``GenerationEngine.swap_weights``.  Not ported yet (ROADMAP queue A,
quantized serving): the QAT fake-quant layers, ``Int8Linear`` /
``Int8Conv2D`` and ``PostTrainingQuantization``.
"""
from __future__ import annotations

import copy
import hashlib
import json
import os

import torch

from ..framework.errors import InvalidArgumentError

__all__ = ["QUANT_MODES", "FP8_E4M3_MAX", "quantize_to_int8",
           "quantize_to_fp8", "quantize_weights", "quantize_model",
           "export_quantized"]

QUANT_MODES = ("int8", "fp8")
#: largest finite float8_e4m3fn
FP8_E4M3_MAX = 448.0
_QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)


def _absmax(wf, channel_axis):
    if channel_axis is None:
        scale = wf.abs().max()
    else:
        axes = [i for i in range(wf.dim()) if i != channel_axis]
        scale = wf.abs().amax(dim=axes, keepdim=True) if axes else wf.abs()
    return scale.clamp_min(1e-9)


def quantize_to_int8(w, channel_axis=None):
    """w (float) → (int8 weights, float32 scale) by (channel-wise)
    abs-max."""
    wf = w.detach().float()
    scale = _absmax(wf, channel_axis)
    q = torch.clamp(torch.round(wf / scale * 127.0), -127, 127).to(torch.int8)
    return q, scale


def quantize_to_fp8(w, channel_axis=None):
    """w (float) → (fp8-e4m3 weights, float32 scale) by (channel-wise)
    abs-max, mirroring :func:`quantize_to_int8`: dequant is
    ``q * scale / FP8_E4M3_MAX``.  The clip BEFORE the cast matters:
    e4m3fn has no inf, so an overflowing cast silently produces NaN."""
    wf = w.detach().float()
    scale = _absmax(wf, channel_axis)
    q = torch.clamp(wf / scale * FP8_E4M3_MAX,
                    -FP8_E4M3_MAX, FP8_E4M3_MAX).to(torch.float8_e4m3fn)
    return q, scale


def _is_quantized_dtype(dtype) -> bool:
    return dtype in _QUANT_DTYPES


def _check_mode(mode):
    if mode not in QUANT_MODES:
        raise InvalidArgumentError(
            f"quantization mode must be one of {QUANT_MODES}, got {mode!r}")


def _quantize_weight(w, mode):
    """One ``[in, out]`` weight → (quantized weight, ``[out]`` float32
    dequant multiplier): ``w ≈ w_q.float() * weight_scale`` per channel."""
    _check_mode(mode)
    q, scale = (quantize_to_int8 if mode == "int8" else quantize_to_fp8)(
        w, channel_axis=w.dim() - 1)
    # tensor / tensor: an IEEE division on both devices (``scale / 127.0``
    # is a multiply by 1/127 on the card, an ulp off)
    top = torch.full_like(scale, 127.0 if mode == "int8" else FP8_E4M3_MAX)
    return q, (scale / top).reshape(-1).float()


def _serving_targets(model):
    """The Linear hot paths the quantized serving stack routes: every
    tensor-parallel linear."""
    from ..distributed.meta_parallel import (ColumnParallelLinear,
                                             RowParallelLinear)

    return [(n, l) for n, l in model.named_modules()
            if isinstance(l, (ColumnParallelLinear, RowParallelLinear))]


def quantize_weights(model, mode="int8"):
    """Quantize a model's parallel-linear weights IN PLACE for serving.

    Each ColumnParallelLinear / RowParallelLinear weight becomes an int8
    (or fp8-e4m3) tensor plus a per-output-channel ``weight_scale``
    buffer, both under their float names (``….weight``,
    ``….weight_scale``).  Idempotent: already-quantized layers are left
    alone.  A LoRA model's adapter tables (``lora_A`` / ``lora_B`` /
    ``lora_scale`` buffers) stay float and unquantized, as in the JAX
    package: the LoRA leg runs after the quantized product.  Returns the
    model.

    Cast the model to its float dtype BEFORE quantizing it:
    ``Module.to(dtype)`` casts float8_e4m3fn buffers too (an int8 one it
    leaves), and a parallel linear whose ``weight_scale`` then sits beside
    a float weight raises ``InvalidArgumentError`` in its forward rather
    than compute with unscaled codes."""
    _check_mode(mode)
    for _, layer in _serving_targets(model):
        if _is_quantized_dtype(layer.weight.dtype):
            continue
        layer.set_quantized(*_quantize_weight(layer.weight, mode))
    return model


def quantize_model(model, mode="int8"):
    """A quantized deep copy of ``model`` for a serving engine; ``model``
    itself keeps its float weights bit for bit, and two engines built
    over one model share nothing.  (Counterpart of the JAX package's
    ``quantize_model_trees``, which returns quantized trees to bind.)"""
    _check_mode(mode)
    return quantize_weights(copy.deepcopy(model), mode)


def weight_trees(model, float_params=None):
    """``(params, buffers)``: ``model``'s tensors by dotted name, split as
    the JAX package's ``param_pytree`` / ``buffer_pytree`` split them.  A
    quantized weight is a buffer in a port model but a parameter in a JAX
    tree, so ``params`` holds the names of ``float_params`` (default: the
    parameters of ``model``, plus every quantized ``….weight``)."""
    state = dict(model.state_dict(keep_vars=False))
    if float_params is None:
        float_params = {n for n, _ in model.named_parameters()}
        float_params |= {n for n, t in state.items() if n.endswith(".weight")
                         and _is_quantized_dtype(t.dtype)}
    params = {n: t for n, t in state.items() if n in float_params}
    buffers = {n: t for n, t in state.items() if n not in float_params}
    return params, buffers


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def export_quantized(model, path, mode="int8"):
    """Write a quantized weight artifact in the JAX package's format:
    ``<path>.pdiparams`` holding ``{"params", "buffers", "quantization"}``
    (the quantized parameter tree, the ``….weight_scale`` buffers, the
    mode tag) and a ``<path>.pdiparams.manifest.json`` sidecar with the
    artifact's sha256.  ``model`` keeps its float weights.  The artifact
    swaps into an engine built with the matching ``quantized=`` mode
    (``GenerationEngine.swap_weights``).  As every file the port writes
    (``framework.serialization``), fp8 codes are stored widened to
    float32, exactly; int8 codes as int8.  Returns the ``.pdiparams``
    path."""
    from ..framework import serialization

    _check_mode(mode)
    names = {n for n, _ in model.named_parameters()}
    params, buffers = weight_trees(quantize_model(model, mode), names)
    path = os.fspath(path)
    prefix = (path[: -len(".pdiparams")]
              if path.endswith(".pdiparams") else path)
    artifact = prefix + ".pdiparams"
    serialization.save(
        {"params": params, "buffers": buffers, "quantization": mode},
        artifact)
    manifest = {
        "format": "paddle_tpu.quantized_weights.v1",
        "quantization": mode,
        "file": os.path.basename(artifact),
        "sha256": _sha256(artifact),
        "num_params": len(params),
        "num_buffers": len(buffers),
    }
    mpath = artifact + ".manifest.json"
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, mpath)
    return artifact
