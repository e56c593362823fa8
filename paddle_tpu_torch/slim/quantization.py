"""Quantization (port of ``paddle_tpu/slim/quantization.py``): serving
weight quantization, quantization-aware training (QAT), post-training
quantization (PTQ) and the int8 inference layers.

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
for ``GenerationEngine.swap_weights``; ``quantize_model_trees`` returns
the quantized ``(params, buffers)`` by dotted name without touching the
model's weights (registering unit ``weight_scale`` buffers where absent,
as the JAX package does; a float forward does not read them).

**QAT.** ``fake_quant_dequant`` is the straight-through estimator
``xf + (q - xf).detach()``: the forward is the quantize-dequantize, the
gradient the identity.  The observers keep the JAX buffers ``_scale``,
``_state`` and ``_accum`` (``[1]`` float32), updated IN PLACE in training
(``scale = (rate·accum + |x|max) / (rate·state + 1)``).
``ImperativeQuantAware.quantize`` swaps every ``Conv2D`` / ``Linear``
(not the tensor-parallel linears, which the JAX package's ``Linear`` type
does not cover either) for ``QuantizedConv2D`` / ``QuantizedLinear``,
which hold the float layer as ``_inner`` and share its parameters;
``convert`` freezes them to int8 layers from the trained activation
scales.

**Int8 layers.** ``Int8Linear`` / ``Int8Conv2D`` quantize activations by
their calibrated scale in the JAX order, ``clip(round(xf / act_scale *
127), -127, 127)`` (the divisor a float32 tensor on x's device: a Python
scalar divisor is a multiply by its reciprocal on the card), and run the
``[M, K] @ [K, N]`` int8 product with the ``w_scale * act_scale / 127²``
multiplier and the bias through ``ops.quantized_matmul.quantized_product``:
the hand-written ``quantized_matmul`` kernel on the card, exactly its
plain version on the CPU.  A convolution with ``groups == 1`` feeds it the
im2col of its int8 codes (an exact copy; the OIHW weight flattened to
``[Cin·kh·kw, Cout]`` in the same order), NCHW or NHWC.  A grouped
(depthwise) convolution multiplies the unfolded codes in float32 and sums
per group: every partial sum is an integer below ``K_group · 127² <
2^24``, so the result is exact; a group wider than that raises.

**PTQ.** ``PostTrainingQuantization`` hooks the input of every
quantizable layer (a forward pre-hook), keeps each batch's abs-maxima on
the device and reads them in ONE device-to-host copy per ``collect``;
``quantize`` swaps in the int8 layers (``abs_max``: the largest maximum,
``avg``: their mean).  The calibration / QAT telemetry of the JAX package
(``_notify_quant``) is a no-op until the event bus is ported (ROADMAP
item 7).
"""
from __future__ import annotations

import copy
import hashlib
import json
import os

import torch

from .. import nn
from ..framework.dtype import promote
from ..framework.errors import InvalidArgumentError
from ..nn import functional as F
from ..nn.functional.conv import _norm_tuple, _padding, _same_pads
from ..ops.quantized_matmul import quantized_product

__all__ = [
    "fake_quant_dequant", "FakeQuantAbsMax", "FakeQuantMovingAverage",
    "FakeQuantChannelWiseAbsMax", "MovingAverageAbsMaxScale",
    "QuantizedConv2D", "QuantizedLinear", "ImperativeQuantAware",
    "quantize_to_int8", "quantize_to_fp8", "Int8Linear", "Int8Conv2D",
    "PostTrainingQuantization", "quantize_weights",
    "quantize_model_trees", "export_quantized",
    "QUANT_MODES", "FP8_E4M3_MAX", "quantize_model",
]

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


def quantize_model_trees(model, mode="int8"):
    """``(params, buffers)`` by dotted name with the parallel-linear
    weights quantized and their ``….weight_scale`` filled in, while the
    model's own weights stay float.  As in the JAX package, a unit
    ``weight_scale`` buffer is registered on each target that has none
    (the float forward does not read it), so the trees and the model keep
    one structure."""
    _check_mode(mode)
    targets = _serving_targets(model)
    for _, layer in targets:
        if "weight_scale" not in layer._buffers:
            layer.register_buffer("weight_scale", torch.ones(
                layer.weight.shape[-1], dtype=torch.float32,
                device=layer.weight.device))
    params = {n: p.detach() for n, p in model.named_parameters()}
    buffers = {n: b for n, b in model.named_buffers()}
    for name, layer in targets:
        dot = f"{name}." if name else ""
        wkey = f"{dot}weight"
        w = layer.weight.detach()
        if _is_quantized_dtype(w.dtype):
            params[wkey] = buffers.pop(wkey)
            continue
        params[wkey], buffers[f"{dot}weight_scale"] = _quantize_weight(w,
                                                                       mode)
    return params, buffers


def _notify_quant(name, **info):
    """The JAX package's ``("quant", <site>)`` snapshot on the serving
    event bus: a no-op until the bus is ported (ROADMAP item 7)."""


# -- quantization-aware training ----------------------------------------------
def _scalar(v, device) -> torch.Tensor:
    """``v`` as a 0-d float32 tensor on ``device``: an operand that divides
    by IEEE rules on the card too."""
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def fake_quant_dequant(x, scale, bits=8):
    """Straight-through fake quantize-dequantize:
    ``round(clip(x, ±scale) / scale * r) * scale / r`` with ``r = 2^(b-1)
    - 1`` forward, the identity backward."""
    r = _scalar(2 ** (bits - 1) - 1, x.device)
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=x.device).clamp_min(1e-9)
    xf = x.float()
    q = torch.round(torch.clamp(xf, -scale, scale) / scale * r) * scale / r
    return (xf + (q - xf).detach()).to(x.dtype)


class FakeQuantAbsMax(nn.Layer):
    """Per-tensor abs-max fake quant, the scale recomputed from every
    tensor (the weight quantizer)."""

    def __init__(self, name=None, quant_bits=8, dtype="float32"):
        super().__init__()
        self._quant_bits = quant_bits

    def forward(self, x):
        return fake_quant_dequant(x, x.detach().abs().amax().float(),
                                  self._quant_bits)


class FakeQuantChannelWiseAbsMax(nn.Layer):
    """Per-output-channel abs-max weight fake quant; ``channel_axis`` is
    the output-channel axis of the weight layout."""

    def __init__(self, name=None, quant_bits=8, channel_axis=0,
                 dtype="float32"):
        super().__init__()
        self._quant_bits = quant_bits
        self._axis = channel_axis

    def forward(self, x):
        axes = [i for i in range(x.dim()) if i != self._axis]
        scale = x.detach().abs().amax(dim=axes, keepdim=True).float()
        return fake_quant_dequant(x, scale, self._quant_bits)


class _MovingAverage(nn.Layer):
    """The moving-average abs-max observer's state: ``[1]`` float32
    buffers ``_scale`` (0.001), ``_state`` (1) and ``_accum`` (1)."""

    def __init__(self, moving_rate):
        super().__init__()
        self._moving_rate = moving_rate
        for name, v in (("_scale", 0.001), ("_state", 1.0), ("_accum", 1.0)):
            self.register_buffer(name, torch.tensor([v], dtype=torch.float32))

    def _observe(self, x):
        """``scale = (rate·accum + |x|max) / (rate·state + 1)``, the
        buffers updated in place."""
        with torch.no_grad():
            cur = x.detach().abs().amax().float()
            state = self._state * self._moving_rate + 1.0
            accum = self._accum * self._moving_rate + cur
            self._state.copy_(state)
            self._accum.copy_(accum)
            self._scale.copy_(accum / state)
        return self._scale

    @property
    def scale(self):
        return self._scale.reshape(())


class FakeQuantMovingAverage(_MovingAverage):
    """Moving-average abs-max fake quant: training updates the scale from
    every tensor, eval uses the stored one."""

    def __init__(self, name=None, moving_rate=0.9, quant_bits=8,
                 dtype="float32"):
        super().__init__(moving_rate)
        self._quant_bits = quant_bits

    def forward(self, x):
        scale = self._observe(x) if self.training else self._scale
        return fake_quant_dequant(x, scale.reshape(()), self._quant_bits)


class MovingAverageAbsMaxScale(_MovingAverage):
    """Output-scale observer: records the moving-average abs-max of what
    flows through (in training) and passes it unchanged."""

    def __init__(self, name=None, moving_rate=0.9, dtype="float32"):
        super().__init__(moving_rate)

    def forward(self, x):
        if self.training:
            self._observe(x)
        return x


def _weight_quantizer(kind, bits, channel_axis, rate=0.9):
    if kind == "abs_max":
        return FakeQuantAbsMax(quant_bits=bits)
    if kind == "channel_wise_abs_max":
        return FakeQuantChannelWiseAbsMax(quant_bits=bits,
                                          channel_axis=channel_axis)
    if kind == "moving_average_abs_max":
        return FakeQuantMovingAverage(moving_rate=rate, quant_bits=bits)
    raise InvalidArgumentError(f"unknown weight_quantize_type {kind!r}")


def _act_quantizer(kind, bits, rate):
    if kind == "abs_max":
        return FakeQuantAbsMax(quant_bits=bits)
    if kind == "moving_average_abs_max":
        return FakeQuantMovingAverage(moving_rate=rate, quant_bits=bits)
    raise InvalidArgumentError(f"unknown activation_quantize_type {kind!r}")


class _QuantWrapper(nn.Layer):
    """``_inner`` (the float layer, parameters shared) and its weight and
    input quantizers, built on the inner layer's device."""

    def __init__(self, layer, channel_axis, weight_bits, activation_bits,
                 moving_rate, weight_quantize_type,
                 activation_quantize_type):
        super().__init__()
        self._inner = layer
        self._fake_quant_weight = _weight_quantizer(
            weight_quantize_type, weight_bits, channel_axis,
            rate=moving_rate)
        self._fake_quant_input = _act_quantizer(
            activation_quantize_type, activation_bits, moving_rate)
        dev = layer.weight.device
        self._fake_quant_weight.to(dev)
        self._fake_quant_input.to(dev)


class QuantizedConv2D(_QuantWrapper):
    """Conv2D with fake-quantized input and weight (OIHW: output channel
    axis 0)."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max"):
        super().__init__(layer, 0, weight_bits, activation_bits,
                         moving_rate, weight_quantize_type,
                         activation_quantize_type)

    def forward(self, x):
        inner = self._inner
        x = self._fake_quant_input(x)
        w = self._fake_quant_weight(inner.weight)
        return F.conv2d(x, w, inner.bias, inner.stride, inner.padding,
                        inner.dilation, inner.groups,
                        inner.data_format or "NCHW")


class QuantizedLinear(_QuantWrapper):
    """Linear with fake-quantized input and weight (``[in, out]``: output
    channel axis 1)."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max"):
        super().__init__(layer, 1, weight_bits, activation_bits,
                         moving_rate, weight_quantize_type,
                         activation_quantize_type)

    def forward(self, x):
        inner = self._inner
        x = self._fake_quant_input(x)
        w = self._fake_quant_weight(inner.weight)
        out = torch.matmul(*promote(x, w))
        if inner.bias is not None:
            out = out + inner.bias
        return out


def _replace_sublayer(model, dotted_name, new_layer):
    """Put ``new_layer`` at a ``named_sublayers`` path: every child lives
    in its parent's ``_modules`` under its path segment, whether it was
    attached as an attribute or by a container."""
    parts = dotted_name.split(".")
    parent = model
    for p in parts[:-1]:
        parent = parent._modules[p]
    parent._modules[parts[-1]] = new_layer


def _layer_types(quantizable_layer_type):
    name_map = {"Conv2D": nn.Conv2D, "Linear": nn.Linear}
    return tuple(name_map[t] if isinstance(t, str) else t
                 for t in quantizable_layer_type)


def _targets(model, types):
    """``(name, layer)`` of the quantizable sublayers.  The port's
    tensor-parallel linears subclass ``nn.Linear``, the JAX package's do
    not: they are left to the serving quantization, as in JAX."""
    from ..distributed.meta_parallel import (ColumnParallelLinear,
                                             RowParallelLinear)

    return [(n, l) for n, l in list(model.named_sublayers())
            if isinstance(l, types) and not isinstance(
                l, (ColumnParallelLinear, RowParallelLinear))]


class ImperativeQuantAware:
    """Rewrite a model in place for quantization-aware training: every
    quantizable sublayer becomes its fake-quant counterpart; fine-tune,
    then :meth:`convert` for int8 inference."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 moving_rate=0.9,
                 quantizable_layer_type=("Conv2D", "Linear")):
        if activation_quantize_type == "channel_wise_abs_max":
            raise InvalidArgumentError(
                "activations cannot quantize channel-wise")
        self._kw = dict(weight_bits=weight_bits,
                        activation_bits=activation_bits,
                        moving_rate=moving_rate,
                        weight_quantize_type=weight_quantize_type,
                        activation_quantize_type=activation_quantize_type)
        self._types = _layer_types(quantizable_layer_type)

    def quantize(self, model):
        for name, layer in _targets(model, self._types):
            cls = (QuantizedConv2D if isinstance(layer, nn.Conv2D)
                   else QuantizedLinear)
            _replace_sublayer(model, name, cls(layer, **self._kw))
        return model

    def convert(self, model):
        """Freeze a fine-tuned QAT model to int8 inference layers, with the
        trained moving-average activation scales."""
        targets = [(n, l) for n, l in list(model.named_sublayers())
                   if isinstance(l, (QuantizedConv2D, QuantizedLinear))]
        stale = sum(1 for _, l in targets
                    if hasattr(l._fake_quant_input, "_state")
                    and float(l._fake_quant_input._state) == 1.0)
        _notify_quant("qat", kind="calibration", layers=len(targets),
                      calibrated=len(targets) - stale,
                      uncalibrated_layers=stale)
        for name, layer in targets:
            act_q = layer._fake_quant_input
            if not hasattr(act_q, "scale"):
                raise InvalidArgumentError(
                    "convert() needs a trained static activation scale: "
                    "use activation_quantize_type='moving_average_abs_max' "
                    "(abs_max recomputes per batch and cannot freeze, like "
                    "the reference QuantizationFreezePass)")
            if float(act_q._state) == 1.0:
                raise InvalidArgumentError(
                    f"activation observer for {name!r} never saw data: run "
                    "training-mode forwards before convert() (the scale is "
                    "still its init value)")
            act_scale = float(act_q.scale)
            cls = (Int8Conv2D if isinstance(layer, QuantizedConv2D)
                   else Int8Linear)
            _replace_sublayer(model, name, cls.from_float(layer._inner,
                                                          act_scale))
        return model


# -- int8 inference layers ----------------------------------------------------
_RANGE2 = 127.0 * 127.0


def _act_codes(x, act_scale):
    """``clip(round(xf / act_scale * 127), -127, 127)`` as int8."""
    xf = x.float()
    return torch.clamp(torch.round(xf / _scalar(act_scale, x.device) * 127.0),
                       -127, 127).to(torch.int8)


class _Int8Layer(nn.Layer):
    """int8 weight codes ``w_q``, their float32 abs-max ``w_scale``, an
    optional float32 ``bias`` (all buffers) and the calibrated activation
    scale ``act_scale`` (a float, floored at 1e-9)."""

    def __init__(self, w_int8, w_scale, bias, act_scale):
        super().__init__()
        self.register_buffer("w_q", w_int8)
        self.register_buffer("w_scale", torch.as_tensor(
            w_scale, dtype=torch.float32, device=w_int8.device))
        if bias is not None:
            self.register_buffer("bias", torch.as_tensor(
                bias).detach().float().to(w_int8.device, copy=True))
        else:
            self.bias = None
        self.act_scale = max(float(act_scale), 1e-9)

    def _epilogue(self, N, device):
        """``(multiplier [N], bias [N])`` float32: ``w_scale · (act_scale /
        127²)`` (the quotient a float, then one float32 product, as JAX
        computes it) and the bias or zeros."""
        mult = (self.w_scale.reshape(-1)
                * _scalar(self.act_scale / _RANGE2, device))
        bias = (torch.zeros(N, dtype=torch.float32, device=device)
                if self.bias is None else self.bias.reshape(-1))
        return mult.contiguous(), bias.contiguous()


class Int8Linear(_Int8Layer):
    """Inference linear with int8 weights AND int8 activations: the int8
    product with an exact integer accumulator, then one float32 rescale
    and the bias (kernel 9 on the card)."""

    @classmethod
    def from_float(cls, linear, act_scale):
        wq, ws = quantize_to_int8(linear.weight, channel_axis=1)
        return cls(wq, ws, linear.bias, act_scale)

    def forward(self, x):
        K, N = self.w_q.shape
        lead = x.shape[:-1]
        xq = _act_codes(x, self.act_scale).reshape(-1, K)
        out = quantized_product(xq, self.w_q.contiguous(),
                                *self._epilogue(N, x.device))
        return out.reshape(*lead, N).to(x.dtype)


def _pads(padding, spatial, ksize, stride, dilation):
    """``(lo, hi)`` pairs of the two spatial dims for a Conv2D's
    ``padding`` (ints, pairs, ``"SAME"`` / ``"VALID"``)."""
    pads = _padding(padding, 2)
    if pads == "VALID":
        return [(0, 0), (0, 0)]
    if pads == "SAME":
        return _same_pads(spatial, ksize, stride, dilation)
    return pads


def _patches(xq, ksize, stride, pads, dilation):
    """``[N, Ho, Wo, C, kh, kw]`` view of the zero-padded NCHW ``xq``."""
    (ht, hb), (wl, wr) = pads
    N, C, H, W = xq.shape
    xp = xq
    if ht or hb or wl or wr:
        xp = xq.new_zeros(N, C, H + ht + hb, W + wl + wr)
        xp[:, :, ht:ht + H, wl:wl + W] = xq
    (kh, kw), (sh, sw), (dh, dw) = ksize, stride, dilation
    p = xp.unfold(2, (kh - 1) * dh + 1, sh).unfold(3, (kw - 1) * dw + 1, sw)
    return p[..., ::dh, ::dw].permute(0, 2, 3, 1, 4, 5)


class Int8Conv2D(_Int8Layer):
    """Inference convolution with int8 weights and activations: groups 1
    as the im2col of the codes through the int8 product (kernel 9 on the
    card), grouped / depthwise as exact float32 sums of the codes'
    products per group."""

    def __init__(self, w_int8, w_scale, bias, act_scale, stride, padding,
                 dilation, groups, data_format):
        super().__init__(w_int8, w_scale, bias, act_scale)
        self._cfg = (stride, padding, dilation, groups, data_format)

    @classmethod
    def from_float(cls, conv, act_scale):
        wq, ws = quantize_to_int8(conv.weight, channel_axis=0)
        return cls(wq, ws, conv.bias, act_scale, conv.stride, conv.padding,
                   conv.dilation, conv.groups, conv.data_format or "NCHW")

    def forward(self, x):
        stride, padding, dilation, groups, data_format = self._cfg
        stride = _norm_tuple(stride, 2, "stride")
        dilation = _norm_tuple(dilation, 2, "dilation")
        channel_last = data_format == "NHWC"
        xq = _act_codes(x, self.act_scale)
        if channel_last:
            xq = xq.permute(0, 3, 1, 2)
        O, Cg, kh, kw = self.w_q.shape
        pads = _pads(padding, tuple(xq.shape[2:]), (kh, kw), stride,
                     dilation)
        p = _patches(xq, (kh, kw), stride, pads, dilation)
        N, Ho, Wo = p.shape[:3]
        M, K = N * Ho * Wo, Cg * kh * kw
        mult, bias = self._epilogue(O, x.device)
        if groups == 1:
            out = quantized_product(
                p.reshape(M, K).contiguous(),
                self.w_q.reshape(O, K).t().contiguous(),
                mult, bias)
        else:
            if K * _RANGE2 >= 2 ** 24:
                raise InvalidArgumentError(
                    f"Int8Conv2D: a group of {K} inputs per output exceeds "
                    f"the exact float32 route (K * 127^2 < 2^24)")
            pf = p.reshape(M, groups, K).float()
            wf = self.w_q.reshape(groups, O // groups, K).float()
            acc = torch.einsum("mgk,gok->mgo", pf, wf).reshape(M, O)
            out = acc * mult + bias
        out = out.reshape(N, Ho, Wo, O)
        if not channel_last:
            out = out.permute(0, 3, 1, 2)
        return out.to(x.dtype)


# -- post-training quantization -----------------------------------------------
class PostTrainingQuantization:
    """Post-training quantization: feed calibration batches (``collect``),
    which record the abs-max of every quantizable layer's input, then
    freeze to int8 layers (``quantize``)::

        ptq = PostTrainingQuantization(model)
        for batch in calib_data:
            ptq.collect(batch)
        int8_model = ptq.quantize()
    """

    def __init__(self, model, algo="abs_max", activation_bits=8,
                 weight_bits=8, quantizable_layer_type=("Conv2D", "Linear")):
        if algo not in ("abs_max", "avg"):
            raise InvalidArgumentError(
                f"algo must be abs_max or avg, got {algo!r} (KL calibration "
                "is not implemented)")
        if activation_bits != 8 or weight_bits != 8:
            raise InvalidArgumentError("only 8-bit PTQ is implemented")
        self._model = model
        self._algo = algo
        self._stats = {}    # layer name -> host abs-max floats, one a batch
        self._pending = {}  # layer name -> device abs-max scalars
        self._targets = dict(_targets(model, _layer_types(
            quantizable_layer_type)))
        self._hooks = [layer.register_forward_pre_hook(self._make_hook(name))
                       for name, layer in self._targets.items()]

    def _make_hook(self, name):
        def hook(layer, inputs):
            # the maximum stays on the device: collect() reads a batch's
            # maxima of every layer in one copy
            self._pending.setdefault(name, []).append(
                inputs[0].detach().abs().amax().float())
        return hook

    def collect(self, *batch):
        """Run one calibration batch through the model (eval mode, no
        gradient), then read every layer's maxima in ONE transfer."""
        self._model.eval()
        with torch.no_grad():
            out = self._model(*batch)
        pending, self._pending = self._pending, {}
        if pending:
            names = [n for n, vals in pending.items() for _ in vals]
            host = torch.stack([v for vals in pending.values()
                                for v in vals]).cpu().tolist()
            for name, v in zip(names, host):
                self._stats.setdefault(name, []).append(v)
        self._emit_calibration()
        return out

    def _emit_calibration(self):
        seen = sum(1 for n in self._targets if self._stats.get(n))
        _notify_quant("ptq", kind="calibration",
                      layers=len(self._targets), calibrated=seen,
                      uncalibrated_layers=len(self._targets) - seen)

    def quantize(self):
        """Freeze the observed scales into int8 layers; returns the
        model."""
        for h in self._hooks:
            h.remove()
        self._emit_calibration()
        for name, layer in self._targets.items():
            obs = self._stats.get(name)
            if not obs:
                raise InvalidArgumentError(
                    f"no calibration data flowed through layer {name!r}")
            act_scale = (max(obs) if self._algo == "abs_max"
                         else sum(obs) / len(obs))
            cls = Int8Conv2D if isinstance(layer, nn.Conv2D) else Int8Linear
            _replace_sublayer(self._model, name,
                              cls.from_float(layer, act_scale))
        return self._model
