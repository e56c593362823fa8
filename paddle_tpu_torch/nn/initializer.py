"""Weight initializers and ``ParamAttr`` — port of
``paddle_tpu.nn.initializer``.

An initializer fills a tensor in place, ``init.init_(tensor, generator)``
(its random draws from ``generator``: the caller's, else the CPU
generator of ``framework.random`` for a CPU tensor or the device's
generator for a card one), or makes one on the CPU,
``init(shape, dtype, generator)``.  The fans follow the JAX package:
a 2-D weight is paddle's ``[in, out]``; a conv kernel ``[out, in, *k]``.
``Constant``, ``Assign``, ``Dirac`` and ``Bilinear`` are deterministic.

``ParamAttr(name, initializer, learning_rate, regularizer, trainable,
...)``: the layers honor ``initializer``, ``trainable`` (False: the
parameter does not require grad, so no optimizer step takes it) and
``name`` (the parameter's ``name`` attribute), as the JAX package's
``build_parameter`` does; ``learning_rate`` and ``regularizer`` are kept
but not applied per parameter, also as there (its docstring says they
are; ROADMAP §C).
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Optional

import numpy as np
import torch

from ..framework.dtype import convert_dtype, numpy_to_tensor
from ..framework.random import default_generator, generator_for

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Bilinear", "Dirac", "Orthogonal", "calculate_gain",
           "ParamAttr"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:  # paddle's Linear layout: (in_features, out_features)
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))  # conv kernels: OIHW
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (
            param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


def _gen(tensor, generator):
    if generator is not None:
        return generator
    if tensor.device.type == "cpu":
        return default_generator()
    return generator_for(tensor.device)


class Initializer:
    def __call__(self, shape, dtype=None, generator=None) -> torch.Tensor:
        """A new CPU tensor of ``shape`` (float32 unless ``dtype``)."""
        out = torch.empty(tuple(shape), dtype=convert_dtype(dtype)
                          if dtype is not None else torch.float32)
        return self.init_(out, generator)

    def init_(self, tensor: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            self._fill(tensor, generator)
        return tensor

    def _fill(self, tensor, generator):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, tensor, generator):
        tensor.fill_(self.value)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _fill(self, tensor, generator):
        tensor.uniform_(self.low, self.high,
                        generator=_gen(tensor, generator))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, tensor, generator):
        tensor.normal_(self.mean, self.std,
                       generator=_gen(tensor, generator))


class TruncatedNormal(Initializer):
    """N(mean, std²) truncated at ±2σ (the reference's
    TruncatedNormalInitializer), by inverting the CDF of uniform draws
    between Φ(-2) and Φ(2)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, tensor, generator):
        lo, hi = (math.erf(-2.0 / math.sqrt(2.0)),
                  math.erf(2.0 / math.sqrt(2.0)))
        work = torch.empty(tensor.shape, dtype=torch.float32,
                           device=tensor.device)
        work.uniform_(lo, hi, generator=_gen(tensor, generator))
        z = torch.erfinv(work).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        tensor.copy_(z * self.std + self.mean)


class _FanInit(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = _fans(shape)
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)


class XavierNormal(_FanInit):
    def _fill(self, tensor, generator):
        fi, fo = self._fans(tensor.shape)
        tensor.normal_(0.0, self.gain * math.sqrt(2.0 / (fi + fo)),
                       generator=_gen(tensor, generator))


class XavierUniform(_FanInit):
    def _fill(self, tensor, generator):
        fi, fo = self._fans(tensor.shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        tensor.uniform_(-limit, limit, generator=_gen(tensor, generator))


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain_fan(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        return calculate_gain(self.nonlinearity, self.negative_slope), fi


class KaimingNormal(_Kaiming):
    """The reference's MSRAInitializer: N(0, (gain / sqrt(fan_in))²)."""

    def _fill(self, tensor, generator):
        gain, fi = self._gain_fan(tensor.shape)
        tensor.normal_(0.0, gain / math.sqrt(fi),
                       generator=_gen(tensor, generator))


class KaimingUniform(_Kaiming):
    def _fill(self, tensor, generator):
        gain, fi = self._gain_fan(tensor.shape)
        limit = gain * math.sqrt(3.0 / fi)
        tensor.uniform_(-limit, limit, generator=_gen(tensor, generator))


class Assign(Initializer):
    """The reference's NumpyArrayInitializer: ``value`` (reshaped to the
    parameter's shape)."""

    def __init__(self, value):
        self.value = (value.detach().cpu() if isinstance(value, torch.Tensor)
                      else numpy_to_tensor(np.asarray(value)))

    def _fill(self, tensor, generator):
        tensor.copy_(self.value.reshape(tensor.shape))


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a transposed convolution (the
    reference's BilinearInitializer): ``weight[i, i % C_in]`` for ``i <
    min(C_out, C_in)``."""

    def _fill(self, tensor, generator):
        c_out, c_in, *spatial = tensor.shape
        weight = np.zeros(tuple(tensor.shape), dtype=np.float64)
        k = spatial[0]
        factor = (k + 1) // 2
        center = factor - 1.0 if k % 2 == 1 else factor - 0.5
        og = np.ogrid[tuple(np.s_[:s] for s in spatial)]
        filt = np.ones([1] * len(spatial))
        for g in og:
            filt = filt * (1 - np.abs(g - center) / factor)
        for i in range(min(c_out, c_in)):
            weight[i, i % c_in] = filt
        tensor.copy_(torch.from_numpy(weight))


class Dirac(Initializer):
    """An identity convolution: 1 at the kernel's center of ``[i, i]``."""

    def _fill(self, tensor, generator):
        c_out, c_in, *spatial = tensor.shape
        w = np.zeros(tuple(tensor.shape), dtype=np.float64)
        centers = tuple(s // 2 for s in spatial)
        for i in range(min(c_out, c_in)):
            w[(i, i) + centers] = 1.0
        tensor.copy_(torch.from_numpy(w))


class Orthogonal(Initializer):
    """A (semi-)orthogonal matrix over the first dim and the rest
    flattened, times ``gain``."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _fill(self, tensor, generator):
        work = torch.empty(tensor.shape, dtype=torch.float32,
                           device=tensor.device)
        torch.nn.init.orthogonal_(work, self.gain,
                                  generator=_gen(tensor, generator))
        tensor.copy_(work)


class ParamAttr:
    """Parity: ``paddle.ParamAttr``; what the layers honor is in the
    module docstring."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


def create_parameter(shape, attr=None):
    """An (unfilled) ``nn.Parameter`` of ``shape`` under ``attr``:
    ``None`` for ``attr=False``; ``trainable`` and ``name`` applied."""
    from .layer import Parameter

    if attr is False:
        return None
    named = isinstance(attr, ParamAttr) and attr.name is not None
    trainable = bool(attr.trainable) if isinstance(attr, ParamAttr) else True
    return Parameter(torch.empty(tuple(shape)),
                     name=attr.name if named else "", trainable=trainable)


_filling = threading.local()  # depth of fills_its_layers constructors


def fills_its_layers(init):
    """Decorate a model constructor that fills every layer itself, in
    module order from its generator (``reset_parameters(generator)``):
    the layers built inside it skip their construction-time fill, so each
    weight is drawn once and the seed's stream is the constructor's."""
    @functools.wraps(init)
    def wrapped(*args, **kwargs):
        _filling.depth = getattr(_filling, "depth", 0) + 1
        try:
            return init(*args, **kwargs)
        finally:
            _filling.depth -= 1
    return wrapped


def fill_at_construction(layer):
    """``layer.reset_parameters()`` from the CPU generator, as a JAX layer
    draws at construction; skipped inside a :func:`fills_its_layers`
    constructor, which fills the layer itself."""
    if not getattr(_filling, "depth", 0):
        layer.reset_parameters()


def build_parameter(shape, dtype="float32", attr=None, is_bias=False,
                    default_initializer=None):
    """A filled parameter (paddle's ``create_parameter``, shared by
    ``Layer.create_parameter`` and ``static.create_parameter``): ``shape``
    and ``dtype``, drawn by ``attr``'s initializer, else
    ``default_initializer``, else zeros for a bias and Xavier-normal
    otherwise; ``None`` for ``attr=False``."""
    from ..framework.dtype import convert_dtype

    p = create_parameter(tuple(int(d) for d in shape), attr)
    if p is None:
        return None
    init_parameter(p, attr, default_initializer or (
        Constant(0.0) if is_bias else XavierNormal()))
    p.data = p.data.to(convert_dtype(dtype or "float32"))
    return p


def init_parameter(param, attr, default: Initializer, generator=None):
    """Fill ``param`` by ``attr``'s initializer, else by ``default``."""
    if param is None:
        return
    init = getattr(attr, "initializer", None) or default
    init.init_(param, generator)
