"""Activation functions — port of ``paddle_tpu.nn.functional.activation``
with the JAX package's arithmetic: integer inputs compute in float32
(except ``relu`` and ``maxout``, which keep the input's dtype),
``softplus`` switches to the identity above ``threshold``,
``hardsigmoid``'s default slope is 0.1666667.

The random ones draw from the generator of the input's device
(``framework.random.generator_for``), never from torch's global RNG:
``rrelu``'s slopes in training and ``gumbel_softmax``'s noise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...framework.dtype import convert_dtype
from ...framework.random import generator_for
from ...tensor._common import f as _f
from ...tensor._common import t as _t

__all__ = [
    "relu", "relu6", "relu_", "elu", "selu", "celu", "gelu", "silu", "swish",
    "leaky_relu", "prelu", "rrelu", "hardshrink", "hardsigmoid", "hardswish",
    "hardtanh", "log_sigmoid", "log_softmax", "softmax", "softmax_",
    "maxout", "mish", "softplus", "softshrink", "softsign", "tanhshrink",
    "thresholded_relu", "glu", "gumbel_softmax", "sigmoid", "tanh",
]


def relu(x, name=None):
    return torch.relu(_t(x))


relu_ = relu


def relu6(x, name=None):
    return torch.clamp(_f(x), 0.0, 6.0)


def elu(x, alpha=1.0, name=None):
    return F.elu(_f(x), alpha=alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    x = _f(x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return F.celu(_f(x), alpha=alpha)


def gelu(x, approximate=False, name=None):
    return F.gelu(_f(x), approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return F.silu(_f(x))


swish = silu


def leaky_relu(x, negative_slope=0.01, name=None):
    x = _f(x)
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``weight`` of one element, or one per channel (axis 1 for
    ``NCHW``-style layouts, the last axis otherwise)."""
    x = _f(x)
    w = _t(weight, x).to(x.dtype)
    if w.numel() > 1:
        axis = 1 if data_format == "NCHW" else x.dim() - 1
        shape = [1] * x.dim()
        shape[axis] = w.numel()
        w = w.reshape(shape)
    else:
        w = w.reshape(())
    return torch.where(x > 0, x, w * x)


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=True,
          name=None):
    """Training: each negative element scaled by its own slope drawn
    uniformly from ``[lower, upper)``; eval: by their mean."""
    x = _f(x)
    if training:
        a = torch.empty_like(x).uniform_(lower, upper,
                                         generator=generator_for(x.device))
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)


def hardshrink(x, threshold=0.5, name=None):
    x = _f(x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    x = _f(x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    x = _f(x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(_f(x), min, max)


def log_sigmoid(x, name=None):
    return F.logsigmoid(_f(x))


def log_softmax(x, axis=-1, dtype=None, name=None):
    x = _f(x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def softmax(x, axis=-1, dtype=None, name=None):
    x = _f(x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


softmax_ = softmax


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` consecutive channels of
    ``axis``."""
    x = _t(x)
    axis = axis % x.dim()
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return x.reshape(shape).amax(axis + 1)


def mish(x, name=None):
    x = _f(x)
    return x * torch.tanh(F.softplus(x))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    x = _f(x)
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.logaddexp(scaled, torch.zeros_like(scaled))
                       / beta)


def softshrink(x, threshold=0.5, name=None):
    x = _f(x)
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def softsign(x, name=None):
    x = _f(x)
    return x / (1.0 + x.abs())


def tanhshrink(x, name=None):
    x = _f(x)
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    x = _f(x)
    return torch.where(x > threshold, x, torch.full_like(x, value))


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(_f(x), 2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g =
    -log(-log(u))``, ``u`` uniform on ``[tiny, 1)``; ``hard``: the one-hot
    of its argmax in the forward, the soft gradient in the backward (the
    straight-through estimator)."""
    x = _f(x)
    tiny = torch.finfo(x.dtype).tiny
    u = torch.empty_like(x).uniform_(tiny, 1.0,
                                     generator=generator_for(x.device))
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


def sigmoid(x, name=None):
    return torch.sigmoid(_f(x))


def tanh(x, name=None):
    return torch.tanh(_f(x))
