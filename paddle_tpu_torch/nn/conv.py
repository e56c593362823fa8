"""Conv2D — port of ``paddle_tpu.nn.conv.Conv2D``.

OIHW ``weight`` ``[Cout, Cin/groups, kh, kw]`` (torch's layout too) drawn
from N(0, 2 / fan_in) by :meth:`reset_parameters` (at construction from
the default generator; models redraw from their explicit one), and an
optional ``bias`` (zeros); ``weight_attr`` / ``bias_attr`` are
``ParamAttr`` objects (initializer, trainable, name), ``bias_attr=False`` means
no bias.  The parameter names are the JAX package's.
"""
from __future__ import annotations

import math

from ..framework.errors import UnimplementedError
from . import functional as F
from .initializer import Constant, Normal, create_parameter, init_parameter
from .layer import Layer

__all__ = ["Conv2D"]


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        if padding_mode != "zeros":
            raise UnimplementedError(
                f"Conv2D(padding_mode={padding_mode!r}) is not ported yet "
                f"(ROADMAP queue A, vision)")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, 2)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self._attrs = (weight_attr, bias_attr)
        self.weight = create_parameter(
            (out_channels, in_channels // groups) + self.kernel_size,
            weight_attr)
        self.bias = create_parameter((out_channels,), bias_attr)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in = self.in_channels // self.groups * math.prod(self.kernel_size)
        init_parameter(self.weight, self._attrs[0],
                       Normal(0.0, math.sqrt(2.0 / max(fan_in, 1))),
                       generator)
        init_parameter(self.bias, self._attrs[1], Constant(0.0), generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)
