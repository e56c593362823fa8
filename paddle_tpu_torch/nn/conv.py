"""Convolution layers — port of ``paddle_tpu.nn.conv``: ``Conv1D`` /
``Conv2D`` / ``Conv3D`` and the three transposed convolutions on one
``_ConvNd``.

``weight`` is ``[Cout, Cin/groups, *k]`` (torch's layout too), or
``[Cin, Cout/groups, *k]`` for the transposed layers, drawn from
N(0, 2 / fan_in) with ``fan_in = Cin / groups · prod(k)`` in both layouts
by :meth:`reset_parameters` (at construction from the default generator;
models redraw from their explicit one), and an optional ``bias`` (zeros);
``weight_attr`` / ``bias_attr`` are ``ParamAttr`` objects (initializer,
trainable, name), ``bias_attr=False`` means no bias.  ``padding_mode`` is
accepted and has no effect: the JAX package's layers never read it, so
every convolution pads with zeros.  The parameter names are the JAX
package's.
"""
from __future__ import annotations

import math

from . import functional as F
from .initializer import Constant, Normal, create_parameter, init_parameter
from .layer import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    _ndim = 2
    _transpose = False
    _format = "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, output_padding=0,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format=None, name=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, self._ndim)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.output_padding = output_padding
        self.padding_mode = padding_mode
        self.data_format = data_format or self._format
        self._attrs = (weight_attr, bias_attr)
        if self._transpose:
            shape = (in_channels, out_channels // groups)
        else:
            shape = (out_channels, in_channels // groups)
        self.weight = create_parameter(shape + self.kernel_size, weight_attr)
        self.bias = create_parameter((out_channels,), bias_attr)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in = self.in_channels // self.groups * math.prod(self.kernel_size)
        init_parameter(self.weight, self._attrs[0],
                       Normal(0.0, math.sqrt(2.0 / max(fan_in, 1))),
                       generator)
        init_parameter(self.bias, self._attrs[1], Constant(0.0), generator)


class _Conv(_ConvNd):
    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class _ConvTranspose(_ConvNd):
    _transpose = True

    def forward(self, x, output_size=None):
        return self._fn(x, self.weight, self.bias, self.stride, self.padding,
                        self.output_padding, self.groups, self.dilation,
                        output_size, self.data_format)


class Conv1D(_Conv):
    _ndim, _format = 1, "NCL"
    _fn = staticmethod(F.conv1d)


class Conv2D(_Conv):
    _ndim, _format = 2, "NCHW"
    _fn = staticmethod(F.conv2d)


class Conv3D(_Conv):
    _ndim, _format = 3, "NCDHW"
    _fn = staticmethod(F.conv3d)


class Conv1DTranspose(_ConvTranspose):
    _ndim, _format = 1, "NCL"
    _fn = staticmethod(F.conv1d_transpose)


class Conv2DTranspose(_ConvTranspose):
    _ndim, _format = 2, "NCHW"
    _fn = staticmethod(F.conv2d_transpose)


class Conv3DTranspose(_ConvTranspose):
    _ndim, _format = 3, "NCDHW"
    _fn = staticmethod(F.conv3d_transpose)
