"""Conv2D — port of ``paddle_tpu.nn.conv.Conv2D``.

OIHW ``weight`` ``[Cout, Cin/groups, kh, kw]`` (torch's layout too) drawn
from N(0, 2 / fan_in) by :meth:`reset_parameters` (at construction from
the default generator; models redraw from their explicit one), and an
optional ``bias`` (zeros); ``bias_attr=False`` means no bias.  The parameter names are the JAX package's.
"""
from __future__ import annotations

import math

import torch

from ..framework.errors import UnimplementedError
from . import functional as F
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
        if weight_attr is not None or bias_attr not in (None, False):
            raise UnimplementedError(
                "Conv2D: ParamAttr initializers are not ported yet (ROADMAP "
                "queue A, vision); pass None, or bias_attr=False")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, 2)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self.weight = torch.nn.Parameter(torch.empty(
            (out_channels, in_channels // groups) + self.kernel_size))
        self.bias = (torch.nn.Parameter(torch.empty(out_channels))
                     if bias_attr is not False else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in = self.in_channels // self.groups * math.prod(self.kernel_size)
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / max(fan_in, 1)),
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)
