"""MobileNetV1 — port of ``paddle_tpu/vision/models/mobilenetv1.py``, with
the JAX module tree and names.  The depthwise convolutions are grouped
``Conv2D`` layers (cuDNN's on the card)."""
from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.initializer import fills_its_layers
from .resnet import _materialize, _pretrained

__all__ = ["MobileNetV1", "mobilenet_v1"]


class ConvBNLayer(nn.Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, num_groups=1, data_format="NCHW"):
        super().__init__()
        self._conv = nn.Conv2D(in_channels, out_channels, kernel_size,
                               stride=stride, padding=padding,
                               groups=num_groups, bias_attr=False,
                               data_format=data_format)
        self._norm_layer = nn.BatchNorm2D(out_channels,
                                          data_format=data_format)
        self._act = nn.ReLU()

    def forward(self, x):
        return self._act(self._norm_layer(self._conv(x)))


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale, data_format="NCHW"):
        super().__init__()
        self._depthwise_conv = ConvBNLayer(
            in_channels, int(out_channels1 * scale), 3, stride=stride,
            padding=1, num_groups=int(num_groups * scale),
            data_format=data_format)
        self._pointwise_conv = ConvBNLayer(
            int(out_channels1 * scale), int(out_channels2 * scale), 1,
            stride=1, padding=0, data_format=data_format)

    def forward(self, x):
        return self._pointwise_conv(self._depthwise_conv(x))


class MobileNetV1(nn.Layer):
    """``device`` (None = the card) and ``generator`` as ``ResNet``'s."""

    @fills_its_layers
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 data_format="NCHW", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1,
                                 data_format=data_format)
        # (in, out1, out2, groups, stride) per depthwise-separable stage
        cfg = [
            (32, 32, 64, 32, 1),
            (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1),
            (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1),
            (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1),
            (512, 512, 1024, 512, 2),
            (1024, 1024, 1024, 1024, 1),
        ]
        self.dwsl = nn.LayerList([
            DepthwiseSeparable(int(in_c * scale), out1, out2, groups,
                               stride, scale, data_format=data_format)
            for in_c, out1, out2, groups, stride in cfg])
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D((1, 1),
                                                   data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)
        _materialize(self, device, generator)

    def forward(self, x):
        x = self.conv1(x)
        for block in self.dwsl:
            x = block(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return _pretrained(MobileNetV1, pretrained, dict(kwargs, scale=scale))
