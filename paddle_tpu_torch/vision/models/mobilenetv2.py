"""MobileNetV2 — port of ``paddle_tpu/vision/models/mobilenetv2.py``, with
the JAX module tree and names (``data_format="NHWC"`` keeps the same
state dict)."""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ... import nn
from ...nn.initializer import fills_its_layers
from .resnet import _materialize, _pretrained

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_planes, out_planes, kernel_size=3, stride=1,
                 groups=1, norm_layer=nn.BatchNorm2D, data_format="NCHW"):
        padding = (kernel_size - 1) // 2
        super().__init__(
            nn.Conv2D(in_planes, out_planes, kernel_size, stride=stride,
                      padding=padding, groups=groups, bias_attr=False,
                      data_format=data_format),
            norm_layer(out_planes),
            nn.ReLU6(),
        )


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio,
                 norm_layer=nn.BatchNorm2D, data_format="NCHW"):
        super().__init__()
        self.stride = stride
        assert stride in (1, 2)
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden_dim, kernel_size=1,
                                     norm_layer=norm_layer,
                                     data_format=data_format))
        layers.extend([
            ConvBNReLU(hidden_dim, hidden_dim, stride=stride,
                       groups=hidden_dim, norm_layer=norm_layer,
                       data_format=data_format),
            nn.Conv2D(hidden_dim, oup, 1, bias_attr=False,
                      data_format=data_format),
            norm_layer(oup),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(nn.Layer):
    """``device`` (None = the card) and ``generator`` as ``ResNet``'s."""

    @fills_its_layers
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 data_format="NCHW", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = 32
        last_channel = 1280
        norm_layer = functools.partial(nn.BatchNorm2D,
                                       data_format=data_format)
        # t (expand), c (channels), n (repeats), s (stride)
        inverted_residual_setting = [
            [1, 16, 1, 1],
            [6, 24, 2, 2],
            [6, 32, 3, 2],
            [6, 64, 4, 2],
            [6, 96, 3, 1],
            [6, 160, 3, 2],
            [6, 320, 1, 1],
        ]
        input_channel = _make_divisible(input_channel * scale)
        self.last_channel = _make_divisible(last_channel * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2,
                               norm_layer=norm_layer,
                               data_format=data_format)]
        for t, c, n, s in inverted_residual_setting:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, output_channel, s if i == 0 else 1,
                    expand_ratio=t, norm_layer=norm_layer,
                    data_format=data_format))
                input_channel = output_channel
        features.append(ConvBNReLU(input_channel, self.last_channel,
                                   kernel_size=1, norm_layer=norm_layer,
                                   data_format=data_format))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D((1, 1),
                                                   data_format=data_format)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2),
                nn.Linear(self.last_channel, num_classes),
            )
        _materialize(self, device, generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = self.classifier(x)
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return _pretrained(MobileNetV2, pretrained, dict(kwargs, scale=scale))
