"""VGG family — port of ``paddle_tpu/vision/models/vgg.py``, with the JAX
module tree and names.  ``data_format="NHWC"`` keeps the same state dict:
the classifier sees NCHW-ordered features (one transpose before the
flatten)."""
from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.initializer import fills_its_layers
from .resnet import _materialize, _pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]


class VGG(nn.Layer):
    """``features`` is the conv trunk built by :func:`make_layers`;
    ``device`` (None = the card) and ``generator`` as ``ResNet``'s."""

    @fills_its_layers
    def __init__(self, features, num_classes=1000, data_format="NCHW",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.data_format = data_format
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, num_classes),
            )
        _materialize(self, device, generator)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            if self.data_format == "NHWC":
                x = x.permute(0, 3, 1, 2)
            x = x.reshape(x.shape[0], -1)
            x = self.classifier(x)
        return x


def make_layers(cfg, batch_norm=False, data_format="NCHW"):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2,
                                       data_format=data_format))
        else:
            layers.append(nn.Conv2D(in_channels, v, 3, padding=1,
                                    data_format=data_format))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, data_format=data_format))
            layers.append(nn.ReLU())
            in_channels = v
    return nn.Sequential(*layers)


_cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


@fills_its_layers
def _vgg(arch, cfg, batch_norm, pretrained, **kwargs):
    def build(**kw):
        return VGG(make_layers(_cfgs[cfg], batch_norm=batch_norm,
                               data_format=kw.get("data_format", "NCHW")),
                   **kw)

    return _pretrained(build, pretrained, kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg11", "A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg13", "B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg16", "D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg19", "E", batch_norm, pretrained, **kwargs)
