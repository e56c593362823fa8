"""LeNet — port of ``paddle_tpu/vision/models/lenet.py`` (the MNIST
model: 1 x 28 x 28 input), with the JAX module tree and names."""
from __future__ import annotations

from typing import Optional

import torch

from ... import nn
from ...nn.initializer import fills_its_layers
from .resnet import _materialize

__all__ = ["LeNet"]


class LeNet(nn.Layer):
    """``device`` (None = the card) and ``generator`` as ``ResNet``'s."""

    @fills_its_layers
    def __init__(self, num_classes=10, data_format="NCHW", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.data_format = data_format
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, data_format=data_format),
            nn.ReLU(),
            nn.MaxPool2D(2, 2, data_format=data_format),
            nn.Conv2D(6, 16, 5, stride=1, padding=0,
                      data_format=data_format),
            nn.ReLU(),
            nn.MaxPool2D(2, 2, data_format=data_format),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120),
                nn.Linear(120, 84),
                nn.Linear(84, num_classes),
            )
        _materialize(self, device, generator)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            if self.data_format == "NHWC":
                x = x.permute(0, 3, 1, 2)
            x = x.reshape(x.shape[0], -1)
            x = self.fc(x)
        return x
