"""Sequential — port of ``paddle_tpu.nn.container.Sequential``: children
are named ``"0"``, ``"1"``, … (or by the names of an ``OrderedDict`` or of
``(name, layer)`` tuples), so dotted names such as
``downsample.0.weight`` match the JAX package's."""
from __future__ import annotations

from collections import OrderedDict

from .layer import Layer

__all__ = ["Sequential"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            items = list(layers[0].items())
        else:
            items = [layer if isinstance(layer, tuple) else (str(i), layer)
                     for i, layer in enumerate(layers)]
        for name, layer in items:
            self.add_module(name, layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x
