"""Containers — ports of ``paddle_tpu.nn.container``: ``Sequential``,
``LayerList``, ``LayerDict`` and ``ParameterList``.  Children are named as
in the JAX package — ``"0"``, ``"1"``, … (a ``Sequential`` also by the
names of an ``OrderedDict`` or of ``(name, layer)`` tuples), a
``LayerDict`` by its keys — so dotted names such as ``layers.3.linear1
.weight`` match the JAX package's."""
from __future__ import annotations

from collections import OrderedDict

import torch

from .layer import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


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

    def __setitem__(self, idx, layer):
        self._modules[list(self._modules)[idx]] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    """A list of layers named ``"0"``, ``"1"``, …; ``insert`` renumbers
    them."""

    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx % len(self) if idx < 0 else idx)]

    def __setitem__(self, idx, layer):
        self._modules[str(idx)] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_module(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self._modules[str(i)] = sub
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class LayerDict(Layer):
    """Layers by key, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_module(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        if isinstance(sublayers, dict):
            sublayers = sublayers.items()
        for key, layer in sublayers:
            self.add_module(key, layer)
        return self


def _as_parameter(p):
    from .layer import Parameter

    if isinstance(p, Parameter):
        return p
    return Parameter(torch.as_tensor(p),
                     trainable=getattr(p, "requires_grad", True))


class ParameterList(Layer):
    """Parameters named ``"0"``, ``"1"``, …; a tensor or array given is
    wrapped as a parameter."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def __getitem__(self, idx):
        return self._parameters[str(idx % len(self) if idx < 0 else idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.register_parameter(str(len(self)), _as_parameter(parameter))
        return self
