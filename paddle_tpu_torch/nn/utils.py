"""Weight normalization — port of ``paddle_tpu.nn.utils``:
``weight_norm``, ``remove_weight_norm`` and the ``WeightNorm`` hook.

``weight_norm(layer, "weight", dim)`` reparameterizes ``layer.weight`` as
``g · v / ‖v‖`` (the norm over every axis but ``dim``; ``dim=None``: over
all): the trainable parameters ``weight_g`` and ``weight_v`` (the JAX
package's names), and ``weight`` itself becomes a derived tensor the
forward pre-hook recomputes from them on every call, so gradients reach g
and v.  In the JAX package ``weight`` stays a non-trainable parameter; here
it is a buffer of the same name (no optimizer takes it, and
``state_dict`` lists it).  ``remove_weight_norm`` folds ``g · v / ‖v‖``
back into one trainable ``weight``.
"""
from __future__ import annotations

import torch

from ..framework.errors import InvalidArgumentError
from .layer import Layer, Parameter

__all__ = ["weight_norm", "remove_weight_norm", "WeightNorm"]


def _norm_except_dim(v, dim):
    if dim == -1:
        return torch.sqrt((v * v).sum() + 1e-12)
    moved = v.movedim(dim, 0).reshape(v.shape[dim], -1)
    return torch.sqrt((moved * moved).sum(1) + 1e-12)


def _weight_from_gv(g, v, dim):
    if dim == -1:
        return v / (torch.sqrt((v * v).sum()) + 1e-12) * g
    shape = [1] * v.dim()
    shape[dim] = v.shape[dim]
    return v / _norm_except_dim(v, dim).reshape(shape) * g.reshape(shape)


class WeightNorm:
    """The forward pre-hook that recomputes ``layer.<name>``."""

    def __init__(self, name, dim):
        self.name = name
        self.dim = -1 if dim is None else dim
        self._handle = None

    def compute_weight(self, layer):
        return _weight_from_gv(layer._parameters[self.name + "_g"],
                               layer._parameters[self.name + "_v"], self.dim)

    @staticmethod
    def apply(layer: Layer, name: str, dim):
        for hook in layer._forward_pre_hooks.values():
            if isinstance(hook, WeightNorm) and hook.name == name:
                raise InvalidArgumentError(
                    f"weight_norm already registered on parameter {name!r}")
        w = layer._parameters.get(name)
        if w is None:
            raise InvalidArgumentError(
                f"{type(layer).__name__} has no parameter {name!r}")
        ndim = w.dim()
        if dim is None:
            dim = -1
        if not -ndim <= dim < ndim:
            raise InvalidArgumentError(
                f"dim must be in [-{ndim}, {ndim}), got {dim}")
        if dim != -1:
            dim %= ndim
        fn = WeightNorm(name, dim)
        with torch.no_grad():
            v = Parameter(w.detach().clone())
            g = Parameter(_norm_except_dim(w.detach(), dim))
        del layer._parameters[name]
        layer.register_parameter(name + "_v", v)
        layer.register_parameter(name + "_g", g)
        with torch.no_grad():
            layer.register_buffer(name, fn.compute_weight(layer))
        fn._handle = layer.register_forward_pre_hook(fn)
        return fn

    def remove(self, layer: Layer):
        with torch.no_grad():
            w = self.compute_weight(layer)
        del layer._buffers[self.name]
        del layer._parameters[self.name + "_g"]
        del layer._parameters[self.name + "_v"]
        layer.register_parameter(self.name, Parameter(w))
        self._handle.remove()

    def __call__(self, layer, inputs):
        layer._buffers[self.name] = self.compute_weight(layer)


def weight_norm(layer: Layer, name: str = "weight", dim: int = 0):
    """Apply weight normalization to ``layer.<name>``; returns the
    layer."""
    WeightNorm.apply(layer, name, dim)
    return layer


def remove_weight_norm(layer: Layer, name: str = "weight"):
    """Undo :func:`weight_norm`; returns the layer."""
    for hook in list(layer._forward_pre_hooks.values()):
        if isinstance(hook, WeightNorm) and hook.name == name:
            hook.remove(layer)
            return layer
    raise InvalidArgumentError(
        f"weight_norm of {name!r} not found in {type(layer).__name__}")
