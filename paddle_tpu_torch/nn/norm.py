"""Norm layers — ports of ``paddle_tpu.nn.norm``'s ``LayerNorm`` and the
batch norms (``BatchNorm``, ``BatchNorm1D/2D/3D``).

A batch norm holds ``weight`` (ones) and ``bias`` (zeros) and the running
statistics as buffers named ``_mean`` (zeros) and ``_variance`` (ones),
float32 until ``astype`` casts them, as in the JAX package, so the bridge
maps them 1:1.  In training the layer writes the statistics that
:func:`~paddle_tpu_torch.nn.functional.batch_norm` returns back into its
buffers in place (rounded to the buffers' dtype); the JAX package assigns
them functionally.  ``weight_attr`` / ``bias_attr`` are ``ParamAttr`` objects
(initializer, trainable, name), ``False`` for none.  ``SyncBatchNorm`` is
not ported yet (ROADMAP queue A, distributed execution).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.errors import UnimplementedError
from . import functional as PF
from .initializer import (Constant, create_parameter, fill_at_construction,
                          init_parameter)
from .layer import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D"]


class LayerNorm(Layer):
    """Normalizes over the trailing ``normalized_shape`` dims; ``weight``
    ones, ``bias`` zeros (either ``False``: none)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(d) for d in normalized_shape)
        self.epsilon = float(epsilon)
        self._attrs = (weight_attr, bias_attr)
        self.weight = create_parameter(self.normalized_shape, weight_attr)
        self.bias = create_parameter(self.normalized_shape, bias_attr)
        fill_at_construction(self)

    def reset_parameters(self, generator=None):
        init_parameter(self.weight, self._attrs[0], Constant(1.0), generator)
        init_parameter(self.bias, self._attrs[1], Constant(0.0), generator)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self._attrs = (weight_attr, bias_attr)
        self.weight = create_parameter((num_features,), weight_attr)
        self.bias = create_parameter((num_features,), bias_attr)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        init_parameter(self.weight, self._attrs[0], Constant(1.0), generator)
        init_parameter(self.bias, self._attrs[1], Constant(0.0), generator)
        with torch.no_grad():
            self._mean.zero_()
            self._variance.fill_(1.0)

    def forward(self, x):
        out = PF.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats)
        if isinstance(out, tuple):
            out, new_mean, new_var = out
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return out


class BatchNorm(_BatchNormBase):
    """The legacy ``fluid.dygraph.BatchNorm`` surface (``act=None`` or
    ``"relu"``)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 data_format="NCHW", weight_attr=None, bias_attr=None,
                 **kwargs):
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon,
                         weight_attr=weight_attr, bias_attr=bias_attr,
                         data_format=data_format)
        if act not in (None, "relu"):
            raise UnimplementedError(
                f"BatchNorm(act={act!r}): only None and 'relu' are ported")
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return torch.relu(out) if self._act == "relu" else out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)
