"""Norm layers — ports of ``paddle_tpu.nn.norm``'s ``LayerNorm`` and the
batch norms (``BatchNorm``, ``BatchNorm1D/2D/3D``).

A batch norm holds ``weight`` (ones) and ``bias`` (zeros) and the running
statistics as buffers named ``_mean`` (zeros) and ``_variance`` (ones),
float32 until ``astype`` casts them, as in the JAX package, so the bridge
maps them 1:1.  In training the layer writes the statistics that
:func:`~paddle_tpu_torch.nn.functional.batch_norm` returns back into its
buffers in place (rounded to the buffers' dtype); the JAX package assigns
them functionally.  ``SyncBatchNorm`` is not ported yet (ROADMAP queue
A6, distributed execution).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.errors import UnimplementedError
from . import functional as PF
from .layer import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D"]


class LayerNorm(Layer):
    """Normalizes over the last dim; ``weight`` ones, ``bias`` zeros."""

    def __init__(self, normalized_shape: int, epsilon: float = 1e-5):
        super().__init__()
        self.normalized_shape = (int(normalized_shape),)
        self.epsilon = float(epsilon)
        self.weight = torch.nn.Parameter(torch.empty(self.normalized_shape))
        self.bias = torch.nn.Parameter(torch.empty(self.normalized_shape))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None, False):
            raise UnimplementedError(
                "BatchNorm: ParamAttr initializers are not ported yet "
                "(ROADMAP queue A, vision); pass None, or False for none")
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = (torch.nn.Parameter(torch.empty(num_features))
                       if weight_attr is not False else None)
        self.bias = (torch.nn.Parameter(torch.empty(num_features))
                     if bias_attr is not False else None)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()
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
                 data_format="NCHW", **kwargs):
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon,
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
