"""Norm layers — ports of ``paddle_tpu.nn.norm``: ``LayerNorm``, the
batch norms (``BatchNorm``, ``BatchNorm1D/2D/3D``), ``GroupNorm``,
``InstanceNorm1D/2D/3D``, ``LocalResponseNorm`` and ``SpectralNorm``.

A batch norm holds ``weight`` (ones) and ``bias`` (zeros) and the running
statistics as buffers named ``_mean`` (zeros) and ``_variance`` (ones),
float32 until ``astype`` casts them, as in the JAX package, so the bridge
maps them 1:1.  In training the layer writes the statistics that
:func:`~paddle_tpu_torch.nn.functional.batch_norm` returns back into its
buffers in place (rounded to the buffers' dtype); the JAX package assigns
them functionally.  ``weight_attr`` / ``bias_attr`` are ``ParamAttr`` objects
(initializer, trainable, name), ``False`` for none.  ``SyncBatchNorm``
raises: it comes with distributed execution (ROADMAP queue A).

``SpectralNorm`` keeps its power-iteration vectors in the non-persistent
buffers ``weight_u`` ``[h]`` and ``weight_v`` ``[w]``, as in the JAX
package, drawn N(0, 1) from CPU generators seeded 0 and 1 (the JAX layer
uses ``PRNGKey(0)`` and ``PRNGKey(1)``: the same role, other numbers).
Each training call iterates from them and stores the new vectors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.errors import UnimplementedError
from ..tensor._common import t as _t
from . import functional as PF
from .functional import activation as _A
from .functional import norm as _N
from .initializer import (Constant, create_parameter, fill_at_construction,
                          init_parameter)
from .layer import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
    "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
]


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
    """The legacy ``fluid.dygraph.BatchNorm`` surface: ``act`` names a
    function of ``nn.functional``'s activations."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 data_format="NCHW", weight_attr=None, bias_attr=None,
                 **kwargs):
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon,
                         weight_attr=weight_attr, bias_attr=bias_attr,
                         data_format=data_format)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(_A, self._act)(out) if self._act else out


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


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm: comes with distributed execution (ROADMAP
    queue A) and raises until then."""

    def __init__(self, *args, **kwargs):
        raise UnimplementedError(
            "SyncBatchNorm is not ported yet (ROADMAP queue A, distributed "
            "execution)")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise UnimplementedError(
            "SyncBatchNorm.convert_sync_batchnorm is not ported yet (ROADMAP "
            "queue A, distributed execution)")


class _Affine(Layer):
    """A per-channel ``weight`` (ones) and ``bias`` (zeros) of
    ``num_features``."""

    def __init__(self, num_features, weight_attr, bias_attr):
        super().__init__()
        self._attrs = (weight_attr, bias_attr)
        self.weight = create_parameter((num_features,), weight_attr)
        self.bias = create_parameter((num_features,), bias_attr)
        fill_at_construction(self)

    def reset_parameters(self, generator=None):
        init_parameter(self.weight, self._attrs[0], Constant(1.0), generator)
        init_parameter(self.bias, self._attrs[1], Constant(0.0), generator)


class GroupNorm(_Affine):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__(num_channels, weight_attr, bias_attr)
        self.num_groups, self.num_channels = num_groups, num_channels
        self.epsilon, self.data_format = epsilon, data_format

    def forward(self, x):
        return _N.group_norm(x, self.num_groups, self.epsilon, self.weight,
                             self.bias, self.data_format)


class _InstanceNormBase(_Affine):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__(num_features, weight_attr, bias_attr)
        self.num_features, self.epsilon = num_features, epsilon
        self.data_format = data_format

    def forward(self, x):
        return _N.instance_norm(x, weight=self.weight, bias=self.bias,
                                eps=self.epsilon,
                                data_format=self.data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return _N.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """``weight / σ``, σ the largest singular value of ``weight`` with
    ``dim`` moved first and the rest flattened, estimated by
    ``power_iters`` power iterations from the stored vectors (module
    docstring)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        self.dim, self.power_iters, self.eps = dim, power_iters, eps
        h = int(weight_shape[dim])
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= int(s)
        self.register_buffer("weight_u", torch.randn(
            h, generator=torch.Generator().manual_seed(0)), persistent=False)
        self.register_buffer("weight_v", torch.randn(
            w, generator=torch.Generator().manual_seed(1)), persistent=False)

    def forward(self, weight):
        weight = _t(weight)
        mat = weight.movedim(self.dim, 0).reshape(weight.shape[self.dim], -1)
        u = self.weight_u.to(mat.dtype, copy=True)
        v = self.weight_v.to(mat.dtype, copy=True)
        for _ in range(self.power_iters):
            v = mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + self.eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self.eps)
        sigma = u @ mat @ v
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return weight / sigma
