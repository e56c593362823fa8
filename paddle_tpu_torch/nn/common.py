"""Common layers — ports of ``paddle_tpu.nn.common``: Linear (paddle's
``[in, out]`` weight layout), Embedding, the dropouts, Identity, Flatten /
Unflatten, the upsamplers and pads, the shuffles, Fold / Unfold,
CosineSimilarity, PairwiseDistance, Bilinear, RowConv, the legacy
BilinearTensorProduct and Pool2D.

A layer fills its parameters at construction, drawing from the CPU
generator that ``paddle_tpu_torch.seed`` reseeds, as a JAX layer draws
from the global one; a model constructor (``fills_its_layers``) skips
that and fills every layer once by :meth:`reset_parameters`, in module
order from an explicit ``torch.Generator``, so a seed fixes every
weight.  Dropout draws its keep-mask
from the per-device generator of ``framework.random``, never from torch's
global RNG.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..framework.errors import InvalidArgumentError
from ..framework.selected_rows import tap_lookup
from ..tensor._common import t as _t
from ..tensor.linalg import norm as _norm
from ..tensor.manipulation import flatten as _flatten
from .functional import activation as _A
from .functional import common as _C
from .functional.common import embedding
from .functional.extension import row_conv
from .functional.loss import cosine_similarity
from .functional.pooling import avg_pool2d, max_pool2d
from .initializer import (Constant, Normal, XavierNormal, create_parameter,
                          fill_at_construction, init_parameter)
from .layer import Layer

__all__ = [
    "Linear", "Identity", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
    "AlphaDropout", "Flatten", "Unflatten", "Upsample", "UpsamplingBilinear2D",
    "UpsamplingNearest2D", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
    "CosineSimilarity", "Bilinear", "PixelShuffle", "PixelUnshuffle",
    "ChannelShuffle", "Fold", "Unfold", "PairwiseDistance", "RowConv",
    "BilinearTensorProduct", "Pool2D",
]


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight`` ``[in_features,
    out_features]`` — paddle's layout, so parameter names and shapes match
    the JAX package 1:1.  ``weight_attr`` / ``bias_attr``: ``ParamAttr``
    (initializer, trainable, name); ``bias_attr=False``: no bias.  The
    defaults are XavierNormal and zeros."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self._attrs = (weight_attr, bias_attr)
        self.weight = create_parameter((in_features, out_features),
                                       weight_attr)
        self.bias = create_parameter((out_features,), bias_attr)
        fill_at_construction(self)

    def reset_parameters(self, generator=None):
        init_parameter(self.weight, self._attrs[0], XavierNormal(),
                       generator)
        init_parameter(self.bias, self._attrs[1], Constant(0.0), generator)

    def forward(self, x):
        y = torch.matmul(x, self.weight)
        return y if self.bias is None else y + self.bias


class Embedding(Layer):
    """Lookup table ``weight`` ``[num_embeddings, embedding_dim]``, drawn
    N(0, ``std``²) — N(0, 1) by default, as the JAX layer's
    ``Normal(0, 1)``; the models ask for 0.02 where the JAX ones pass it
    through ``weight_attr`` (a ``ParamAttr``'s initializer takes
    precedence over ``std``).  The ``padding_idx`` row is zeroed at
    build, gives zeros in the forward and gets no gradient.

    ``sparse=True`` flags the table for SelectedRows gradients: inside a
    sparse-aware train step (``hapi.Model`` builds one) the forward goes
    through :func:`~paddle_tpu_torch.framework.selected_rows.tap_lookup`
    and the table gets an O(touched-rows) ``(ids, rows)`` gradient; the
    row-mode optimizers (``Adam(lazy_mode=True)`` …) update only those
    rows.  Outside such a step the flag is inert and gradients are dense.
    CONTRACT: a sparse table gets gradients only through this lookup; any
    other read of ``weight`` (a tied head, a regularization term) trains
    it as a constant — keep ``sparse=False`` for tied tables."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *, std: float = 1.0):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = bool(sparse)
        self.std = std
        self._weight_attr = weight_attr
        self.weight = create_parameter((num_embeddings, embedding_dim),
                                       weight_attr)
        self.weight.sparse = self.sparse
        fill_at_construction(self)

    def reset_parameters(self, generator=None):
        init_parameter(self.weight, self._weight_attr, Normal(0.0, self.std),
                       generator)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0

    def forward(self, ids):
        if self.sparse:
            rows = tap_lookup(self.weight, self.weight, ids,
                              self.num_embeddings,
                              padding_idx=self.padding_idx)
            if rows is not None:
                return rows
        return embedding(ids, self.weight, padding_idx=self.padding_idx)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Dropout(Layer):
    """Dropout (:func:`~paddle_tpu_torch.nn.functional.dropout`): paddle's
    ``upscale_in_train`` by default — in training each element is kept
    with probability ``1 - p`` and scaled by ``1 / (1 - p)``, the
    keep-mask drawn from the generator of the input's device (reseeded by
    ``seed()``); identity in eval mode, which is how serving runs.
    ``axis``: the mask varies along those axes only."""

    def __init__(self, p: float = 0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return _C.dropout(x, p=self.p, axis=self.axis,
                          training=self.training, mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return _C.dropout2d(x, p=self.p, training=self.training,
                            data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return _C.dropout3d(x, p=self.p, training=self.training,
                            data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return _C.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return _flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, tuple(shape)

    def forward(self, x):
        x = _t(x)
        ax = self.axis % x.dim()
        return x.reshape(x.shape[:ax] + self.shape + x.shape[ax + 1:])


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format=None,
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return _C.interpolate(x, self.size, self.scale_factor, self.mode,
                              self.align_corners, self.align_mode,
                              self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class _PadNd(Layer):
    _n_pad = 0

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        pads = (self.padding if isinstance(self.padding, (list, tuple))
                else [self.padding] * self._n_pad)
        return _C.pad(x, pads, mode=self.mode, value=self.value,
                      data_format=self.data_format)


class Pad1D(_PadNd):
    _n_pad = 2


class Pad2D(_PadNd):
    _n_pad = 4


class Pad3D(_PadNd):
    _n_pad = 6


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    """``out[b, o] = x1[b] · weight[o] · x2[b] + bias[o]``; ``weight``
    ``[out, in1, in2]`` (XavierNormal), ``bias`` ``[out]`` (zeros)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self._attrs = (weight_attr, bias_attr)
        self.weight = create_parameter(
            (out_features, in1_features, in2_features), weight_attr)
        self.bias = create_parameter((out_features,), bias_attr)
        fill_at_construction(self)

    def reset_parameters(self, generator=None):
        init_parameter(self.weight, self._attrs[0], XavierNormal(),
                       generator)
        init_parameter(self.bias, self._attrs[1], Constant(0.0), generator)

    def forward(self, x1, x2):
        return _C.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return _C.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return _C.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return _C.channel_shuffle(x, self.groups, self.data_format)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return _C.fold(x, *self.args)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return _C.unfold(x, *self.args)


class PairwiseDistance(Layer):
    """The ``p``-norm of ``x - y + epsilon`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        x = _t(x)
        d = x - _t(y, x) + self.epsilon
        return _norm(d, p=self.p, axis=-1, keepdim=self.keepdim)


class RowConv(Layer):
    """Lookahead row convolution; ``weight`` ``[future_context_size + 1,
    num_channels]`` (XavierNormal)."""

    def __init__(self, num_channels, future_context_size, activation=None,
                 param_attr=None, name=None):
        super().__init__()
        self.activation = activation
        self._attr = param_attr
        self.weight = create_parameter(
            (future_context_size + 1, num_channels), param_attr)
        fill_at_construction(self)

    def reset_parameters(self, generator=None):
        init_parameter(self.weight, self._attr, XavierNormal(), generator)

    def forward(self, x):
        return row_conv(x, self.weight, act=self.activation)


class BilinearTensorProduct(Layer):
    """The 1.x bilinear layer: ``act(x · weight[o] · y + bias[0, o])``;
    ``weight`` ``[output_dim, input1_dim, input2_dim]``, ``bias`` ``[1,
    output_dim]``."""

    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None):
        super().__init__()
        self.act = act
        self._attrs = (param_attr, bias_attr)
        self.weight = create_parameter(
            (output_dim, input1_dim, input2_dim), param_attr)
        self.bias = create_parameter((1, output_dim), bias_attr)
        fill_at_construction(self)

    def reset_parameters(self, generator=None):
        init_parameter(self.weight, self._attrs[0], XavierNormal(),
                       generator)
        init_parameter(self.bias, self._attrs[1], Constant(0.0), generator)

    def forward(self, x, y):
        out = _C.bilinear(x, y, self.weight, self.bias)
        return getattr(_A, self.act)(out) if self.act else out


class Pool2D(Layer):
    """The 1.x pooling layer: ``global_pooling`` (max or mean over the
    spatial axes, kept), else ``max_pool2d`` or ``avg_pool2d`` with the
    layer's ``exclusive`` and ``ceil_mode``."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True, data_format="NCHW"):
        super().__init__()
        if pool_type not in ("max", "avg"):
            raise InvalidArgumentError(
                f"pool_type must be 'max' or 'avg', got {pool_type!r}")
        if not global_pooling and pool_size == -1:
            raise InvalidArgumentError(
                "Pool2D: pool_size must be set when global_pooling is "
                "False (the -1 default only makes sense with "
                "global_pooling=True)")
        self.pool_size, self.pool_type = pool_size, pool_type
        self.pool_stride, self.pool_padding = pool_stride, pool_padding
        self.global_pooling, self.ceil_mode = global_pooling, ceil_mode
        self.exclusive, self.data_format = exclusive, data_format

    def forward(self, x):
        x = _t(x)
        if self.global_pooling:
            axes = (2, 3) if self.data_format == "NCHW" else (1, 2)
            if self.pool_type == "max":
                return x.amax(axes, keepdim=True)
            return x.mean(axes, keepdim=True)
        if self.pool_type == "max":
            return max_pool2d(x, self.pool_size, stride=self.pool_stride,
                              padding=self.pool_padding,
                              ceil_mode=self.ceil_mode,
                              data_format=self.data_format)
        return avg_pool2d(x, self.pool_size, stride=self.pool_stride,
                          padding=self.pool_padding, ceil_mode=self.ceil_mode,
                          exclusive=self.exclusive,
                          data_format=self.data_format)
