"""Basic layers: Linear (paddle's ``[in, out]`` weight layout), Embedding,
Dropout — ports of ``paddle_tpu.nn.common``.

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

from ..framework.random import generator_for
from ..framework.selected_rows import tap_lookup
from .functional.common import embedding
from .initializer import (Constant, Normal, XavierNormal, create_parameter,
                          fill_at_construction, init_parameter)
from .layer import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


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


class Dropout(Layer):
    """Upscale-in-train dropout (paddle's default mode): in training each
    element is kept with probability ``1 - p`` and scaled by
    ``1 / (1 - p)``, the keep-mask drawn from the generator of the input's
    device (:func:`~paddle_tpu_torch.framework.random.generator_for`,
    reseeded by ``seed()``).  Identity in eval mode, which is how serving
    runs."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = torch.empty_like(x).bernoulli_(
            1.0 - self.p, generator=generator_for(x.device))
        return x * keep / (1.0 - self.p)
