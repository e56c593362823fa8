"""paddle.fluid.dygraph — the 1.x imperative API (port of
``paddle_tpu.fluid.dygraph``).

``guard`` / ``enabled``, ``save_dygraph`` / ``load_dygraph`` (the
checkpoint format of both packages) and the 1.x layers with their 1.x
constructor arguments and ``act=`` activations, as thin adapters over the
port's 2.0 layers: ``Linear``, ``Conv2D``, ``BatchNorm``, ``Embedding``,
``LayerNorm``, ``Dropout``, ``PRelu``, ``GRUUnit`` (the fused 1.x GRU step,
``origin_mode`` swapping the update formula) and ``NCE`` (uniform
negatives from the device generator, or an ``nn.rng_scope``).  The
jit names are the port's ``jit`` (``declarative`` is ``jit.to_static``,
``ProgramTranslator``, ``TracedLayer``); ``no_grad`` / ``grad`` /
``to_variable`` raise ``UnimplementedError`` naming their ROADMAP
queue-A item; the data-parallel names are ``distributed``'s
``DataParallel``, ``ParallelEnv`` and ``prepare_context``.
"""
from __future__ import annotations

import contextlib
import os

import torch

from ... import nn as _nn
from ...framework.errors import UnimplementedError
from ...framework.random import generator_for
from ...framework.serialization import load as _load, save as _save
from ...nn import (BilinearTensorProduct, Layer, LayerList,  # noqa: F401
                   ParameterList, Pool2D, Sequential)
from ...nn import functional as _F
from ...static.builders import unported as _unported

__all__ = [
    "Layer", "guard", "to_variable", "no_grad", "grad", "enabled",
    "Linear", "Conv2D", "Pool2D", "BatchNorm", "Embedding", "LayerNorm",
    "Dropout", "GRUUnit", "PRelu", "BilinearTensorProduct", "NCE",
    "Sequential", "ParameterList", "LayerList", "DataParallel",
    "ParallelEnv", "prepare_context", "save_dygraph", "load_dygraph",
    "declarative", "ProgramTranslator", "TracedLayer",
]

from ... import jit  # noqa: E402,F401
from ...jit import ProgramTranslator, TracedLayer  # noqa: E402,F401
from ...jit import to_static as declarative  # noqa: E402,F401

_ITEM8 = "static graph and the long tail"
no_grad = _unported("fluid.dygraph.no_grad", _ITEM8)
grad = _unported("fluid.dygraph.grad", _ITEM8)
to_variable = _unported("fluid.dygraph.to_variable", _ITEM8)
from ...distributed import (DataParallel, ParallelEnv,  # noqa: E402
                            prepare_context)


@contextlib.contextmanager
def guard(place=None):
    """1.x dygraph scope: eager is the only mode, so this only pins the
    default device when ``place`` is given."""
    if place is not None:
        from ...framework.device import place_device, set_device

        set_device(place_device(place))
    yield


def enabled():
    """Always True (one runtime)."""
    return True


_OPT_SLOT_SUFFIXES = (".moment", ".moment1", ".moment2", ".master",
                      ".squared", ".linear", ".velocity", ".inf_norm",
                      ".mean_square", ".mean_grad", ".avg_squared_grad",
                      ".avg_squared_update")


def save_dygraph(state_dict, model_path):
    """Write ``state_dict`` to ``model_path`` + ``.pdopt`` when it is an
    optimizer's (a step ``count``, ``LR_Scheduler``, slot keys or non-array
    values), else + ``.pdparams``."""
    is_opt = ("count" in state_dict or "LR_Scheduler" in state_dict
              or any(k.endswith(_OPT_SLOT_SUFFIXES) for k in state_dict)
              or any(not hasattr(v, "shape") for v in state_dict.values()))
    return _save(state_dict, model_path + (".pdopt" if is_opt
                                           else ".pdparams"))


def load_dygraph(model_path, **configs):
    """``(param_dict, opt_dict)`` from ``model_path`` + ``.pdparams`` /
    ``.pdopt``; either is None when its file is missing."""
    params = opt = None
    if os.path.exists(model_path + ".pdparams"):
        params = _load(model_path + ".pdparams")
    if os.path.exists(model_path + ".pdopt"):
        opt = _load(model_path + ".pdopt")
    if params is None and opt is None:
        raise ValueError(
            f"no .pdparams/.pdopt found for prefix {model_path!r}")
    return params, opt


def _activate(out, act):
    return getattr(_F, act)(out) if act else out


class Linear(Layer):
    """1.x ``Linear(input_dim, output_dim, act=)`` over ``nn.Linear``."""

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        self._act = act
        self._linear = _nn.Linear(input_dim, output_dim,
                                  weight_attr=param_attr,
                                  bias_attr=bias_attr)
        self.weight = self._linear.weight
        self.bias = self._linear.bias

    def forward(self, input):
        return _activate(self._linear(input), self._act)


class Conv2D(Layer):
    """1.x ``Conv2D(num_channels, num_filters, filter_size, ..., act=)``."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=None, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype="float32"):
        super().__init__()
        self._act = act
        self._conv = _nn.Conv2D(num_channels, num_filters, filter_size,
                                stride=stride, padding=padding,
                                dilation=dilation, groups=groups or 1,
                                weight_attr=param_attr, bias_attr=bias_attr)
        self.weight = self._conv.weight
        self.bias = self._conv.bias

    def forward(self, input):
        return _activate(self._conv(input), self._act)


class BatchNorm(Layer):
    """1.x ``BatchNorm(num_channels, act=, is_test=, momentum=, ...)``
    (paddle's running-statistics convention: new = m·old + (1-m)·batch)."""

    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", data_layout="NCHW", in_place=False,
                 moving_mean_name=None, moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__()
        self._act = act
        self._bn = _nn.BatchNorm(num_channels, momentum=momentum,
                                 epsilon=epsilon, weight_attr=param_attr,
                                 bias_attr=bias_attr,
                                 data_format=data_layout,
                                 use_global_stats=use_global_stats)
        self.weight = self._bn.weight
        self.bias = self._bn.bias
        if is_test:
            self.eval()

    def forward(self, input):
        return _activate(self._bn(input), self._act)


class Embedding(Layer):
    """1.x ``Embedding(size=[vocab, dim], padding_idx=, ...)``."""

    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__()
        if is_distributed:
            raise UnimplementedError(
                "is_distributed embeddings: use "
                "paddle.distributed.meta_parallel.VocabParallelEmbedding "
                "(sharded tables replace the parameter server)")
        self._emb = _nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                                  weight_attr=param_attr)
        self.weight = self._emb.weight

    def forward(self, input):
        return self._emb(input)


class LayerNorm(Layer):
    """1.x ``LayerNorm(normalized_shape, scale=, shift=, act=)``."""

    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__()
        self._act = act
        self._ln = _nn.LayerNorm(normalized_shape, epsilon=epsilon,
                                 weight_attr=param_attr if scale else False,
                                 bias_attr=bias_attr if shift else False)

    def forward(self, input):
        return _activate(self._ln(input), self._act)


class Dropout(Layer):
    """1.x ``Dropout(p, dropout_implementation=)``:
    ``downgrade_in_infer`` (the default) or ``upscale_in_train``."""

    def __init__(self, p=0.5, seed=None,
                 dropout_implementation="downgrade_in_infer", is_test=False):
        super().__init__()
        self._mode = ("downscale_in_infer"
                      if dropout_implementation == "downgrade_in_infer"
                      else "upscale_in_train")
        self._p = p
        if is_test:
            self.eval()

    def forward(self, input):
        return _F.dropout(input, p=self._p, training=self.training,
                          mode=self._mode)


class PRelu(Layer):
    """1.x ``PRelu(mode)``: one slope (``all``), one a channel
    (``channel``) or one an element (``element``, needs
    ``input_shape``)."""

    def __init__(self, mode, channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        super().__init__()
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            if channel is None:
                raise ValueError("channel mode needs `channel`")
            shape = [channel]
        elif mode == "element":
            if input_shape is None:
                raise ValueError("element mode needs `input_shape`")
            shape = list(input_shape)[1:]
        else:
            raise ValueError(f"unknown PRelu mode {mode!r}")
        self.weight = self.create_parameter(
            shape, attr=param_attr,
            default_initializer=_nn.initializer.Constant(0.25))
        self._mode = mode

    def forward(self, input):
        a = self.weight
        if self._mode == "channel" and input.dim() > 2:
            a = a.reshape((1, -1) + (1,) * (input.dim() - 2))
        return torch.where(input > 0, input, a * input)


class GRUUnit(Layer):
    """1.x ``GRUUnit(size)``: one GRU step over the pre-projected input
    ``[B, 3·hidden]`` (size = 3 × hidden) with the fused 1.x layout —
    weight ``[hidden, 3·hidden]`` (update | reset gates, then the
    candidate), bias ``[1, 3·hidden]``.  Returns ``(new_hidden,
    reset_hidden_prev, gate)``."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__()
        hidden = size // 3
        self._hidden = hidden
        self._origin_mode = origin_mode
        self._act = activation
        self._gate_act = gate_activation
        self.weight = self.create_parameter([hidden, 3 * hidden],
                                            attr=param_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([1, 3 * hidden], attr=bias_attr,
                                           is_bias=True))

    def _cell(self, input, hidden):
        H = self._hidden
        gates = input[:, :2 * H] + hidden @ self.weight[:, :2 * H]
        if self.bias is not None:
            gates = gates + self.bias[0, :2 * H]
        u, r = torch.chunk(getattr(_F, self._gate_act)(gates), 2, dim=-1)
        rhp = r * hidden
        c = input[:, 2 * H:] + rhp @ self.weight[:, 2 * H:]
        if self.bias is not None:
            c = c + self.bias[0, 2 * H:]
        c = getattr(_F, self._act)(c)
        if self._origin_mode:
            new_h = u * hidden + (1 - u) * c
        else:
            new_h = (1 - u) * hidden + u * c
        return new_h, u, r, rhp, c

    def forward(self, input, hidden):
        new_h, u, r, rhp, c = self._cell(input, hidden)
        return new_h, rhp, torch.cat([u, r, c], dim=-1)

    def step(self, input, hidden):
        """The new hidden state alone (``dynamic_gru``'s step: no gate
        concat)."""
        return self._cell(input, hidden)[0]


class NCE(Layer):
    """1.x ``NCE`` loss head: the ``[num_total_classes, dim]`` table and
    ``[num_total_classes, 1]`` bias; the forward scores the label against
    ``num_neg_samples`` uniform negatives (drawn from the device's
    generator, or an ``nn.rng_scope``) with the uniform noise's log-odds
    removed, and returns the summed binary cross-entropy ``[B, 1]``."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False, dtype="float32"):
        super().__init__()
        if sampler != "uniform" or custom_dist is not None:
            raise UnimplementedError(
                "NCE: only uniform negative sampling is implemented")
        self._num_classes = num_total_classes
        self._num_neg = num_neg_samples
        self.weight = self.create_parameter([num_total_classes, dim],
                                            attr=param_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_total_classes, 1],
                                           attr=bias_attr, is_bias=True))

    def forward(self, input, label, sample_weight=None):
        lab = label.reshape(-1).to(torch.int64)
        B = input.shape[0]
        gen = None if input.device.type == "meta" else \
            generator_for(input.device)
        neg = torch.randint(0, self._num_classes, (B, self._num_neg),
                            generator=gen, device=input.device)
        ids = torch.cat([lab[:, None], neg], dim=1)  # [B, 1+K]
        logits = torch.einsum("bd,bkd->bk", input, self.weight[ids])
        if self.bias is not None:
            logits = logits + self.bias[ids, 0]
        logits = logits - torch.log(torch.tensor(
            self._num_neg / self._num_classes, dtype=input.dtype,
            device=input.device))
        targets = torch.zeros_like(logits)
        targets[:, 0] = 1.0
        loss = _F.binary_cross_entropy_with_logits(logits, targets,
                                                   reduction="none")
        return loss.sum(-1, keepdim=True)

