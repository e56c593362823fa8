"""Recurrent layers — port of ``paddle_tpu.nn.rnn``: the cells
(``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``), ``RNN`` / ``BiRNN`` over a
cell, the multi-layer ``RNNBase`` (``SimpleRNN``, ``LSTM``, ``GRU``) and
``split_states`` / ``concat_states``.

The conventions are the JAX package's: weights ``[gates · hidden, in]``
and ``[gates · hidden, hidden]`` with both biases, all drawn U(-1/√hidden,
1/√hidden); LSTM gates in the order i, f, g, o; GRU gates r, z, c with the
reset gate applied to ``h W_hhᵀ + b_hh`` (``c = tanh(x_c + r · h_c)``,
``h' = (1 - z) c + z h``); a multi-layer RNN names its cells
``cell_{layer}_{direction}``, feeds dropout between layers only, and
takes and returns states ``[layers · directions, batch, hidden]`` (LSTM: a
pair).  With ``sequence_length`` a sequence's state freezes and its
output is zero past its length; the reverse direction runs over the
padded sequence from its end, so it starts from the initial state until
it reaches the sequence's last valid step.

The time loop runs one cell call after another on the host (the JAX
package's ``lax.scan``); a fused cuDNN route is later work.
"""
from __future__ import annotations

import math

import torch

from ..framework.errors import InvalidArgumentError
from ..tensor._common import t as _t
from .functional.common import dropout
from .initializer import (Uniform, create_parameter, fill_at_construction,
                          init_parameter)
from .layer import Layer

__all__ = [
    "RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
    "RNNBase", "split_states", "concat_states", "SimpleRNN", "LSTM", "GRU",
]


class RNNCellBase(Layer):
    _gates = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        g = self._gates * hidden_size
        self._attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                       bias_hh_attr)
        self.weight_ih = create_parameter((g, input_size), weight_ih_attr)
        self.weight_hh = create_parameter((g, hidden_size), weight_hh_attr)
        self.bias_ih = create_parameter((g,), bias_ih_attr)
        self.bias_hh = create_parameter((g,), bias_hh_attr)
        fill_at_construction(self)

    def reset_parameters(self, generator=None):
        std = 1.0 / math.sqrt(self.hidden_size)
        for p, attr in zip((self.weight_ih, self.weight_hh, self.bias_ih,
                            self.bias_hh), self._attrs):
            init_parameter(p, attr, Uniform(-std, std), generator)

    def _zeros(self, x):
        return x.new_zeros((x.shape[0], self.hidden_size))

    def get_initial_states(self, batch_size, dtype="float32"):
        raise NotImplementedError


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation

    def forward(self, inputs, states=None):
        x = _t(inputs)
        h = self._zeros(x) if states is None else states
        pre = (x @ self.weight_ih.T + self.bias_ih
               + h @ self.weight_hh.T + self.bias_hh)
        h = torch.tanh(pre) if self.activation == "tanh" else torch.relu(pre)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    _gates = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        x = _t(inputs)
        if states is None:
            h = c = self._zeros(x)
        else:
            h, c = states
        gates = (x @ self.weight_ih.T + self.bias_ih
                 + h @ self.weight_hh.T + self.bias_hh)
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, (new_h, new_c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    _gates = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        x = _t(inputs)
        h = self._zeros(x) if states is None else states
        xg = x @ self.weight_ih.T + self.bias_ih
        hg = h @ self.weight_hh.T + self.bias_hh
        xr, xz, xc = torch.chunk(xg, 3, dim=-1)
        hr, hz, hc = torch.chunk(hg, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        c = torch.tanh(xc + r * hc)
        new_h = (1 - z) * c + z * h
        return new_h, new_h

    @property
    def state_shape(self):
        return (self.hidden_size,)


def _map(fn, *trees):
    """``fn`` over matching tensors of nested tuples / lists."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _run_cell(cell, inputs, state, reverse=False, seq_lens=None):
    """The cell over ``inputs`` ``[T, B, I]`` one step after another
    (from the end when ``reverse``); returns (outputs ``[T, B, H]``, final
    state)."""
    T = inputs.shape[0]
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        out, new_state = cell(inputs[t], state)
        if seq_lens is not None:
            valid = (t < seq_lens)[:, None]
            new_state = _map(lambda n, o: torch.where(valid, n, o),
                             new_state, state)
            out = torch.where(valid, out, torch.zeros_like(out))
        state = new_state
        outs[t] = out
    return torch.stack(outs), state


class RNN(Layer):
    """A cell over a sequence (``[B, T, ...]``, or ``[T, B, ...]`` with
    ``time_major``); returns (outputs, final state)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = _t(inputs)
        if not self.time_major:
            x = x.transpose(0, 1)
        if initial_states is None:
            z = x.new_zeros((x.shape[1], self.cell.hidden_size))
            initial_states = (z, z) if isinstance(self.cell, LSTMCell) else z
        lens = (None if sequence_length is None
                else _t(sequence_length, x).to(x.device))
        outs, final = _run_cell(self.cell, x, initial_states,
                                self.is_reverse, lens)
        if not self.time_major:
            outs = outs.transpose(0, 1)
        return outs, final


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = _t(inputs)
        if not self.time_major:
            x = x.transpose(0, 1)
        lens = (None if sequence_length is None
                else _t(sequence_length, x).to(x.device))
        res = []
        for i, (cell, rev) in enumerate(((self.cell_fw, False),
                                         (self.cell_bw, True))):
            state = None if initial_states is None else initial_states[i]
            if state is None:
                z = x.new_zeros((x.shape[1], cell.hidden_size))
                state = (z, z) if isinstance(cell, LSTMCell) else z
            res.append(_run_cell(cell, x, state, rev, lens))
        out = torch.cat([res[0][0], res[1][0]], -1)
        if not self.time_major:
            out = out.transpose(0, 1)
        return out, (res[0][1], res[1][1])


#: mode → cell class
_RNN_MODES = {"LSTM": LSTMCell, "GRU": GRUCell, "RNN_TANH": SimpleRNNCell,
              "RNN_RELU": SimpleRNNCell}


class RNNBase(Layer):
    """The multi-layer, optionally bidirectional RNN; ``mode`` picks the
    cell (``"LSTM"``, ``"GRU"``, ``"RNN_TANH"``, ``"RNN_RELU"``)."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation=None, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if mode not in _RNN_MODES:
            raise InvalidArgumentError(
                f"mode must be one of {sorted(_RNN_MODES)}, got {mode!r}")
        self._mode = mode
        self._cell_cls = _RNN_MODES[mode]
        if activation is None:
            activation = "relu" if mode == "RNN_RELU" else "tanh"
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        num_dirs = 2 if self.bidirectional else 1
        kw = dict(weight_ih_attr=weight_ih_attr,
                  weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                  bias_hh_attr=bias_hh_attr)
        if self._cell_cls is SimpleRNNCell:
            kw["activation"] = activation
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * num_dirs
            for d in range(num_dirs):
                self.add_module(f"cell_{layer}_{d}",
                                self._cell_cls(in_size, hidden_size, **kw))

    def _cells(self):
        num_dirs = 2 if self.bidirectional else 1
        return [[self._modules[f"cell_{i}_{d}"] for d in range(num_dirs)]
                for i in range(self.num_layers)]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = _t(inputs)
        if not self.time_major:
            x = x.transpose(0, 1)  # [T, B, I]
        batch = x.shape[1]
        num_dirs = 2 if self.bidirectional else 1
        is_lstm = self._cell_cls is LSTMCell
        lens = (None if sequence_length is None
                else _t(sequence_length, x).to(x.device))

        def init_state(layer, d):
            idx = layer * num_dirs + d
            if initial_states is None:
                z = x.new_zeros((batch, self.hidden_size))
                return (z, z) if is_lstm else z
            if is_lstm:
                h0, c0 = initial_states
                return (_t(h0, x)[idx], _t(c0, x)[idx])
            return _t(initial_states, x)[idx]

        out = x
        final_h, final_c = [], []
        for layer, cells in enumerate(self._cells()):
            outs = []
            for d, cell in enumerate(cells):
                o, f = _run_cell(cell, out, init_state(layer, d),
                                 reverse=(d == 1), seq_lens=lens)
                outs.append(o)
                if is_lstm:
                    final_h.append(f[0])
                    final_c.append(f[1])
                else:
                    final_h.append(f)
            out = outs[0] if len(outs) == 1 else torch.cat(outs, -1)
            if self.dropout > 0 and layer < self.num_layers - 1:
                out = dropout(out, p=self.dropout, training=self.training)
        if not self.time_major:
            out = out.transpose(0, 1)
        h = torch.stack(final_h, 0)
        if is_lstm:
            return out, (h, torch.stack(final_c, 0))
        return out, h


class SimpleRNN(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        mode = "RNN_RELU" if activation == "relu" else "RNN_TANH"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout,
                         activation=activation, **kw)


class LSTM(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


def split_states(states, bidirectional=False, state_components=1):
    """``[L · D, N, C]`` network states (a tuple of such for several
    components) → per-cell states (pairs per layer when
    ``bidirectional``)."""
    if state_components == 1:
        parts = [states[i] for i in range(states.shape[0])]
        if not bidirectional:
            return parts
        return list(zip(parts[::2], parts[1::2]))
    if len(states) != state_components:
        raise InvalidArgumentError(
            f"split_states: {len(states)} components, expected "
            f"{state_components}")
    comps = tuple([item[i] for i in range(item.shape[0])] for item in states)
    zipped = list(zip(*comps))
    if not bidirectional:
        return zipped
    return list(zip(zipped[::2], zipped[1::2]))


def concat_states(states, bidirectional=False, state_components=1):
    """The inverse of :func:`split_states`."""
    flat = _leaves(states)
    if state_components == 1:
        return torch.stack(flat)
    return tuple(torch.stack(flat[i::state_components])
                 for i in range(state_components))
