"""The port's ``nn.rnn`` held against the JAX package's on the CPU: the
cells, ``RNN`` / ``BiRNN`` over a cell and the multi-layer ``SimpleRNN``,
``LSTM`` and ``GRU`` — forward (outputs and final states) and the
gradients of every parameter and of the input at rtol / atol 2e-5
(float32), with ``sequence_length``, the reverse direction,
``time_major`` and initial states; ``state_dict`` names equal to the JAX
names (``cell_{layer}_{direction}.weight_ih`` ...); ``split_states`` /
``concat_states``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from torch_nn_pairs import bridged, check_pair

TOL = dict(rtol=2e-5, atol=2e-5)
B, T, I, HID = 3, 7, 5, 6
LENS = np.array([7, 4, 1], np.int64)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(name, *args, **kw):
    jpt.seed(13)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw)
    jl.eval()
    return jl, bridged(jl, tl)


# -- cells ----------------------------------------------------------------------------
CELLS = [("SimpleRNNCell", {}), ("SimpleRNNCell", dict(activation="relu")),
         ("LSTMCell", {}), ("GRUCell", {})]


@pytest.mark.parametrize("name,kw", CELLS, ids=["rnn_tanh", "rnn_relu",
                                                "lstm", "gru"])
@pytest.mark.parametrize("with_state", [False, True])
def test_cell_as_jax(name, kw, with_state):
    jl, tl = _pair(name, I, HID, **kw)
    assert list(tl.state_dict()) == ["weight_ih", "weight_hh", "bias_ih",
                                     "bias_hh"]
    gates = {"LSTMCell": 4, "GRUCell": 3}.get(name, 1)
    assert tuple(tl.weight_ih.shape) == (gates * HID, I)
    if not with_state:
        check_pair(jl, tl, [_x(B, I)], **TOL)
        return
    h = _x(B, HID, seed=1)
    if name == "LSTMCell":
        c = _x(B, HID, seed=2)
        jo = jl(jnp.asarray(_x(B, I)), (jnp.asarray(h), jnp.asarray(c)))
        to = tl(torch.tensor(_x(B, I)), (torch.tensor(h), torch.tensor(c)))
        for a, b in zip((to[0], *to[1]), (jo[0], *jo[1])):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **TOL)
        return
    check_pair(jl, tl, [_x(B, I), h], grad_inputs=(0, 1), **TOL)


# -- RNN / BiRNN over a cell -------------------------------------------------------
@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
@pytest.mark.parametrize("reverse,time_major,lens", [
    (False, False, None), (True, False, None), (False, True, LENS),
    (True, False, LENS)], ids=["fwd", "rev", "time_major_lens", "rev_lens"])
def test_rnn_wrapper_as_jax(cell, reverse, time_major, lens):
    jpt.seed(17)
    jc = getattr(jnn, cell)(I, HID)
    tc = getattr(tnn, cell)(I, HID)
    jl = jnn.RNN(jc, is_reverse=reverse, time_major=time_major)
    tl = tnn.RNN(tc, is_reverse=reverse, time_major=time_major)
    bridged(jl, tl)
    x = _x(T, B, I) if time_major else _x(B, T, I)
    kw = {} if lens is None else dict(sequence_length=lens)
    outs = check_pair(jl, tl, [x], kwargs=kw, **TOL)
    if lens is not None:
        seq = outs[0] if time_major else outs[0].transpose(0, 1)
        for b, n in enumerate(lens):
            assert (seq[n:, b] == 0).all()  # zero past each length


@pytest.mark.parametrize("lens", [None, LENS])
def test_birnn_as_jax(lens):
    jpt.seed(19)
    jl = jnn.BiRNN(jnn.LSTMCell(I, HID), jnn.LSTMCell(I, HID))
    tl = tnn.BiRNN(tnn.LSTMCell(I, HID), tnn.LSTMCell(I, HID))
    bridged(jl, tl)
    kw = {} if lens is None else dict(sequence_length=lens)
    check_pair(jl, tl, [_x(B, T, I)], kwargs=kw, **TOL)


# -- multi-layer networks ----------------------------------------------------------
NETS = [
    ("LSTM", dict(num_layers=2)),
    ("LSTM", dict(num_layers=2, direction="bidirect")),
    ("GRU", dict(num_layers=2, direction="bidirectional")),
    ("GRU", dict(num_layers=1, time_major=True)),
    ("SimpleRNN", dict(num_layers=2, activation="relu")),
    ("SimpleRNN", dict(num_layers=1, direction="bidirect")),
    ("LSTM", dict(num_layers=3, dropout=0.5)),  # eval: no dropout
]


@pytest.mark.parametrize("name,kw", NETS, ids=[
    f"{n}-{i}" for i, (n, _) in enumerate(NETS)])
@pytest.mark.parametrize("lens", [None, LENS], ids=["full", "ragged"])
def test_network_as_jax(name, kw, lens):
    jl, tl = _pair(name, I, HID, **kw)
    assert list(tl.state_dict()) == list(jl.state_dict())
    x = _x(T, B, I) if kw.get("time_major") else _x(B, T, I)
    call = {} if lens is None else dict(sequence_length=lens)
    check_pair(jl, tl, [x], kwargs=call, **TOL)


@pytest.mark.parametrize("name", ["LSTM", "GRU"])
def test_network_initial_states_as_jax(name):
    jl, tl = _pair(name, I, HID, num_layers=2, direction="bidirect")
    h0 = _x(4, B, HID, seed=5)
    init = (h0, _x(4, B, HID, seed=6)) if name == "LSTM" else h0
    check_pair(jl, tl, [_x(B, T, I)],
               kwargs=dict(initial_states=init, sequence_length=LENS), **TOL)


def test_network_cell_names_and_mode_errors():
    tl = tnn.LSTM(I, HID, num_layers=2, direction="bidirect")
    assert [n for n, _ in tl.named_children()] == [
        "cell_0_0", "cell_0_1", "cell_1_0", "cell_1_1"]
    assert tuple(tl.cell_1_0.weight_ih.shape) == (4 * HID, 2 * HID)
    with pytest.raises(InvalidArgumentError):
        tnn.RNNBase("CONV", I, HID)


def test_dropout_falls_between_layers_only():
    tpt.seed(1)
    net = tnn.LSTM(I, HID, num_layers=2, dropout=0.5)
    one = tnn.LSTM(I, HID, num_layers=1, dropout=0.5)
    one.cell_0_0.load_state_dict(net.cell_0_0.state_dict())
    x = torch.tensor(_x(B, T, I))
    net.train()
    one.train()
    out1, (h1, _) = one(x)
    out1_eval, _ = one.eval()(x)
    torch.testing.assert_close(out1, out1_eval)  # one layer: no dropout
    out2, _ = net(x)
    net.eval()
    out2_eval, _ = net(x)
    assert not torch.equal(out2, out2_eval)  # between layers 0 and 1


def test_split_and_concat_states_as_jax():
    h = _x(4, B, HID)
    c = _x(4, B, HID, seed=1)
    for bidi in (False, True):
        ts = tnn.split_states(torch.tensor(h), bidi)
        js = jnn.split_states(jnp.asarray(h), bidi)
        assert len(ts) == len(js)
        back = tnn.concat_states(ts, bidi)
        np.testing.assert_array_equal(back.numpy(), h)
        ts2 = tnn.split_states((torch.tensor(h), torch.tensor(c)), bidi, 2)
        js2 = jnn.split_states((jnp.asarray(h), jnp.asarray(c)), bidi, 2)
        assert len(ts2) == len(js2)
        hb, cb = tnn.concat_states(ts2, bidi, 2)
        np.testing.assert_array_equal(hb.numpy(), h)
        np.testing.assert_array_equal(cb.numpy(), c)
