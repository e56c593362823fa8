"""The port's ``layer_base`` names (``paddle_tpu_torch.nn.layer``):
``nn.Parameter`` as the class of every parameter the port registers and
its JAX box surface; ``nn.Buffer``; ``functional_call``'s restore rules
and gradients against the JAX package's ``functional_call`` and
``jax.grad``; ``rng_scope`` / ``current_rng_key`` drawing from an
explicit ``torch.Generator`` with the device streams untouched.
"""
import copy
import io
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               NotFoundError)
from torch_op_pairs import check_grads, np_, on_the_cpu  # noqa: F401


# -- nn.Parameter is the class of every parameter ------------------------------
def _bert_tiny():
    from paddle_tpu_torch.models import bert

    return bert.BertForPretraining(bert.bert_tiny(), device="cpu")


def _resnet18():
    from paddle_tpu_torch.vision.models import resnet18

    return resnet18(num_classes=10)


def _moe():
    from paddle_tpu_torch.moe import MoELayer

    cfg = types.SimpleNamespace(hidden_size=8, intermediate_size=16,
                                dropout=0.0, moe_experts=4, moe_top_k=2,
                                moe_capacity_factor=1.25, moe_jitter=0.0)
    return MoELayer(cfg)


def _static_scope():
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.static.graph import reset_default_programs

    reset_default_programs()
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x = fluid.data("x", [-1, 4, 6])
        h = fluid.layers.fc(x, 9, num_flatten_dims=2)
        h = fluid.layers.dynamic_gru(h, 3)
        fluid.layers.batch_norm(fluid.layers.reshape(h, [-1, 3, 4, 1]))
    holder = tnn.Layer()
    for i, (n, p) in enumerate(main.scope.items()):
        holder.register_parameter(f"p{i}", p)
    return holder


def _misc():
    m = tnn.Sequential(tnn.Linear(3, 4), tnn.LSTM(4, 5))
    tnn.utils.weight_norm(m[0])
    m.add_parameter("extra", torch.nn.Parameter(torch.ones(2)))
    m.plist = tnn.ParameterList([torch.zeros(3)])
    m.made = m.create_parameter([2, 2])
    return m


MODELS = {"bert_tiny": _bert_tiny, "resnet18": _resnet18, "moe": _moe,
          "static_scope": _static_scope, "misc": _misc}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_nn_parameter_is_the_class_of_every_parameter(name):
    model = MODELS[name]()
    params = list(model.named_parameters())
    assert params
    for n, p in params:
        assert type(p) is tnn.Parameter, (n, type(p))
    sd = model.state_dict()
    assert set(n for n, _ in params) <= set(sd)


def test_parameter_box_surface_matches_jax():
    value = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    jp = jnn.Parameter(value, name="w", trainable=False,
                       partition_spec=(None, "mp"))
    tp = tnn.Parameter(value, name="w", trainable=False,
                       partition_spec=(None, "mp"))
    assert (tp.name, tp.trainable, tp.partition_spec, tp.sparse) == (
        jp.name, jp.trainable, jp.partition_spec, jp.sparse)
    assert tuple(tp.shape) == jp.shape and tp.ndim == jp.ndim
    np.testing.assert_array_equal(tp.numpy(), jp.numpy())
    assert tp.value is tp and not tp.requires_grad
    tp.trainable = True
    assert tp.requires_grad
    tp.sparse = True
    tp.set_value(np.ones((3, 4), np.float64))
    jp.set_value(np.ones((3, 4), np.float64))
    assert tp.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), jp.numpy())
    for clone in (copy.deepcopy(tp), pickle.loads(pickle.dumps(tp))):
        assert type(clone) is tnn.Parameter
        assert (clone.name, clone.partition_spec, clone.sparse,
                clone.trainable) == ("w", (None, "mp"), True, True)
        assert torch.equal(clone, tp) and clone.data_ptr() != tp.data_ptr()
    buf = io.BytesIO()
    torch.save({"p": tp}, buf)
    buf.seek(0)
    back = torch.load(buf, weights_only=False)["p"]
    assert type(back) is tnn.Parameter and back.name == "w"
    assert type(tp * 2) is torch.Tensor


def test_buffer_box_and_registration():
    jb = jnn.Buffer(np.arange(3, dtype=np.float32), name="b",
                    persistable=False)
    tb = tnn.Buffer(np.arange(3, dtype=np.float32), name="b",
                    persistable=False)
    assert (tb.name, tb.persistable, tb.trainable) == (
        jb.name, jb.persistable, jb.trainable)
    np.testing.assert_array_equal(tb.numpy(), jb.numpy())
    layer = tnn.Layer()
    layer.stat = tb
    layer.kept = tnn.Buffer(torch.ones(2))
    assert set(dict(layer.named_buffers())) == {"stat", "kept"}
    assert set(layer.state_dict()) == {"kept"}
    assert type(copy.deepcopy(tb)) is tnn.Buffer
    assert type(tb + 1) is torch.Tensor


def test_parameter_trains_and_moves_keeping_its_class():
    from paddle_tpu_torch.optimizer import Adam

    lin = tnn.Linear(3, 2)
    opt = Adam(learning_rate=0.1, parameters=lin.parameters())
    before = lin.weight.detach().clone()
    lin(torch.ones(4, 3)).sum().backward()
    opt.step()
    assert not torch.equal(before, lin.weight)
    lin.to(torch.float64)
    assert type(lin.weight) is tnn.Parameter
    assert lin.weight.dtype == torch.float64
    model = copy.deepcopy(lin)
    assert all(type(p) is tnn.Parameter for p in model.parameters())


# -- functional_call -----------------------------------------------------------
def _pair():
    jl = jnn.Sequential(jnn.Linear(4, 6), jnn.BatchNorm1D(6), jnn.ReLU(),
                        jnn.Linear(6, 3))
    tl = tnn.Sequential(tnn.Linear(4, 6), tnn.BatchNorm1D(6), tnn.ReLU(),
                        tnn.Linear(6, 3))
    load_jax_params(tl, {k: np.asarray(p.value)
                         for k, p in jl.named_parameters()},
                    {k: np.asarray(b.value) for k, b in jl.named_buffers()})
    return jl, tl


def _inputs():
    rng = np.random.RandomState(1)
    x = rng.randn(5, 4).astype(np.float32)
    params = {"0.weight": rng.randn(4, 6).astype(np.float32),
              "3.bias": rng.randn(3).astype(np.float32)}
    bufs = {"1._mean": rng.randn(6).astype(np.float32)}
    return x, params, bufs


@pytest.mark.parametrize("training", [True, False])
def test_functional_call_matches_jax_and_restores(training):
    """Outputs, returned buffers and gradients in the substituted params
    as JAX's; every parameter, buffer and mode restored."""
    from paddle_tpu.nn import functional_call as jcall

    jl, tl = _pair()
    x, params, bufs = _inputs()
    tl.eval()
    jl.eval()
    keep_p = {n: p.detach().clone() for n, p in tl.named_parameters()}
    keep_b = {n: b.clone() for n, b in tl.named_buffers()}
    tparams = {n: torch.tensor(v, requires_grad=True)
               for n, v in params.items()}
    tbufs = {n: torch.tensor(v) for n, v in bufs.items()}
    out, nb = tnn.functional_call(tl, tparams, torch.from_numpy(x),
                                  buffers=tbufs, training=training,
                                  return_buffers=True)

    @jax.jit
    def jfn(p):
        return jcall(jl, p, jnp.asarray(x),
                     buffers={n: jnp.asarray(v) for n, v in bufs.items()},
                     training=training, return_buffers=True)

    (jout, jnb) = jfn({n: jnp.asarray(v) for n, v in params.items()})
    np.testing.assert_allclose(np_(out), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    assert set(nb) == set(jnb)
    for n in nb:
        np.testing.assert_allclose(np_(nb[n]), np.asarray(jnb[n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    cot = np.random.RandomState(2).randn(*out.shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jfn(p)[0] * cot))(
        {n: jnp.asarray(v) for n, v in params.items()})
    tg = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                             list(tparams.values()))
    check_grads(tg, [jg[n] for n in tparams], list(tparams))
    # restored: parameters, buffers (the given ones never written), modes
    for n, p in tl.named_parameters():
        assert torch.equal(p, keep_p[n]) and type(p) is tnn.Parameter, n
    for n, b in tl.named_buffers():
        assert torch.equal(b, keep_b[n]), n
    assert torch.equal(tbufs["1._mean"], torch.from_numpy(bufs["1._mean"]))
    assert not any(m.training for m in tl.modules())


def test_functional_call_without_return_buffers_keeps_in_place_updates():
    """Eager semantics: a training call's BatchNorm statistics persist in
    the layer's buffers, as JAX's box keeps them."""
    from paddle_tpu.nn import functional_call as jcall

    jl, tl = _pair()
    x, params, _ = _inputs()
    tnn.functional_call(tl, {n: torch.tensor(v) for n, v in params.items()},
                        torch.from_numpy(x), training=True)
    _, new = jax.jit(lambda p: jcall(jl, p, jnp.asarray(x), training=True,
                                     return_buffers=True))(
        {n: jnp.asarray(v) for n, v in params.items()})
    for n, v in new.items():  # eager JAX keeps them in its boxes
        dict(jl.named_buffers())[n].value = v
    for n, b in tl.named_buffers():
        np.testing.assert_allclose(np_(b), np.asarray(
            dict(jl.named_buffers())[n].value), rtol=1e-5, atol=1e-6)
    assert tl.training  # the mode restored


def test_functional_call_restores_a_derived_weight_and_raises_on_names():
    lin = tnn.utils.weight_norm(tnn.Linear(3, 2))
    w0 = lin.weight.clone()
    g = torch.full_like(lin.weight_g, 2.0)
    out = tnn.functional_call(lin, {"weight_g": g}, torch.ones(1, 3))
    assert not torch.equal(out, lin(torch.ones(1, 3)))
    assert torch.equal(lin.weight, w0)  # the pre-hook's rewrite undone
    with pytest.raises(NotFoundError):
        tnn.functional_call(lin, {"nope": g}, torch.ones(1, 3))
    with pytest.raises(NotFoundError):
        tnn.functional_call(lin, {}, torch.ones(1, 3), buffers={"nope": g})
    called = tnn.functional_call(
        lin, {"bias": torch.zeros(2)}, torch.ones(1, 3),
        call=lambda x: lin(x) * 0 + lin.bias.sum())
    assert float(called.detach().sum()) == 0.0


# -- rng_scope -----------------------------------------------------------------
def test_rng_scope_gives_equal_masks_and_leaves_the_stream_alone():
    x = torch.ones(64, 64)
    drop = tnn.Dropout(0.5)
    state = trandom.default_generator().get_state()
    with tnn.rng_scope(torch.Generator().manual_seed(7)):
        a = drop(x)
        assert tnn.current_rng_key("cpu") is not trandom.default_generator()
    with tnn.rng_scope(torch.Generator().manual_seed(7)):
        b = drop(x)
    with tnn.rng_scope(3):  # an int seed: one generator a device
        c = drop(x)
    with tnn.rng_scope(3) as scope:
        d = drop(x)
        assert tnn.current_rng_key("cpu") is scope.generator("cpu")
    assert torch.equal(a, b) and torch.equal(c, d) and not torch.equal(a, c)
    assert torch.equal(trandom.default_generator().get_state(), state)
    assert tnn.current_rng_key("cpu") is trandom.default_generator()
    with tnn.rng_scope(torch.Generator().manual_seed(1)) as scope:
        with pytest.raises(InvalidArgumentError):
            scope.generator("cuda:0")


def test_functional_call_rngs_installs_a_scope():
    drop = tnn.Dropout(0.5)
    x = torch.ones(32, 32)
    a = tnn.functional_call(drop, {}, x, rngs=torch.Generator().manual_seed(9))
    b = tnn.functional_call(drop, {}, x, rngs=torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
