"""``nn.initializer`` / ``ParamAttr`` and the full ``cross_entropy`` of the
port held against the JAX package.

The deterministic initializers (``Constant``, ``Assign``, ``Dirac``,
``Bilinear``), ``calculate_gain`` and the fans equal JAX's bit for bit;
the random ones are held to their bounds and moments (5 standard errors
of the mean, 5% of the standard deviation over 40,000 draws); each layer
honors ``weight_attr`` / ``bias_attr`` as JAX's (initializer, ``False``
for no parameter, ``trainable=False`` out of the optimizer, ``name``).
``cross_entropy`` with soft labels, ``weight``, ``axis``,
``use_softmax=False`` and ``label_smoothing``, and
``softmax_with_cross_entropy``, at rtol 1e-5 / atol 1e-6 of JAX's.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.functional import loss as jloss
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.nn.functional import loss as tloss

SHAPES = [(5,), (6, 3), (4, 3, 3, 3), (2, 5, 4, 4)]


@pytest.mark.parametrize("make", [
    lambda I: I.Constant(0.25),
    lambda I: I.Assign(np.arange(12, dtype=np.float32).reshape(4, 3) / 7),
    lambda I: I.Dirac(), lambda I: I.Bilinear()],
    ids=["constant", "assign", "dirac", "bilinear"])
def test_deterministic_initializers_bit_equal_to_jax(make):
    shape = (4, 3) if "Assign" in repr(make(TI)) else (4, 3, 5, 5)
    want = np.asarray(make(JI)(shape, "float32"))
    got = make(TI)(shape).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", SHAPES)
def test_fans_and_gains_equal_jax(shape):
    assert TI._fans(shape) == JI._fans(shape)
    for nl, param in (("sigmoid", None), ("tanh", None), ("relu", None),
                      ("leaky_relu", None), ("leaky_relu", 0.2),
                      ("selu", None), ("conv2d", None)):
        assert TI.calculate_gain(nl, param) == JI.calculate_gain(nl, param)


N = 40_000


def _draw(init, shape=(200, 200)):
    return init(shape, generator=torch.Generator().manual_seed(0)).numpy()


@pytest.mark.parametrize("init,mean,std,lo,hi", [
    (TI.Uniform(-0.5, 1.5), 0.5, 2 / math.sqrt(12), -0.5, 1.5),
    (TI.Normal(1.0, 2.0), 1.0, 2.0, None, None),
    # a standard normal truncated at ±2: std 0.8796
    (TI.TruncatedNormal(0.0, 1.0), 0.0, 0.879626, -2.0, 2.0),
    (TI.XavierNormal(), 0.0, math.sqrt(2 / 400), None, None),
    (TI.XavierUniform(), 0.0, math.sqrt(6 / 400) / math.sqrt(3),
     -math.sqrt(6 / 400), math.sqrt(6 / 400)),
    (TI.KaimingNormal(), 0.0, math.sqrt(2 / 200), None, None),
    (TI.KaimingUniform(), 0.0, math.sqrt(2) * math.sqrt(3 / 200)
     / math.sqrt(3), -math.sqrt(2) * math.sqrt(3 / 200),
     math.sqrt(2) * math.sqrt(3 / 200))],
    ids=["uniform", "normal", "truncated_normal", "xavier_normal",
         "xavier_uniform", "kaiming_normal", "kaiming_uniform"])
def test_random_initializers_bounds_and_moments(init, mean, std, lo, hi):
    a = _draw(init)
    assert a.dtype == np.float32 and a.shape == (200, 200)
    assert abs(a.mean() - mean) < 5 * std / math.sqrt(N), (a.mean(), mean)
    assert abs(a.std() - std) < 0.05 * std, (a.std(), std)
    if lo is not None:
        assert a.min() >= lo and a.max() <= hi
    again = _draw(init)
    np.testing.assert_array_equal(a, again)  # one seed, one draw


def test_orthogonal_is_orthogonal_times_gain():
    w = _draw(TI.Orthogonal(gain=2.0), (6, 10))
    np.testing.assert_allclose(w @ w.T, 4.0 * np.eye(6), atol=1e-5)


def _layers(pkg):
    I, nn = pkg.nn.initializer, pkg.nn
    attr = nn.ParamAttr(name="w", initializer=I.Constant(0.3))
    battr = nn.ParamAttr(initializer=I.Constant(-0.1), trainable=False)
    return {
        "linear": nn.Linear(4, 3, weight_attr=attr, bias_attr=battr),
        "linear_no_bias": nn.Linear(4, 3, bias_attr=False),
        "embedding": nn.Embedding(5, 3, weight_attr=nn.ParamAttr(
            initializer=I.Assign(np.arange(15.0).reshape(5, 3)))),
        "conv2d": nn.Conv2D(3, 4, 3, weight_attr=nn.ParamAttr(
            initializer=I.Dirac()), bias_attr=False),
        "batch_norm": nn.BatchNorm2D(4, weight_attr=nn.ParamAttr(
            initializer=I.Constant(2.0)), bias_attr=False),
        "layer_norm": nn.LayerNorm([2, 3], weight_attr=False,
                                   bias_attr=nn.ParamAttr(
                                       initializer=I.Constant(0.5))),
    }


@pytest.mark.parametrize("kind", ["linear", "linear_no_bias", "embedding",
                                  "conv2d", "batch_norm", "layer_norm"])
def test_layer_attrs_as_jax(kind):
    jpt.seed(0)
    jl = _layers(jpt)[kind]
    tl = _layers(tpt)[kind]
    for m in tl.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(0))
    jp = dict(jl.named_parameters())
    tp = dict(tl.named_parameters())
    assert set(tp) == set(jp), (set(tp), set(jp))
    for name, p in tp.items():
        assert tuple(p.shape) == tuple(jp[name].value.shape)
        assert p.requires_grad == jp[name].trainable, name
        if kind != "linear_no_bias":  # its weight is XavierNormal: random
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(jp[name].value))
    if kind == "linear":
        assert tl.weight.name == jp["weight"].name == "w"


def test_untrainable_parameter_stays_out_of_the_optimizer():
    tpt.seed(0)
    net = tnn.Linear(4, 2, bias_attr=tnn.ParamAttr(trainable=False))
    net.reset_parameters(torch.Generator().manual_seed(0))
    m = tpt.Model(net, inputs=["x"], labels=["y"])
    opt = tpt.optimizer.SGD(0.5)
    m.prepare(optimizer=opt, loss=lambda o, y: ((o - y) ** 2).mean())
    assert list(opt._bound()) == ["weight"]
    w0, b0 = net.weight.detach().clone(), net.bias.detach().clone()
    m.train_batch([np.ones((3, 4), np.float32)],
                  [np.ones((3, 2), np.float32)])
    assert torch.equal(net.bias, b0) and not torch.equal(net.weight, w0)


# -- cross_entropy -------------------------------------------------------------
def _xent_inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5, 3).astype(np.float32)
    label = rng.randint(0, 5, (4, 3))
    label[0, 0] = -100
    soft = rng.rand(4, 5, 3).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    probs = np.exp(x) / np.exp(x).sum(1, keepdims=True)
    weight = rng.rand(5).astype(np.float32) + 0.5
    return x, label, soft, probs, weight


@pytest.mark.parametrize("case", [
    dict(), dict(weight=True), dict(label_smoothing=0.1),
    dict(reduction="none"), dict(reduction="sum", weight=True),
    dict(soft_label=True), dict(use_softmax=False),
    dict(label_smoothing=0.2, weight=True, reduction="sum")],
    ids=["hard", "weight", "label_smoothing", "none", "sum_weight", "soft",
         "probabilities", "smoothing_weight_sum"])
def test_cross_entropy_matches_jax(case):
    x, label, soft, probs, weight = _xent_inputs()
    case = dict(case, axis=1)
    inp = probs if case.get("use_softmax") is False else x
    lab = soft if case.get("soft_label") else label
    jkw = dict(case)
    tkw = dict(case)
    if case.get("weight"):
        jkw["weight"], tkw["weight"] = jnp.asarray(weight), torch.tensor(
            weight)
    want = np.asarray(jloss.cross_entropy(jnp.asarray(inp),
                                          jnp.asarray(lab), **jkw))
    got = tloss.cross_entropy(torch.tensor(inp), torch.tensor(lab),
                              **tkw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("return_softmax", [False, True])
def test_softmax_with_cross_entropy_matches_jax(return_softmax):
    x, label, _, _, _ = _xent_inputs()
    want = jloss.softmax_with_cross_entropy(
        jnp.asarray(x), jnp.asarray(label[:, None]), axis=1,
        return_softmax=return_softmax)
    got = tloss.softmax_with_cross_entropy(
        torch.tensor(x), torch.tensor(label[:, None]), axis=1,
        return_softmax=return_softmax)
    want = want if return_softmax else (want,)
    got = got if return_softmax else (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_cross_entropy_loss_layer_keeps_the_hard_label_path():
    x, label, _, _, _ = _xent_inputs()
    layer = tnn.CrossEntropyLoss()
    flat = torch.tensor(x.transpose(0, 2, 1).reshape(-1, 5))
    lab = torch.tensor(label.reshape(-1))
    want = jloss.cross_entropy(jnp.asarray(np.asarray(flat)),
                               jnp.asarray(np.asarray(lab)))
    np.testing.assert_allclose(float(layer(flat, lab)), float(want),
                               rtol=1e-6)
