"""The port's quantization-aware training, post-training quantization and
int8 layers (``paddle_tpu_torch.slim``) held against the JAX package
(``paddle_tpu.slim``), with ``nn.Layer``'s paddle methods they walk.

On the CPU, from the same seeded numpy inputs and bridged weights:

* ``named_sublayers`` / ``sublayers`` order and names equal to JAX's on a
  model with a shared sublayer, ``add_sublayer`` / ``add_parameter`` /
  ``create_parameter``, and forward pre- / post-hooks returning values as
  JAX's do;
* ``fake_quant_dequant`` bit-equal to JAX's, its straight-through
  gradient the identity; the observers' ``_scale`` / ``_state`` /
  ``_accum`` after N training calls within 1e-6 of JAX's;
  ``QuantizedLinear`` / ``QuantizedConv2D`` forwards (1e-5) and gradients
  (autograd against ``jax.grad``, 1e-5 of the largest entry);
* PTQ scales equal to JAX's (``abs_max`` and ``avg``), the int8 layers'
  activation codes bit-equal and outputs within 1e-6 (NCHW, NHWC, strided
  and dilated, SAME padding, depthwise and grouped);
* every class of ``tests/test_slim.py`` but ``TestInt8Export`` (which waits
  on the inference export), ``TestQuantizedLeNet`` included, with the JAX
  tests' tolerances;
* the JAX package's inability to QAT-train a bottleneck ResNet (``_fused
  _tail`` reads ``conv3.data_format``), kept by the port.

On the card (``gpu``): the int8 layers' routes bit-equal to their plain
versions, the groups-1 route counted as kernel 9 launches.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu import nn as jnn
from paddle_tpu import slim as jslim
from paddle_tpu.nn.layer_base import functional_call
from paddle_tpu.vision import models as jvm
import paddle_tpu_torch as tpt
from paddle_tpu_torch import nn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import slim
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.slim import (FakeQuantMovingAverage,
                                   ImperativeQuantAware, Int8Conv2D,
                                   Int8Linear, PostTrainingQuantization,
                                   QuantizedConv2D, QuantizedLinear,
                                   fake_quant_dequant, quantize_to_int8)
from paddle_tpu_torch.vision import models as tvm

tqm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().float().numpy()


def _arrays(jm):
    return {k: np.asarray(p.value) for k, p in jm.named_parameters()}


def _buffers(jm):
    return {k: np.asarray(b.value) for k, b in jm.named_buffers()}


def _bridge(jm, tm):
    load_jax_params(tm, _arrays(jm), {
        k: v for k, v in _buffers(jm).items()
        if k in dict(tm.named_buffers())})
    return tm


def _mlp():
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def _jmlp():
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))


def _cnn():
    return nn.Sequential(nn.Conv2D(1, 4, 3, padding=1), nn.ReLU(),
                         nn.Conv2D(4, 2, 3, padding=1))


def _mlp_pair(seed):
    jpt.seed(seed)
    jm = _jmlp()
    return jm, _bridge(jm, _mlp())


# -- nn.Layer's paddle methods ----------------------------------------------
def _shared_tree(pkg):
    inner = pkg.Linear(3, 3)
    block = pkg.Sequential(pkg.Linear(2, 3), pkg.ReLU())
    root = pkg.Sequential(block, inner)
    root.add_sublayer("again", inner)       # one layer at two paths
    block.add_sublayer("tail", pkg.Linear(3, 3))
    return root


def test_named_sublayers_order_and_names_as_jax():
    jr, tr = _shared_tree(jnn), _shared_tree(nn)
    for kw in ({}, dict(include_self=True), dict(prefix="m"),
               dict(prefix="m", include_self=True)):
        want = [(n, type(layer).__name__)
                for n, layer in jr.named_sublayers(**kw)]
        got = [(n, type(layer).__name__)
               for n, layer in tr.named_sublayers(**kw)]
        assert got == want, kw
    assert [type(x).__name__ for x in tr.sublayers()] == [
        type(x).__name__ for x in jr.sublayers()]
    # the shared layer is yielded at both paths (torch's named_modules
    # yields it once)
    assert tr.sublayers().count(tr[1]) == 2
    assert len(list(tr.named_modules())) == len(tr.sublayers(True)) - 1


def test_add_parameter_and_create_parameter():
    layer = nn.Layer()
    p = layer.add_parameter("w", torch.ones(2, 3))
    assert isinstance(p, torch.nn.Parameter) and "w" in dict(
        layer.named_parameters())
    assert layer.add_parameter("none", None) is None
    c = layer.create_parameter([4, 5])
    assert tuple(c.shape) == (4, 5) and c.dtype == torch.float32
    assert float(c.detach().abs().sum()) > 0  # Xavier-normal, not zeros
    b = layer.create_parameter([5], dtype="bfloat16", is_bias=True)
    assert b.dtype == torch.bfloat16 and not b.detach().any()
    const = layer.create_parameter(
        [3], default_initializer=nn.initializer.Constant(2.5))
    assert torch.equal(const.detach(), torch.full((3,), 2.5))
    assert layer.create_parameter([3], attr=False) is None
    # the static builder's create_parameter is the same function
    s = tpt.static.create_parameter([2, 2], "float32", name="w0")
    assert s.name == "w0" and tuple(s.shape) == (2, 2)


def test_forward_hooks_return_values_as_jax():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    results = {}
    for pkg, conv in ((jnn, jnp.asarray), (nn, _t)):
        lin = pkg.Linear(3, 2)
        calls = []
        h1 = lin.register_forward_pre_hook(
            lambda layer, args: args[0] * 2)   # a bare value: wrapped
        h2 = lin.register_forward_post_hook(
            lambda layer, args, out: out + 1)  # replaces the output
        h3 = lin.register_forward_post_hook(
            lambda layer, args, out: calls.append(args[0].shape))  # None
        if pkg is jnn:
            for prm in lin.parameters():
                prm.value = prm.value * 0
        else:
            with torch.no_grad():
                for prm in lin.parameters():
                    prm.zero_()
        out = lin(conv(x))
        results[pkg] = np.asarray(out.detach() if pkg is nn else out)
        assert len(calls) == 1 and tuple(calls[0]) == (2, 3)
        for h in (h1, h2, h3):
            h.remove()
        out = lin(conv(x))
        assert np.asarray(out.detach() if pkg is nn else out).sum() == 0
    np.testing.assert_array_equal(results[nn], results[jnn])
    np.testing.assert_array_equal(results[nn], np.ones((2, 2)))


# -- fake quant and the observers --------------------------------------------
class TestFakeQuantDequant:
    def test_formula_vs_numpy(self):
        x = np.array([-2.0, -0.5, 0.0, 0.3, 0.77, 1.5], np.float32)
        out = _np(fake_quant_dequant(_t(x), 1.0))
        exp = np.round(np.clip(x, -1.0, 1.0) * 127) / 127
        np.testing.assert_allclose(out, exp, atol=1e-6)

    def test_straight_through_gradient(self):
        x = torch.tensor([0.3, 2.0], requires_grad=True)
        fake_quant_dequant(x, 1.0).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [1.0, 1.0])

    def test_quantization_error_bound(self):
        rng = np.random.RandomState(0)
        x = _t(rng.uniform(-3, 3, (64,)).astype(np.float32))
        s = float(x.abs().max())
        out = fake_quant_dequant(x, s)
        assert float((out - x).abs().max()) <= s / 127 / 2 + 1e-6

    @pytest.mark.parametrize("bits", [8, 4])
    def test_bit_equal_to_jax(self, bits):
        rng = np.random.RandomState(bits)
        x = (rng.randn(4096) * 3).astype(np.float32)
        for s in (float(np.abs(x).max()), 1.7, 0.0):
            np.testing.assert_array_equal(
                _np(fake_quant_dequant(_t(x), s, bits)),
                np.asarray(jslim.fake_quant_dequant(jnp.asarray(x), s,
                                                    bits)))
        # a bf16 input comes back bf16
        xb = _t(x).to(torch.bfloat16)
        assert fake_quant_dequant(xb, 1.0).dtype == torch.bfloat16


class TestObservers:
    def test_moving_average_formula(self):
        fq = FakeQuantMovingAverage(moving_rate=0.9)
        fq.train()
        fq(torch.tensor([2.0, -1.0]))
        np.testing.assert_allclose(
            float(fq.scale), (0.9 * 1.0 + 2.0) / (0.9 * 1.0 + 1), rtol=1e-6)
        fq(torch.tensor([4.0]))
        accum = 0.9 * (0.9 + 2.0) + 4.0
        state = 0.9 * 1.9 + 1.0
        np.testing.assert_allclose(float(fq.scale), accum / state, rtol=1e-6)

    def test_eval_uses_stored_scale(self):
        fq = FakeQuantMovingAverage()
        fq.train()
        fq(torch.tensor([1.0]))
        s = float(fq.scale)
        fq.eval()
        fq(torch.tensor([100.0]))
        assert float(fq.scale) == s

    @pytest.mark.parametrize("cls", ["FakeQuantMovingAverage",
                                     "MovingAverageAbsMaxScale"])
    def test_buffers_after_steps_as_jax(self, cls):
        rng = np.random.RandomState(1)
        jo, to = getattr(jslim, cls)(moving_rate=0.8), getattr(slim, cls)(
            moving_rate=0.8)
        jo.train()
        to.train()
        assert [n for n, _ in to.named_buffers()] == [
            n for n, _ in jo.named_buffers()] == ["_scale", "_state",
                                                  "_accum"]
        for step in range(6):
            x = (rng.randn(3, 7) * (step + 1)).astype(np.float32)
            jy, ty = jo(jnp.asarray(x)), to(_t(x))
            np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        for name, b in to.named_buffers():
            assert b.dtype == torch.float32 and tuple(b.shape) == (1,)
            np.testing.assert_allclose(
                b.numpy(), np.asarray(getattr(jo, name).value), rtol=1e-6)


# -- QAT wrappers against JAX ---------------------------------------------
@pytest.mark.parametrize("wq", ["abs_max", "channel_wise_abs_max",
                                "moving_average_abs_max"])
def test_quantized_linear_forward_buffers_and_gradients_as_jax(wq):
    jpt.seed(5)
    jlin = jnn.Linear(6, 5)
    tlin = _bridge(jlin, nn.Linear(6, 5))
    jq = jslim.QuantizedLinear(jlin, weight_quantize_type=wq)
    tq = QuantizedLinear(tlin, weight_quantize_type=wq)
    assert sorted(k for k, _ in tq.named_parameters()) == sorted(
        _arrays(jq)) == ["_inner.bias", "_inner.weight"]
    assert tq._inner is tlin and tq._inner.weight is tlin.weight  # shared
    assert sorted(k for k, _ in tq.named_buffers()) == sorted(_buffers(jq))
    rng = np.random.RandomState(2)
    params = {k: p.value for k, p in jq.named_parameters()}
    for step in range(3):
        x = rng.uniform(-2, 2, (4, 6)).astype(np.float32)
        g = rng.randn(4, 5).astype(np.float32)

        def f(params, x):
            out, bufs = functional_call(jq, params, x, training=True,
                                        return_buffers=True)
            return jnp.sum(out * g), (out, bufs)

        (_, (jout, jbufs)), (jgp, jgx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        for name, v in jbufs.items():  # the functional call's buffer updates
            getattr(jq, name.split(".")[0]).__getattr__(
                name.split(".")[1]).value = v
        tq.train()
        tx = _t(x).requires_grad_()
        for p in tq.parameters():
            p.grad = None
        tout = tq(tx)
        (tout * _t(g)).sum().backward()
        np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                                   rtol=0, atol=1e-5 * float(
                                       np.abs(jgx).max()))
        for name, p in tq.named_parameters():
            want = np.asarray(jgp[name])
            np.testing.assert_allclose(
                _np(p.grad), want, rtol=0,
                atol=1e-5 * max(float(np.abs(want).max()), 1e-12))
    for name, b in tq.named_buffers():
        np.testing.assert_allclose(b.numpy(), _buffers(jq)[name], rtol=1e-6)
    tq.eval()
    jq.eval()
    x = rng.uniform(-2, 2, (4, 6)).astype(np.float32)
    np.testing.assert_allclose(_np(tq(_t(x))), np.asarray(jq(jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("kw,fmt", [
    (dict(), "NCHW"),
    (dict(stride=2, padding=1), "NHWC"),
    (dict(groups=4, padding="SAME"), "NCHW"),
    (dict(dilation=2, padding=2), "NHWC"),
])
def test_quantized_conv2d_forward_and_buffers_as_jax(kw, fmt):
    jpt.seed(6)
    jc = jnn.Conv2D(4, 8, 3, data_format=fmt, **kw)
    tc = _bridge(jc, nn.Conv2D(4, 8, 3, data_format=fmt, **kw))
    jq = jslim.QuantizedConv2D(jc)
    tq = QuantizedConv2D(tc)
    rng = np.random.RandomState(3)
    shape = (2, 4, 9, 9) if fmt == "NCHW" else (2, 9, 9, 4)
    tq.train()
    jq.train()
    for _ in range(3):
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        np.testing.assert_allclose(_np(tq(_t(x))),
                                   np.asarray(jq(jnp.asarray(x))), **TOL)
    for name, b in tq.named_buffers():
        np.testing.assert_allclose(b.numpy(), _buffers(jq)[name], rtol=1e-6)


# -- tests/test_slim.py, mirrored ------------------------------------------
class TestImperativeQuantAware:
    def test_wraps_layers_in_place(self):
        m = _mlp()
        ImperativeQuantAware().quantize(m)
        assert isinstance(m[0], QuantizedLinear)
        assert isinstance(m[2], QuantizedLinear)
        c = _cnn()
        ImperativeQuantAware().quantize(c)
        assert isinstance(c[0], QuantizedConv2D)

    def test_qat_close_to_float(self):
        tpt.seed(0)
        m = _mlp()
        rng = np.random.RandomState(0)
        x = _t(rng.uniform(-1, 1, (16, 8)).astype(np.float32))
        m.eval()
        with torch.no_grad():
            ref = m(x)
            ImperativeQuantAware().quantize(m)
            m.train()
            m(x)
            m.eval()
            out = m(x)
        assert float((out - ref).abs().max()) < 0.1 * float(
            ref.abs().max()) + 0.05

    def test_qat_trains(self):
        tpt.seed(1)
        m = _mlp()
        ImperativeQuantAware().quantize(m)
        rng = np.random.RandomState(1)
        x = rng.uniform(-1, 1, (64, 8)).astype(np.float32)
        w = rng.uniform(-1, 1, (8, 4)).astype(np.float32)
        y = x @ w
        model = tpt.Model(m, inputs=["x"], labels=["y"])
        model.prepare(optimizer=topt.Adam(learning_rate=0.01,
                                          parameters=m.parameters()),
                      loss=nn.MSELoss())
        losses = [float(model.train_batch([x], [y])[0]) for _ in range(60)]
        assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])

    def test_convert_to_int8(self):
        tpt.seed(2)
        m = _mlp()
        qat = ImperativeQuantAware()
        qat.quantize(m)
        rng = np.random.RandomState(2)
        x = _t(rng.uniform(-1, 1, (32, 8)).astype(np.float32))
        with torch.no_grad():
            m.train()
            for _ in range(5):
                m(x)
            m.eval()
            ref = m(x)
            qat.convert(m)
            assert isinstance(m[0], Int8Linear)
            out = m(x)
        assert float((out - ref).abs().max()) < 0.1 * float(
            ref.abs().max()) + 0.05

    def test_quantize_and_convert_as_jax(self):
        """A bridged MLP through QAT training-mode calls and convert in
        both packages: the same activation scales, int8 weights and
        outputs."""
        jm, tm = _mlp_pair(7)
        jslim.ImperativeQuantAware().quantize(jm)
        ImperativeQuantAware().quantize(tm)
        assert [n for n, _ in tm.named_sublayers()] == [
            n for n, _ in jm.named_sublayers()]
        rng = np.random.RandomState(7)
        jm.train()
        tm.train()
        for _ in range(4):
            x = rng.uniform(-1, 1, (8, 8)).astype(np.float32)
            jm(jnp.asarray(x))
            with torch.no_grad():
                tm(_t(x))
        jslim.ImperativeQuantAware().convert(jm)
        ImperativeQuantAware().convert(tm)
        for i in (0, 2):
            assert tm[i].act_scale == pytest.approx(jm[i].act_scale,
                                                    rel=1e-6)
            np.testing.assert_array_equal(tm[i].w_q.numpy(),
                                          np.asarray(jm[i].w_q.value))
        x = rng.uniform(-1, 1, (8, 8)).astype(np.float32)
        with torch.no_grad():
            np.testing.assert_allclose(_np(tm(_t(x))),
                                       np.asarray(jm(jnp.asarray(x))),
                                       rtol=1e-5, atol=1e-5)

    def test_parallel_linears_are_not_wrapped_as_in_jax(self):
        from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny

        m = GPTForCausalLM(gpt_tiny(), device="cpu")
        ImperativeQuantAware().quantize(m)
        kinds = {type(layer).__name__ for _, layer in m.named_sublayers()}
        assert "QuantizedLinear" not in kinds
        assert "ColumnParallelLinear" in kinds

    def test_refusals(self):
        with pytest.raises(InvalidArgumentError, match="channel-wise"):
            ImperativeQuantAware(
                activation_quantize_type="channel_wise_abs_max")
        with pytest.raises(InvalidArgumentError, match="weight_quantize"):
            ImperativeQuantAware(weight_quantize_type="kl").quantize(_mlp())
        with pytest.raises(InvalidArgumentError, match="activation"):
            ImperativeQuantAware(activation_quantize_type="kl").quantize(
                _mlp())


class TestQuantizedLeNet:
    def test_lenet_qat_and_ptq_within_tolerance(self):
        tpt.seed(9)
        rng = np.random.RandomState(9)
        x = _t(rng.uniform(0, 1, (8, 1, 28, 28)).astype(np.float32))
        net = tvm.LeNet(device="cpu")
        net.eval()
        with torch.no_grad():
            ref = net(x)
        ptq = PostTrainingQuantization(net)
        ptq.collect(x)
        qnet = ptq.quantize()
        with torch.no_grad():
            out = qnet(x)
        assert float((out - ref).abs().max()) < 0.1 * float(
            ref.abs().max()) + 0.05
        kinds = [type(layer) for _, layer in qnet.named_sublayers()]
        assert Int8Conv2D in kinds and Int8Linear in kinds

    def test_lenet_ptq_as_jax(self):
        """The bridged LeNet through PTQ in both packages: equal scales,
        equal int8 weights, logits within 1e-5 (the same codes; float32
        sums of exact integers)."""
        jpt.seed(10)
        jnet = jvm.LeNet()
        jnet.eval()
        tnet = _bridge(jnet, tvm.LeNet(device="cpu")).eval()
        rng = np.random.RandomState(10)
        calib = [rng.uniform(0, 1, (4, 1, 28, 28)).astype(np.float32)
                 for _ in range(3)]
        for algo in ("abs_max", "avg"):
            jptq = jslim.PostTrainingQuantization(jnet, algo=algo)
            tptq = PostTrainingQuantization(tnet, algo=algo)
            for b in calib:
                jptq.collect(jnp.asarray(b))
                tptq.collect(_t(b))
            assert set(tptq._stats) == set(jptq._stats)
            for name, vals in jptq._stats.items():
                np.testing.assert_allclose(tptq._stats[name], vals,
                                           rtol=1e-6)
            if algo == "avg":
                break
            jq, tq = jptq.quantize(), tptq.quantize()
            for (jn, jl), (tn, tl) in zip(jq.named_sublayers(),
                                          tq.named_sublayers()):
                assert jn == tn and type(jl).__name__ == type(tl).__name__
                if isinstance(tl, (Int8Conv2D, Int8Linear)):
                    assert tl.act_scale == pytest.approx(jl.act_scale,
                                                         rel=1e-6)
                    np.testing.assert_array_equal(
                        tl.w_q.numpy(), np.asarray(jl.w_q.value))
            x = calib[0]
            with torch.no_grad():
                np.testing.assert_allclose(_np(tq(_t(x))),
                                           np.asarray(jq(jnp.asarray(x))),
                                           rtol=1e-5, atol=1e-5)
            # fresh float models for the avg round
            jpt.seed(10)
            jnet = jvm.LeNet()
            jnet.eval()
            tnet = _bridge(jnet, tvm.LeNet(device="cpu")).eval()


class TestPostTrainingQuantization:
    def test_ptq_linear_close_to_float(self):
        tpt.seed(3)
        m = _mlp()
        rng = np.random.RandomState(3)
        calib = [_t(rng.uniform(-1, 1, (16, 8)).astype(np.float32))
                 for _ in range(4)]
        m.eval()
        with torch.no_grad():
            ref = m(calib[0])
        ptq = PostTrainingQuantization(m)
        for b in calib:
            ptq.collect(b)
        qm = ptq.quantize()
        with torch.no_grad():
            out = qm(calib[0])
        assert float((out - ref).abs().max()) < 0.1 * float(
            ref.abs().max()) + 0.05

    def test_ptq_conv(self):
        tpt.seed(4)
        m = _cnn()
        rng = np.random.RandomState(4)
        x = _t(rng.uniform(-1, 1, (2, 1, 8, 8)).astype(np.float32))
        m.eval()
        with torch.no_grad():
            ref = m(x)
        ptq = PostTrainingQuantization(m)
        ptq.collect(x)
        qm = ptq.quantize()
        with torch.no_grad():
            out = qm(x)
        assert float((out - ref).abs().max()) < 0.15 * float(
            ref.abs().max()) + 0.05

    def test_no_calibration_raises(self):
        ptq = PostTrainingQuantization(_mlp())
        with pytest.raises(InvalidArgumentError, match="no calibration"):
            ptq.quantize()

    def test_refusals(self):
        with pytest.raises(InvalidArgumentError, match="KL"):
            PostTrainingQuantization(_mlp(), algo="KL")
        with pytest.raises(InvalidArgumentError, match="8-bit"):
            PostTrainingQuantization(_mlp(), activation_bits=4)

    def test_collect_reads_the_maxima_in_one_transfer(self, monkeypatch):
        m = _mlp()
        ptq = PostTrainingQuantization(m)
        copies = []
        real = torch.Tensor.cpu

        def counted(t, *a, **k):
            copies.append(tuple(t.shape))
            return real(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "cpu", counted)
        ptq.collect(torch.ones(3, 8))
        assert copies == [(2,)]  # both layers' maxima, one copy
        assert ptq._pending == {} and len(ptq._stats) == 2


class TestInt8Numerics:
    def test_int8_linear_3d_input(self):
        rng = np.random.RandomState(8)
        lin = nn.Linear(6, 3)
        x = _t(rng.uniform(-1, 1, (2, 4, 6)).astype(np.float32))
        q = Int8Linear.from_float(lin, float(x.abs().max()))
        with torch.no_grad():
            out, ref = q(x), lin(x)
        assert out.shape == ref.shape
        assert float((out - ref).abs().max()) < 0.1 * float(
            ref.abs().max()) + 0.05

    def test_convert_untrained_observer_rejected(self):
        m = _mlp()
        qat = ImperativeQuantAware()
        qat.quantize(m)
        with pytest.raises(InvalidArgumentError, match="never saw data"):
            qat.convert(m)

    def test_zero_act_scale_no_nan(self):
        lin = nn.Linear(4, 2)
        q = Int8Linear.from_float(lin, 0.0)
        assert torch.isfinite(q(torch.zeros(3, 4))).all()

    def test_convert_abs_max_activation_rejected(self):
        m = _mlp()
        qat = ImperativeQuantAware(activation_quantize_type="abs_max")
        qat.quantize(m)
        with pytest.raises(InvalidArgumentError,
                           match="moving_average_abs_max"):
            qat.convert(m)

    def test_int8_matmul_int32_accumulate(self):
        rng = np.random.RandomState(5)
        lin = nn.Linear(6, 3)
        x = rng.uniform(-1, 1, (4, 6)).astype(np.float32)
        act_scale = float(np.abs(x).max())
        q = Int8Linear.from_float(lin, act_scale)
        out = _np(q(_t(x)))
        wq = q.w_q.numpy().astype(np.int32)
        ws = q.w_scale.numpy()
        xq = np.clip(np.round(x / act_scale * 127), -127,
                     127).astype(np.int32)
        exp = (xq @ wq).astype(np.float32) * (ws.reshape(1, -1)
                                              * act_scale / (127 * 127))
        exp = exp + _np(lin.bias)
        np.testing.assert_allclose(out, exp, rtol=1e-5, atol=1e-5)

    def test_quantize_to_int8_channel_wise(self):
        rng = np.random.RandomState(6)
        w = rng.uniform(-2, 2, (5, 7)).astype(np.float32)
        q, s = quantize_to_int8(_t(w), channel_axis=1)
        assert q.dtype == torch.int8
        recon = q.float().numpy() * s.numpy() / 127
        np.testing.assert_allclose(recon, w,
                                   atol=np.abs(w).max() / 127 + 1e-6)


class TestQuantizedWeightExport:
    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    def test_quantize_model_trees_as_jax(self, mode):
        """Non-mutating trees: the codes and scales of JAX's, unit scale
        buffers registered on the model, its weights still float and its
        float forward unchanged."""
        from paddle_tpu.models import gpt as jgpt
        from paddle_tpu_torch.models import gpt as tgpt

        jpt.seed(12)
        jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
        tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu").eval()
        load_jax_params(tm, _arrays(jm))
        ids = torch.arange(9)[None]
        with torch.no_grad():
            before = tm(ids)
        jp, jb = jslim.quantize_model_trees(jm, mode)
        tp, tb = slim.quantize_model_trees(tm, mode)
        assert set(tp) == set(jp) and set(tb) == set(jb)
        for name, t in tp.items():
            a = np.asarray(jp[name])
            if t.dtype in (torch.int8, torch.float8_e4m3fn):
                np.testing.assert_array_equal(
                    t.contiguous().view(torch.uint8).numpy(),
                    a.view(np.uint8))
            else:
                np.testing.assert_array_equal(_np(t), a.astype(np.float32))
        for name, t in tb.items():
            np.testing.assert_array_equal(_np(t), np.asarray(jb[name]))
        qkv = tm.gpt.blocks[0].attn.qkv
        assert qkv.weight.dtype == torch.float32
        assert torch.equal(qkv.weight_scale, torch.ones(96))
        with torch.no_grad():
            assert torch.equal(tm(ids), before)  # the scales are not read
        served = slim.quantize_model(tm, mode)  # and quantizing still works
        assert served.gpt.blocks[0].attn.qkv.weight.dtype != torch.float32


# -- int8 layers against the JAX ones ----------------------------------------
@pytest.mark.parametrize("shape", [(5, 6), (2, 3, 6)])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_codes_and_outputs_as_jax(shape, bias):
    jpt.seed(14)
    jlin = jnn.Linear(6, 7, bias_attr=None if bias else False)
    tlin = _bridge(jlin, nn.Linear(6, 7, bias_attr=None if bias else False))
    rng = np.random.RandomState(14)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    act = float(np.abs(x).max()) * 0.8  # some codes clip
    jq = jslim.Int8Linear.from_float(jlin, act)
    tq = Int8Linear.from_float(tlin, act)
    assert sorted(k for k, _ in tq.named_buffers()) == sorted(_buffers(jq))
    for name, b in tq.named_buffers():
        np.testing.assert_array_equal(b.numpy(), _buffers(jq)[name])
    from paddle_tpu_torch.slim.quantization import _act_codes

    want_codes = np.clip(np.round(jnp.asarray(x) / jnp.float32(act)
                                  * 127.0), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(_act_codes(_t(x), act).numpy(),
                                  want_codes)
    np.testing.assert_allclose(_np(tq(_t(x))), np.asarray(jq(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cin,cout,groups,kw,fmt", [
    (4, 6, 1, dict(padding=1), "NCHW"),
    (4, 6, 1, dict(padding=1), "NHWC"),
    (4, 6, 1, dict(stride=2, padding=[1, 0, 2, 1]), "NCHW"),
    (4, 6, 1, dict(dilation=2, padding="SAME"), "NHWC"),
    (6, 6, 6, dict(padding=1), "NCHW"),           # depthwise
    (6, 6, 6, dict(stride=2, padding=1), "NHWC"),  # depthwise, strided
    (6, 12, 3, dict(padding="VALID"), "NCHW"),    # grouped
])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_conv2d_codes_and_outputs_as_jax(cin, cout, groups, kw, fmt,
                                              bias):
    jpt.seed(15)
    args = (cin, cout, 3)
    ckw = dict(groups=groups, data_format=fmt,
               bias_attr=None if bias else False, **kw)
    jc = jnn.Conv2D(*args, **ckw)
    tc = _bridge(jc, nn.Conv2D(*args, **ckw))
    rng = np.random.RandomState(15)
    shape = (2, cin, 9, 10) if fmt == "NCHW" else (2, 9, 10, cin)
    x = (rng.randn(*shape)).astype(np.float32)
    act = float(np.abs(x).max())
    jq = jslim.Int8Conv2D.from_float(jc, act)
    tq = Int8Conv2D.from_float(tc, act)
    for name, b in tq.named_buffers():
        np.testing.assert_array_equal(b.numpy(), _buffers(jq)[name])
    want = np.asarray(jq(jnp.asarray(x)))
    launches = tqm.quantized_linear.launches
    got = _np(tq(_t(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tqm.quantized_linear.launches == launches  # the CPU never counts


def test_int8_conv2d_group_wider_than_the_exact_route_raises():
    conv = nn.Conv2D(2 * 130, 2, 3, groups=2)  # 130 x 9 inputs a group
    q = Int8Conv2D.from_float(conv, 1.0)
    with pytest.raises(InvalidArgumentError, match="exact float32 route"):
        q(torch.ones(1, 260, 4, 4))


def test_int8_conv2d_bfloat16_model_returns_bfloat16():
    conv = nn.Conv2D(3, 4, 3, padding=1, data_format="NHWC")
    conv.to(torch.bfloat16)
    q = Int8Conv2D.from_float(conv, 1.0)
    out = q(torch.rand(1, 5, 5, 3, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 5, 5, 4)


# -- finding: QAT over a bottleneck ResNet -----------------------------------
def test_qat_bottleneck_resnet_raises_in_training_in_both_packages():
    """``BottleneckBlock._fused_tail`` reads ``conv3.data_format``, which a
    ``QuantizedConv2D`` lacks: in training mode the JAX package raises
    ``AttributeError``, and the port keeps the JAX behaviour; in eval mode
    the gate is closed before the read and both run."""
    jpt.seed(16)
    jblock = jvm.resnet.BottleneckBlock(16, 4, data_format="NHWC")
    tblock = tvm.BottleneckBlock(16, 4, data_format="NHWC")
    jslim.ImperativeQuantAware().quantize(jblock)
    ImperativeQuantAware().quantize(tblock)
    x = np.random.RandomState(16).rand(2, 5, 5, 16).astype(np.float32)
    jblock.train()
    tblock.train()
    with pytest.raises(AttributeError, match="data_format"):
        jblock(jnp.asarray(x))
    with pytest.raises(AttributeError, match="data_format"):
        tblock(_t(x))
    jblock.eval()
    tblock.eval()
    assert np.asarray(jblock(jnp.asarray(x))).shape == (2, 5, 5, 16)
    with torch.no_grad():
        assert tblock(_t(x)).shape == (2, 5, 5, 16)


def test_slim_exports_the_jax_names():
    assert set(jslim.__all__) <= set(slim.__all__)
    assert len(jslim.__all__) == 16
    for name in jslim.__all__:
        assert hasattr(slim, name), name


# -- on the card --------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 9 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("groups", [1, 32])
def test_int8_conv_routes_on_card_bit_equal_to_plain(fmt, groups):
    dev = _card()
    conv = nn.Conv2D(64, 64, 3, stride=2, padding=1, groups=groups,
                     data_format=fmt)
    q = Int8Conv2D.from_float(conv, 2.0)
    rng = np.random.RandomState(groups)
    shape = (4, 64, 28, 28) if fmt == "NCHW" else (4, 28, 28, 64)
    x = _t(rng.randn(*shape).astype(np.float32))
    want = q(x)
    q.to(dev)
    launches = tqm.quantized_linear.launches
    got = q(x.to(dev))
    torch.cuda.synchronize()
    assert tqm.quantized_linear.launches == launches + (groups == 1)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_int8_linear_on_card_bit_equal_to_plain():
    dev = _card()
    lin = nn.Linear(768, 3072)
    x = _t(np.random.RandomState(1).randn(4, 128, 768).astype(np.float32))
    q = Int8Linear.from_float(lin, 3.0)
    want = q(x)
    q.to(dev)
    launches = tqm.quantized_linear.launches
    got = q(x.to(dev))
    torch.cuda.synchronize()
    assert tqm.quantized_linear.launches == launches + 1
    assert torch.equal(got.cpu(), want)
