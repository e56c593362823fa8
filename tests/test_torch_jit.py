"""paddle_tpu_torch.jit held against paddle_tpu.jit.

Ports tests/test_jit_averaging.py::TestToStatic and
tests/test_static_jit_utils.py::TestJit.  ``to_static`` runs the layer
eagerly in the port (the eager module is the counterpart of the compiled
one): outputs equal the JAX compiled call's on bridged weights within
1e-6 (f32), parameters stay live, BatchNorm's statistics update,
``run_steps`` equals the JAX scanned chain step for step, and ``save`` /
``load`` / ``TracedLayer`` ride the port's ``torch.export`` artifact.  A
Python branch on a tensor's value runs eagerly, and its export raises
``UnimplementedError`` (no dy2static transpiler yet).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn

import paddle_tpu_torch as tpt
from paddle_tpu_torch import jit, nn
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)
from paddle_tpu_torch.static import InputSpec

TOL = dict(rtol=1e-6, atol=1e-6)


def _pair():
    jpt.seed(0)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    tm = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    load_jax_params(tm, {k: np.asarray(p.value)
                         for k, p in jm.named_parameters()})
    return jm, tm


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class TestToStatic:
    def test_layer_output_parity(self):
        jm, tm = _pair()
        jm.eval()
        tm.eval()
        x = _x(6, 4)
        want = np.asarray(jjit.to_static(jm)(jnp.asarray(x)))
        with torch.no_grad():
            got = jit.to_static(tm)(_t(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)

    def test_params_stay_live_through_training(self):
        """to_static sees updated weights (no baked constants)."""
        _, tm = _pair()
        static_net = jit.to_static(tm)
        x = torch.ones(2, 4)
        with torch.no_grad():
            before = static_net(x).numpy()
            for _, p in tm.named_parameters():
                p.mul_(0.0)
            after = static_net(x).numpy()
        assert not np.allclose(before, after)
        np.testing.assert_allclose(after, 0.0, atol=1e-6)

    def test_bn_buffers_update_eagerly(self):
        jpt.seed(0)
        jm = jnn.Sequential(jnn.Linear(4, 3), jnn.BatchNorm1D(3))
        tm = nn.Sequential(nn.Linear(4, 3), nn.BatchNorm1D(3))
        load_jax_params(tm, {k: np.asarray(p.value)
                             for k, p in jm.named_parameters()})
        jm.train()
        tm.train()
        x = _x(8, 4)
        jjit.to_static(jm)(jnp.asarray(x))
        before = tm[1]._mean.detach().clone()
        jit.to_static(tm)(_t(x))
        assert not torch.equal(tm[1]._mean, before)
        np.testing.assert_allclose(tm[1]._mean.detach().numpy(),
                                   np.asarray(jm[1]._mean.value), **TOL)
        np.testing.assert_allclose(tm[1]._variance.detach().numpy(),
                                   np.asarray(jm[1]._variance.value),
                                   rtol=1e-5, atol=1e-6)

    def test_pure_function(self):
        f = jit.to_static(lambda a, b: a * 2 + b)
        np.testing.assert_allclose(f(torch.ones(3), torch.ones(3)).numpy(),
                                   3.0)

    def test_method_decorator_binds_per_instance(self):
        class Net(nn.Layer):
            def __init__(self, scale):
                super().__init__()
                self.scale = scale

            @jit.to_static
            def forward(self, x):
                return x * self.scale

        a, b = Net(2.0), Net(3.0)
        x = torch.ones(2)
        np.testing.assert_allclose(a(x).numpy(), 2.0)
        np.testing.assert_allclose(b(x).numpy(), 3.0)
        assert a.forward is a.forward  # one wrapper per instance

    def test_decorator_with_spec_and_save_load(self, tmp_path):
        _, tm = _pair()
        wrapped = jit.to_static(tm, input_spec=[InputSpec([None, 4],
                                                          "float32")])
        prefix = os.path.join(tmp_path, "m")
        jit.save(wrapped, prefix)
        loaded = jit.load(prefix, device="cpu")
        x = _x(3, 4, seed=1)
        with torch.no_grad():
            want = tm.eval()(_t(x)).numpy()
        np.testing.assert_allclose(loaded(x).numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        assert loaded.eval() is loaded
        with pytest.raises(InvalidArgumentError, match="eval-only"):
            loaded.train()

    def test_save_without_spec_raises(self, tmp_path):
        _, tm = _pair()
        with pytest.raises(InvalidArgumentError, match="input_spec"):
            jit.save(tm, os.path.join(tmp_path, "m"))
        with pytest.raises(InvalidArgumentError, match="exports Layers"):
            jit.save(jit.to_static(lambda x: x),
                     os.path.join(tmp_path, "f"),
                     input_spec=[InputSpec([None, 4], "float32")])

    @pytest.mark.parametrize("fetch_every", [1, 2])
    def test_run_steps_matches_jax_chain(self, fetch_every):
        """N steps over stacked inputs, buffers carried: the JAX scanned
        chain step for step (a BatchNorm's statistics move every step)."""
        jpt.seed(1)
        jm = jnn.Sequential(jnn.Linear(4, 3), jnn.BatchNorm1D(3))
        tm = nn.Sequential(nn.Linear(4, 3), nn.BatchNorm1D(3))
        load_jax_params(tm, {k: np.asarray(p.value)
                             for k, p in jm.named_parameters()})
        xs = _x(4, 6, 4, seed=2)
        want = np.asarray(jjit.to_static(jm).run_steps(
            jnp.asarray(xs), fetch_every=fetch_every))
        got = jit.to_static(tm)(_t(xs), iterations=4,
                                fetch_every=fetch_every)
        assert tuple(got.shape) == want.shape == (4 // fetch_every, 6, 3)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tm[1]._mean.detach().numpy(),
                                   np.asarray(jm[1]._mean.value),
                                   rtol=1e-5, atol=1e-6)

    def test_run_steps_argument_errors(self):
        f = jit.to_static(lambda a: a + 1)
        with pytest.raises(InvalidArgumentError, match="fetch_every"):
            f.run_steps(torch.ones(2, 3), fetch_every=0)
        with pytest.raises(InvalidArgumentError, match="iterations"):
            f.run_steps(1.0)
        with pytest.raises(InvalidArgumentError, match="leading dim"):
            f.run_steps(torch.ones(2, 3), iterations=3)
        np.testing.assert_allclose(f.run_steps(torch.zeros(3, 2)).numpy(),
                                   1.0)


class TestJit:
    def test_program_translator_toggle(self):
        tpt.seed(1)
        lin = nn.Linear(4, 2)
        compiled = jit.to_static(lin)
        x = torch.ones(2, 4)
        with torch.no_grad():
            want = compiled(x).numpy()
        pt = jit.ProgramTranslator.get_instance()
        assert pt is jit.ProgramTranslator()
        try:
            pt.enable(False)
            assert not pt.enable_to_static
            with torch.no_grad():
                np.testing.assert_allclose(compiled(x).numpy(), want,
                                           atol=1e-6)
        finally:
            pt.enable(True)
        assert pt.enable_to_static
        with pytest.raises(InvalidArgumentError, match="bool"):
            pt.enable(1)

    def test_traced_layer_roundtrip(self, tmp_path):
        tpt.seed(2)
        net = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
        net.eval()
        x = torch.from_numpy(_x(3, 4))
        with torch.no_grad():
            out, traced = jit.TracedLayer.trace(net, [x])
            np.testing.assert_allclose(traced(x).numpy(), out.numpy(),
                                       atol=1e-6)
        path = str(tmp_path / "traced")
        traced.save_inference_model(path)
        loaded = jit.load(path, device="cpu")
        np.testing.assert_allclose(loaded(x.numpy()).numpy(), out.numpy(),
                                   atol=1e-5)
        with pytest.raises(InvalidArgumentError, match="expects a Layer"):
            jit.TracedLayer.trace(lambda v: v, [x])

    def test_verbosity_noops(self):
        jit.set_code_level(50)
        assert jit.get_code_level() == 50
        jit.set_verbosity(3)
        assert jit.get_code_level() == 3
        jit.set_code_level(0)
        assert jit.not_to_static(len) is len


def test_tensor_branch_runs_eagerly_and_does_not_export(tmp_path):
    """A Python ``if`` on a tensor: eager through to_static (both
    branches), and jit.save raises citing the dy2static transpiler."""
    tpt.seed(0)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.pos = nn.Linear(4, 4)
            self.neg = nn.Linear(4, 4)

        def forward(self, x):
            if x.mean() > 0:
                return self.pos(x)
            return self.neg(x) * 2.0

    net = Net()
    compiled = jit.to_static(net)
    with torch.no_grad():
        for v in (0.5, -0.5):
            x = torch.full((2, 4), v)
            np.testing.assert_array_equal(compiled(x).numpy(),
                                          net(x).numpy())
    with pytest.raises(UnimplementedError, match="dy2static"):
        jit.save(compiled, os.path.join(tmp_path, "m"),
                 input_spec=[InputSpec([None, 4], "float32")])


def test_fluid_dygraph_jit_names_are_the_ports():
    from paddle_tpu_torch.fluid import dygraph

    assert dygraph.jit is jit
    assert dygraph.declarative is jit.to_static
    assert dygraph.ProgramTranslator is jit.ProgramTranslator
    assert dygraph.TracedLayer is jit.TracedLayer
    assert tpt.jit is jit
