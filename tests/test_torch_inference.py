"""The port's inference export (paddle_tpu_torch.inference) held against
the live port layers and the JAX package's export.

Ports the cases of tests/test_inference.py (save → load → run, batch
polymorphism, eval-mode export, weights riding in ``.pdiparams``,
``Model.save(training=False)``, the error paths), tests/test_slim.py::
TestInt8Export, tests/test_paddle_export.py::TestInferenceModelLayout and
tests/test_capi.py.  Parity with the live layer is held at 1e-6 (f32, as
tests/test_inference.py:49); the port's Predictor on a ``.pdiparams`` the
JAX package wrote against the JAX Predictor at rtol 1e-4 / atol 1e-5
(two frameworks' f32 matmuls summed in other orders).  The exported
graphs keep kernels 2, 4 and 9 as custom operators; on the CPU each runs
its plain version.  Tests marked ``gpu`` run the Predictor on the card
against the eager model there, with the kernels' launch counts.
"""
import importlib
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import inference as jinf
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.mesh import suppress_constraints
from paddle_tpu.framework.paddle_import import (
    load_reference_state_dict as jax_load_reference_state_dict)
from paddle_tpu.models import bert as jbert
from paddle_tpu.static import InputSpec as JInputSpec

import paddle_tpu_torch as tpt
from paddle_tpu_torch import nn
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework import serialization
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               NotFoundError,
                                               UnavailableError,
                                               UnimplementedError)
from paddle_tpu_torch.framework.paddle_format import (
    load_reference_state_dict, parse_program_persistables,
    save_reference_inference_model)
from paddle_tpu_torch.inference import (Config, Predictor, create_predictor,
                                        load_inference_model,
                                        save_inference_model)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import flash_attention, flash_attention_ref
from paddle_tpu_torch.ops import fused_layernorm
from paddle_tpu_torch.static import InputSpec, make_symbols
from paddle_tpu_torch.vision.models import LeNet

# the module (the package exports a function of the same name)
qmm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
LIVE = dict(rtol=1e-6, atol=1e-6)
CROSS = dict(rtol=1e-4, atol=1e-5)


def _mlp():
    tpt.seed(0)
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def _live(net, *xs):
    with torch.no_grad():
        out = net(*[torch.as_tensor(x) for x in xs])
    return out.numpy()


def _ops_in(pred):
    return {str(n.target).split(".")[1] for n in pred._module.graph.nodes
            if str(n.target).startswith("paddle_tpu_torch.")}


def _export_mlp(tmp_path, name="mlp"):
    net = _mlp()
    prefix = os.path.join(tmp_path, name)
    save_inference_model(prefix, net, [InputSpec([None, 8], "float32")],
                         platforms=("cpu",))
    return prefix, net


class TestSaveLoad:
    def test_round_trip_output_parity(self, tmp_path):
        prefix, net = _export_mlp(tmp_path)
        x = np.random.RandomState(0).randn(6, 8).astype(np.float32)
        assert os.path.exists(prefix + ".pdmodel")
        assert os.path.exists(prefix + ".pdiparams")
        (got,) = load_inference_model(prefix, device="cpu").run([x])
        np.testing.assert_allclose(got, _live(net, x), **LIVE)

    @pytest.mark.parametrize("batch", [1, 3, 17])
    def test_batch_polymorphic(self, tmp_path, batch):
        prefix, net = _export_mlp(tmp_path)
        pred = load_inference_model(prefix, device="cpu")
        x = np.random.RandomState(batch).randn(batch, 8).astype(np.float32)
        (out,) = pred.run([x])
        assert out.shape == (batch, 4)
        np.testing.assert_allclose(out, _live(net, x), **LIVE)

    def test_export_is_eval_mode(self, tmp_path):
        """Dropout is off in the exported graph though the layer was in
        train mode at save time, and the training flag is restored."""
        tpt.seed(0)
        net = nn.Sequential(nn.Linear(4, 4), nn.Dropout(0.9))
        net.train()
        prefix = os.path.join(tmp_path, "drop")
        save_inference_model(prefix, net, [InputSpec([None, 4], "float32")],
                             platforms=("cpu",))
        assert net.training and net[1].training  # restored
        pred = load_inference_model(prefix, device="cpu")
        x = np.ones((5, 4), np.float32)
        a, b = pred.run([x])[0], pred.run([x])[0]
        np.testing.assert_array_equal(a, b)
        net.eval()
        np.testing.assert_allclose(a, _live(net, x), **LIVE)

    def test_weights_ride_separately(self, tmp_path):
        """A zeroed ``.pdiparams`` gives zeros, without re-export; the
        ``.pdmodel`` holds no parameter bytes."""
        prefix, net = _export_mlp(tmp_path)
        x = np.random.RandomState(1).randn(2, 8).astype(np.float32)
        (before,) = load_inference_model(prefix, device="cpu").run([x])
        state = serialization.load(prefix + ".pdiparams")
        state["params"] = {k: np.zeros_like(v)
                           for k, v in state["params"].items()}
        serialization.save(state, prefix + ".pdiparams")
        (after,) = load_inference_model(prefix, device="cpu").run([x])
        assert not np.allclose(before, after)
        np.testing.assert_allclose(after, 0.0, atol=1e-6)
        blob = open(prefix + ".pdmodel", "rb").read()
        w = net[0].weight.detach().numpy()
        assert w.tobytes()[:64] not in blob

    def test_conv_model_exports(self, tmp_path):
        tpt.seed(0)
        net = LeNet(device="cpu")
        net.eval()
        prefix = os.path.join(tmp_path, "lenet")
        save_inference_model(prefix, net,
                             [InputSpec([None, 1, 28, 28], "float32")],
                             platforms=("cpu",))
        x = np.random.RandomState(0).randn(2, 1, 28, 28).astype(np.float32)
        (out,) = load_inference_model(prefix, device="cpu").run([x])
        assert out.shape == (2, 10)
        np.testing.assert_allclose(out, _live(net, x), rtol=1e-5,
                                   atol=1e-6)

    def test_tensor_dependent_control_flow_does_not_export(self, tmp_path):
        class Branchy(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 4)

            def forward(self, x):
                if x.sum() > 0:
                    return self.fc(x)
                return -x

        with pytest.raises(UnimplementedError,
                           match="static graph and the long tail"):
            save_inference_model(os.path.join(tmp_path, "b"), Branchy(),
                                 [InputSpec([None, 4], "float32")])
        assert not os.path.exists(os.path.join(tmp_path, "b.pdmodel"))


class TestPredictorAPI:
    def test_config_create_predictor(self, tmp_path):
        prefix, _ = _export_mlp(tmp_path, "m")
        cfg = Config(prefix + ".pdmodel", prefix + ".pdiparams")
        cfg.disable_gpu()
        pred = create_predictor(cfg)
        assert pred.get_input_names() == ["x0"]
        assert pred.get_num_outputs() == 1
        assert pred.device == torch.device("cpu")

    def test_wrong_arity_raises(self, tmp_path):
        prefix, _ = _export_mlp(tmp_path, "m")
        pred = load_inference_model(prefix, device="cpu")
        with pytest.raises(InvalidArgumentError, match="takes 1 inputs"):
            pred.run([np.zeros((2, 8), np.float32)] * 2)

    def test_bad_magic_rejected(self, tmp_path):
        p = os.path.join(tmp_path, "junk.pdmodel")
        with open(p, "wb") as f:
            f.write(b"NOTAMODEL")
        with pytest.raises(InvalidArgumentError, match="bad magic"):
            Predictor(os.path.join(tmp_path, "junk"), device="cpu")

    def test_truncated_header_rejected(self, tmp_path):
        p = os.path.join(tmp_path, "trunc.pdmodel")
        with open(p, "wb") as f:
            f.write(b"PTTHIM01\x02")  # magic + half a length field
        with pytest.raises(InvalidArgumentError, match="truncated or corrupt"):
            Predictor(os.path.join(tmp_path, "trunc"), device="cpu")

    def test_missing_model_raises(self, tmp_path):
        with pytest.raises(NotFoundError):
            Predictor(os.path.join(tmp_path, "absent"), device="cpu")

    def test_separate_params_file_honored(self, tmp_path):
        prefix, net = _export_mlp(tmp_path, "m")
        other = os.path.join(tmp_path, "weights.pdiparams")
        os.rename(prefix + ".pdiparams", other)
        cfg = Config(prefix + ".pdmodel", other)
        cfg.disable_gpu()
        x = np.random.RandomState(2).randn(2, 8).astype(np.float32)
        (out,) = create_predictor(cfg).run([x])
        np.testing.assert_allclose(out, _live(net, x), **LIVE)

    def test_multi_input_multi_dynamic_dims(self, tmp_path):
        """Two inputs, each with a dynamic batch AND a dynamic feature-like
        dim, export under one symbolic scope (the shared name is one
        size)."""
        tpt.seed(0)

        class TwoIn(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(8, 4)

            def forward(self, a, b):
                return self.fc(a) + b.sum(axis=1, keepdim=True)

        net = TwoIn()
        specs = [InputSpec(["batch", 8], "float32", "a"),
                 InputSpec(["batch", None], "float32", "b")]
        syms = make_symbols(specs)
        assert sorted(syms) == ["batch", "d_b_1"]
        assert specs[0].dynamic_shape(syms)[0] is specs[1].dynamic_shape(
            syms)[0]
        prefix = os.path.join(tmp_path, "two")
        save_inference_model(prefix, net, specs, platforms=("cpu",))
        pred = load_inference_model(prefix, device="cpu")
        a = np.ones((3, 8), np.float32)
        b = np.ones((3, 5), np.float32)
        (out,) = pred.run([a, b])
        assert out.shape == (3, 4)
        np.testing.assert_allclose(out, _live(net, a, b), **LIVE)
        with pytest.raises(Exception):  # the shared size is enforced
            pred.run([a, np.ones((4, 5), np.float32)])

    def test_no_device_is_the_card(self, tmp_path, monkeypatch):
        """No fallback: without ``device=`` the Predictor runs on the
        card, and without one it raises."""
        prefix, _ = _export_mlp(tmp_path, "m")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(UnavailableError):
            Predictor(prefix)

    def test_unlisted_platform_refused(self, tmp_path):
        prefix, _ = _export_mlp(tmp_path, "m")
        state = open(prefix + ".pdmodel", "rb").read()
        with open(prefix + ".pdmodel", "wb") as f:
            f.write(state.replace(b'"platforms": ["cpu"]',
                                  b'"platforms": ["gpu"]'))
        with pytest.raises(InvalidArgumentError, match="exported for"):
            Predictor(prefix, device="cpu")

    def test_gpu_platform_needs_a_card(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(UnavailableError):
            save_inference_model(os.path.join(tmp_path, "g"), _mlp(),
                                 [InputSpec([None, 8], "float32")],
                                 platforms=("cpu", "gpu"))

    def test_swap_weights_rejects_mismatched_state(self, tmp_path):
        prefix, _ = _export_mlp(tmp_path, "m")
        pred = load_inference_model(prefix, device="cpu")
        bad = os.path.join(tmp_path, "bad.pdiparams")
        other = nn.Linear(3, 3)
        tpt.save({"params": dict(other.named_parameters()),
                  "buffers": {}}, bad)
        with pytest.raises(InvalidArgumentError):
            pred.swap_weights(bad)
        wrong_dtype = os.path.join(tmp_path, "f64.pdiparams")
        state = serialization.load(prefix + ".pdiparams")
        state["params"] = {k: v.astype(np.float64)
                           for k, v in state["params"].items()}
        serialization.save(state, wrong_dtype)
        with pytest.raises(InvalidArgumentError, match="shapes/dtypes"):
            pred.swap_weights(wrong_dtype)

    def test_aot_compile_is_the_module_at_one_geometry(self, tmp_path):
        prefix, net = _export_mlp(tmp_path, "m")
        pred = load_inference_model(prefix, device="cpu")
        exe = pred.aot_compile([(4, 8)])
        x = np.random.RandomState(3).randn(4, 8).astype(np.float32)
        (got,) = pred.run_compiled(exe, [x])
        np.testing.assert_array_equal(got, pred.run([x])[0])
        with pytest.raises(InvalidArgumentError, match="compiled for"):
            pred.run_compiled(exe, [x[:3]])


class TestModelSave:
    def test_model_save_inference(self, tmp_path):
        net = _mlp()
        model = tpt.Model(net, inputs=[InputSpec([None, 8], "float32")])
        prefix = os.path.join(tmp_path, "m")
        model.save(prefix, training=False)
        x = np.random.RandomState(4).randn(3, 8).astype(np.float32)
        (out,) = load_inference_model(prefix, device="cpu").run([x])
        assert out.shape == (3, 4)
        np.testing.assert_allclose(out, _live(net, x), **LIVE)

    def test_model_save_without_spec_raises(self, tmp_path):
        model = tpt.Model(_mlp())
        with pytest.raises(InvalidArgumentError, match="input shapes"):
            model.save(os.path.join(tmp_path, "m"), training=False)

    def test_model_example_tensor_inputs(self, tmp_path):
        """Example tensors (not InputSpec) also carry export shapes."""
        net = _mlp()
        model = tpt.Model(net, inputs=[np.zeros((2, 8), np.float32)])
        prefix = os.path.join(tmp_path, "m")
        model.save(prefix, training=False)
        (out,) = load_inference_model(prefix, device="cpu").run(
            [np.zeros((2, 8), np.float32)])
        assert out.shape == (2, 4)

    def test_model_name_only_inputs_still_raise(self, tmp_path):
        model = tpt.Model(_mlp(), inputs=["input_ids"])
        with pytest.raises(InvalidArgumentError, match="input shapes"):
            model.save(os.path.join(tmp_path, "m"), training=False)

    def test_static_and_fluid_names_export(self, tmp_path):
        """static / fluid.io's save_inference_model (layer and specs in
        either order) and load_inference_model are the same export."""
        net = _mlp()
        spec = [InputSpec([None, 8], "float32")]
        a = tpt.static.save_inference_model(os.path.join(tmp_path, "a"),
                                            net, spec)
        b = tpt.fluid.io.save_inference_model(os.path.join(tmp_path, "b"),
                                              spec, net)
        x = np.random.RandomState(5).randn(2, 8).astype(np.float32)
        for prefix in (a, b):
            pred = tpt.static.load_inference_model(prefix, device="cpu")
            np.testing.assert_allclose(pred.run([x])[0], _live(net, x),
                                       **LIVE)
        with pytest.raises(InvalidArgumentError, match="eager Layer"):
            tpt.static.save_inference_model(os.path.join(tmp_path, "c"),
                                            spec, spec)


# -- the JAX package's artifacts -------------------------------------------
def _jax_mlp():
    jpt.seed(0)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))


def _jax_bert():
    jpt.seed(3)
    jm = jbert.BertForSequenceClassification(
        jbert.bert_tiny(hidden_size=64, num_layers=2), num_classes=2)
    jm.eval()
    return jm


def _bridged(jm, tm):
    load_jax_params(tm, {k: np.asarray(p.value)
                         for k, p in jm.named_parameters()})
    return tm.eval()


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """The JAX package's exports of an MLP and a 2-layer BERT (hidden 64),
    with the same models' live layers."""
    td = str(tmp_path_factory.mktemp("jax_exports"))
    mlp, bert = _jax_mlp(), _jax_bert()
    jinf.save_inference_model(os.path.join(td, "mlp"), mlp,
                              [JInputSpec([None, 8], "float32")],
                              platforms=("cpu",))
    # one device: the test process's 8-device mesh would put BERT's
    # sharding constraints (a no-op on one device) into the artifact
    with suppress_constraints():
        jinf.save_inference_model(
            os.path.join(td, "bert"), bert,
            [JInputSpec([None, 16], "int32", "input_ids")],
            platforms=("cpu",))
    return td, mlp, bert


def _cross_case(name, td, jm):
    if name == "mlp":
        tm = _bridged(jm, nn.Sequential(nn.Linear(8, 16), nn.ReLU(),
                                        nn.Linear(16, 4)))
        spec = [InputSpec([None, 8], "float32")]
        x = np.random.RandomState(7).randn(5, 8).astype(np.float32)
    else:
        tm = _bridged(jm, tbert.BertForSequenceClassification(
            tbert.bert_tiny(hidden_size=64, num_layers=2), num_classes=2,
            device="cpu"))
        spec = [InputSpec([None, 16], "int64", "input_ids")]
        x = np.random.RandomState(7).randint(0, 128, (3, 16)).astype(
            np.int32)
    return tm, spec, x


@pytest.mark.parametrize("name", ["mlp", "bert"])
def test_port_predictor_on_jax_params_matches_jax_predictor(
        jax_artifacts, tmp_path, name):
    td, jmlp, jbert_m = jax_artifacts
    jm = jmlp if name == "mlp" else jbert_m
    tm, spec, x = _cross_case(name, td, jm)
    prefix = os.path.join(tmp_path, name)
    save_inference_model(prefix, tm, spec, platforms=("cpu",))
    (want,) = jinf.load_inference_model(os.path.join(td, name)).run([x])
    pred = Predictor(prefix, device="cpu",
                     params_file=os.path.join(td, name + ".pdiparams"))
    (got,) = pred.run([x])
    np.testing.assert_allclose(got, np.asarray(want), **CROSS)
    (own,) = Predictor(prefix, device="cpu").run([x])
    np.testing.assert_allclose(own, _live(tm, x.astype(np.int64)
                                          if name == "bert" else x), **LIVE)
    if name == "bert":  # 2 layers x 2 residual LayerNorms, kernel 2's op
        assert "layernorm_residual_fwd" in _ops_in(pred)
        nodes = [n for n in pred._module.graph.nodes
                 if "layernorm_residual_fwd" in str(n.target)]
        assert len(nodes) == 4
    # swap_weights to the JAX .pdiparams from the port's own
    pred2 = Predictor(prefix, device="cpu")
    pred2.swap_weights(os.path.join(td, name + ".pdiparams"))
    np.testing.assert_array_equal(pred2.run([x])[0], got)


@pytest.mark.parametrize("name", ["mlp", "bert"])
def test_port_reader_rejects_jax_pdmodel(jax_artifacts, name):
    td = jax_artifacts[0]
    with pytest.raises(InvalidArgumentError,
                       match="JAX package's StableHLO artifact"):
        Predictor(os.path.join(td, name), device="cpu")


def test_jax_reader_rejects_port_pdmodel(tmp_path):
    prefix, _ = _export_mlp(tmp_path)
    from paddle_tpu.framework.errors import (
        InvalidArgumentError as JInvalidArgumentError)

    with pytest.raises(JInvalidArgumentError, match="bad magic"):
        jinf.Predictor(prefix)


# -- the kernels' operators -------------------------------------------------
class _Attention(nn.Layer):
    def forward(self, q, k, v):
        return flash_attention(q, k, v, causal=True)


def test_flash_route_exports_and_matches_ref(tmp_path):
    """Kernel 4's operator: a module that calls ops.flash_attention,
    exported on the CPU and reloaded, matches flash_attention_ref at a
    batch it was not traced at."""
    prefix = os.path.join(tmp_path, "attn")
    spec = [InputSpec(["b", 2, 64, 16], "float32", n) for n in "qkv"]
    save_inference_model(prefix, _Attention(), spec, platforms=("cpu",))
    pred = load_inference_model(prefix, device="cpu")
    assert _ops_in(pred) == {"flash_attention_fwd"}
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(3, 2, 64, 16).astype(np.float32))
               for _ in range(3))
    (got,) = pred.run_tensors([q, k, v])
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal=True),
                               rtol=1e-6, atol=1e-6)


def _opcheck_cases():
    rng = np.random.RandomState(0)

    def t(*shape, dtype=np.float32):
        return torch.from_numpy(rng.randn(*shape).astype(dtype))

    def codes(*shape):
        return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))

    cases = []
    for M, D in ((6, 32), (17, 96)):
        cases.append(("layernorm", torch.ops.paddle_tpu_torch.
                      layernorm_residual_fwd,
                      (t(M, D), t(M, D), t(D), t(D), 1e-5)))
    for B, S, K in ((1, 8, 8), (2, 12, 20)):
        cases.append(("flash", torch.ops.paddle_tpu_torch.flash_attention_fwd,
                      (t(B, 2, S, 16), t(B, 2, K, 16), t(B, 2, K, 16),
                       True, 0.25, K - S)))
    for M, K, N in ((4, 32, 16), (9, 64, 40)):
        cases.append(("quantized", torch.ops.paddle_tpu_torch.
                      quantized_matmul,
                      (codes(M, K), codes(K, N), t(N), t(N))))
    return cases


@pytest.mark.parametrize("case", range(6))
def test_opcheck_custom_ops(case):
    name, op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)


def test_ops_on_meta_tensors_give_shapes():
    m = torch.device("meta")
    s, y, mean, rstd = fused_layernorm._forward_op(
        torch.empty(5, 8, device=m), torch.empty(5, 8, device=m),
        torch.empty(8, device=m), torch.empty(8, device=m), 1e-5)
    assert s.shape == y.shape == (5, 8) and mean.shape == rstd.shape == (5,)
    out = qmm._matmul_op(torch.empty(3, 4, dtype=torch.int8, device=m),
                         torch.empty(4, 6, dtype=torch.int8, device=m),
                         torch.empty(6, device=m), torch.empty(6, device=m))
    assert out.shape == (3, 6) and out.dtype == torch.float32


# -- the int8 export ---------------------------------------------------------
def _int8(net, calib):
    from paddle_tpu_torch.slim import PostTrainingQuantization

    ptq = PostTrainingQuantization(net)
    ptq.collect(torch.from_numpy(calib))
    qm = ptq.quantize()
    qm.eval()
    return qm


class TestInt8Export:
    def test_export_reload_roundtrip(self, tmp_path):
        tpt.seed(7)
        m = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
        x = np.random.RandomState(7).uniform(-1, 1, (8, 8)).astype(
            np.float32)
        qm = _int8(m, x)
        ref = _live(qm, x)
        prefix = os.path.join(str(tmp_path), "int8_model")
        save_inference_model(prefix, qm, [InputSpec([None, 8], "float32")],
                             platforms=("cpu",))
        cfg = Config(prefix + ".pdmodel", prefix + ".pdiparams")
        cfg.disable_gpu()
        predictor = create_predictor(cfg)
        assert _ops_in(predictor) == {"quantized_matmul"}
        out = predictor.run([x])[0]
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)

    def test_int8_lenet_matches_live_quantized_model(self, tmp_path):
        """examples/quantize_int8.py's flow: PTQ of LeNet, export, reload
        through a Predictor (kernel 9's operator in the graph)."""
        tpt.seed(1)
        net = LeNet(device="cpu").eval()
        calib = np.random.RandomState(1).rand(4, 1, 28, 28).astype(
            np.float32)
        qm = _int8(net, calib)
        prefix = os.path.join(str(tmp_path), "lenet_int8")
        tpt.static.save_inference_model(
            prefix, qm, [InputSpec([None, 1, 28, 28], "float32")])
        pred = load_inference_model(prefix, device="cpu")
        assert "quantized_matmul" in _ops_in(pred)
        x = np.random.RandomState(2).rand(3, 1, 28, 28).astype(np.float32)
        np.testing.assert_allclose(pred.run([x])[0], _live(qm, x),
                                   rtol=1e-5, atol=1e-6)


# -- the reference's save_inference_model layout ------------------------------
def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "fc_0.w_0": rng.randn(4, 3).astype(np.float32),
        "fc_0.b_0": rng.randn(3).astype(np.float32),
        "emb.weight": rng.randn(7, 2).astype(np.float64),
        "step": np.asarray([12], np.int64),
    }


class TestInferenceModelLayout:
    @pytest.mark.parametrize("params_filename", [None, "params"])
    def test_feed_fetch_plumbing_and_params(self, tmp_path,
                                            params_filename):
        state = _state()
        save_reference_inference_model(
            str(tmp_path), ["x"], ["out"], state,
            params_filename=params_filename)
        for load in (load_reference_state_dict,
                     jax_load_reference_state_dict):
            back = load(str(tmp_path), params_filename=params_filename)
            for n, v in state.items():
                np.testing.assert_array_equal(np.asarray(back[n]), v)

    def test_model_declares_vars_and_feed_fetch_ops(self, tmp_path):
        state = _state()
        save_reference_inference_model(str(tmp_path), ["img"], ["prob"],
                                       state)
        blob = open(tmp_path / "__model__", "rb").read()
        names = [v["name"] for v in parse_program_persistables(blob)]
        assert names == list(state)
        for needle in (b"feed", b"fetch", b"img", b"prob"):
            assert needle in blob
        from paddle_tpu.framework.paddle_export import (
            save_reference_inference_model as jax_writer)

        jax_writer(str(tmp_path / "jax"), ["img"], ["prob"], state)
        assert open(tmp_path / "jax" / "__model__", "rb").read() == blob


# -- the C ABI ---------------------------------------------------------------
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _c_values(stdout):
    lines = stdout.strip().splitlines()
    ndim = int(lines[0])
    shape = tuple(int(v) for v in lines[1:1 + ndim])
    return np.array([float(v) for v in lines[1 + ndim:]],
                    np.float32).reshape(shape)


def test_c_program_matches_python_predictor(tmp_path):
    """native/capi_example.c, linked against c_api_path(), serves an
    exported MLP on the CPU (PADDLE_TPU_TORCH_C_DEVICE) and prints the
    Python Predictor's numbers; a bad path is reported, not a crash."""
    from paddle_tpu_torch.native import run_capi_example

    prefix, _ = _export_mlp(tmp_path, "capi")
    env = dict(os.environ,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""),
               PADDLE_TPU_TORCH_C_DEVICE="cpu")
    run = run_capi_example(prefix, str(tmp_path), env=env)
    assert run.returncode == 0, (run.stdout, run.stderr)
    vals = _c_values(run.stdout)
    x = (np.arange(16, dtype=np.float32) / 16.0 - 0.5).reshape(2, 8)
    ref = load_inference_model(prefix, device="cpu").run([x])[0]
    assert vals.shape == ref.shape
    np.testing.assert_allclose(vals, ref, rtol=1e-6, atol=1e-7)
    bad = run_capi_example(str(tmp_path / "none"), str(tmp_path), env=env)
    assert bad.returncode == 2 and "no inference model" in bad.stderr


def test_c_library_exports_the_abi():
    from paddle_tpu_torch.native import c_api_path

    out = subprocess.run(["nm", "-D", c_api_path()], capture_output=True,
                         text=True)
    for sym in ("pd_predictor_create", "pd_predictor_run",
                "pd_predictor_destroy", "pd_last_error", "pd_free"):
        assert sym in out.stdout


# -- on the card --------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_card_predictor_matches_eager_with_launches(tmp_path):
    """A 2-layer BERT on the card: the Predictor (no device: the card)
    against the eager model there, kernel 2 launched 4 times a call; the
    same artifact on the CPU through the plain versions."""
    _card()
    tpt.seed(0)
    net = tbert.BertForSequenceClassification(
        tbert.bert_tiny(hidden_size=64, num_layers=2), num_classes=2).eval()
    prefix = os.path.join(tmp_path, "bert")
    tpt.jit.save(net, prefix,
                 input_spec=[InputSpec([None, 16], "int64", "input_ids")])
    pred = Predictor(prefix)
    ids = torch.randint(0, 128, (5, 16), device="cuda")
    ln = fused_layernorm.layernorm_residual
    n0 = ln.launches
    (got,) = pred.run_tensors([ids])
    assert ln.launches - n0 == 4
    with torch.no_grad():
        want = net(ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    (cpu,) = Predictor(prefix, device="cpu").run([ids.cpu().numpy()])
    np.testing.assert_allclose(cpu, want.cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
    exe = pred.aot_compile([(5, 16)])
    (rep,) = pred.run_compiled_tensors(exe, [ids])
    assert torch.equal(rep, got)


@pytest.mark.gpu
def test_card_int8_export_launches_kernel_9(tmp_path):
    _card()
    tpt.seed(7)
    m = nn.Sequential(nn.Linear(64, 128), nn.ReLU(), nn.Linear(128, 16))
    m = m.to("cuda")
    x = torch.rand(8, 64, device="cuda")
    from paddle_tpu_torch.slim import PostTrainingQuantization

    ptq = PostTrainingQuantization(m)
    ptq.collect(x)
    qm = ptq.quantize().eval()
    prefix = os.path.join(tmp_path, "int8")
    save_inference_model(prefix, qm, [InputSpec([None, 64], "float32")])
    pred = Predictor(prefix)
    n0 = qmm.quantized_linear.launches
    (got,) = pred.run_tensors([x])
    assert qmm.quantized_linear.launches - n0 == 2
    with torch.no_grad():
        torch.testing.assert_close(got, qm(x), rtol=1e-5, atol=1e-5)


def test_jax_export_is_unchanged_by_the_port(jax_artifacts):
    """The JAX package still exports and serves its own artifacts next to
    the port (both packages in one process)."""
    td, jmlp, _ = jax_artifacts
    x = np.random.RandomState(9).randn(4, 8).astype(np.float32)
    (got,) = jinf.load_inference_model(os.path.join(td, "mlp")).run([x])
    np.testing.assert_allclose(np.asarray(got), np.asarray(
        jmlp(jnp.asarray(x))), rtol=1e-6, atol=1e-6)

