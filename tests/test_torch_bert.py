"""Port of BERT (paddle_tpu_torch/models/bert.py) held against the JAX model.

Weights are bridged from the JAX model by dotted name
(``load_jax_params``); every head's forward and ``BertForPretraining.loss``
must agree on the CPU in f32 with dropout 0 at rtol/atol 1e-5 (the port's
post-LN layers and MLM loss run the plain versions of its kernels; the
JAX model takes its unfused XLA path on the CPU — the same function).
The ``__graft_entry__.entry()`` model (``BertForSequenceClassification
(bert_base())`` on ``(4, 128)`` ids, full width and depth) is held at
1e-4: twelve layers of f32 matmuls summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import paddle_tpu as pt
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.models import bert as tbert

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, P = 2, 16, 3


def _arrays(jm):
    return {k: np.asarray(p.value) for k, p in jm.named_parameters()}


def _pair(name, **kw):
    pt.seed(11)
    jm = getattr(jbert, name)(jbert.bert_tiny(), **kw)
    jm.eval()
    tm = getattr(tbert, name)(tbert.bert_tiny(), device="cpu", **kw)
    load_jax_params(tm, _arrays(jm))
    tm.eval()
    return jm, tm


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, size=(B, S)).astype(np.int32)
    tt = (rng.rand(B, S) < 0.5).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, 11:] = 0  # padding on the second sequence
    mp = np.stack([np.sort(rng.choice(S, P, replace=False))
                   for _ in range(B)]).astype(np.int32)
    return ids, tt, am, mp


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("name", ["BertModel", "BertForPretraining",
                                  "BertForQuestionAnswering",
                                  "BertForSequenceClassification"])
def test_parameter_names_and_shapes_match_1_to_1(name):
    jm, tm = _pair(name)
    assert ({k: tuple(a.shape) for k, a in _arrays(jm).items()}
            == {k: tuple(p.shape) for k, p in tm.named_parameters()})


def test_bert_model_forward_matches_jax():
    jm, tm = _pair("BertModel")
    ids, tt, am, _ = _batch()
    want = jm(jnp.asarray(ids), jnp.asarray(tt), jnp.asarray(am))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                 torch.from_numpy(am))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_pretraining_forward_and_loss_match_jax():
    jm, tm = _pair("BertForPretraining")
    ids, tt, am, mp = _batch(1)
    rng = np.random.RandomState(2)
    mlm_y = rng.randint(0, 128, size=(B, P)).astype(np.int32)
    mlm_y[0, 1] = -100  # an ignored position
    nsp_y = rng.randint(0, 2, size=(B, 1)).astype(np.int32)
    jmlm, jnsp = jm(jnp.asarray(ids), jnp.asarray(tt), jnp.asarray(am),
                    jnp.asarray(mp))
    jloss = jm.loss(jmlm, jnsp, jnp.asarray(mlm_y), jnp.asarray(nsp_y))
    with torch.no_grad():
        tmlm, tnsp = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                        torch.from_numpy(am), torch.from_numpy(mp))
        tloss = tm.loss(tmlm, tnsp, torch.from_numpy(mlm_y),
                        torch.from_numpy(nsp_y))
    assert tmlm.shape == (B, P, 128) and tnsp.shape == (B, 2)
    np.testing.assert_allclose(_np(tmlm), np.asarray(jmlm), **TOL)
    np.testing.assert_allclose(_np(tnsp), np.asarray(jnsp), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


def test_question_answering_forward_and_loss_match_jax():
    jm, tm = _pair("BertForQuestionAnswering")
    ids, tt, am, _ = _batch(3)
    start, end = np.array([3, 40], np.int32), np.array([5, 9], np.int32)
    js, je = jm(jnp.asarray(ids), jnp.asarray(tt), jnp.asarray(am))
    jloss = jm.loss(js, je, jnp.asarray(start), jnp.asarray(end))
    with torch.no_grad():
        ts, te = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                    torch.from_numpy(am))
        tloss = tm.loss(ts, te, torch.from_numpy(start),
                        torch.from_numpy(end))
    np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL)
    np.testing.assert_allclose(_np(te), np.asarray(je), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


def test_sequence_classification_forward_matches_jax():
    jm, tm = _pair("BertForSequenceClassification", num_classes=3)
    ids, tt, am, _ = _batch(4)
    want = jm(jnp.asarray(ids), jnp.asarray(tt), jnp.asarray(am))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                 torch.from_numpy(am))
    assert got.shape == (B, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_entry_model_logits_match_jax():
    """``__graft_entry__.entry()``: BERT-base sequence classification at
    full width and depth, eval mode, on its (4, 128) example ids."""
    fn, (params, ids) = __graft_entry__.entry()
    want = np.asarray(fn(params, ids))
    tm = tbert.BertForSequenceClassification(tbert.bert_base(), num_classes=2,
                                             device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in params.items()})
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(np.array(ids)))
    assert got.shape == (4, 2)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)


def test_bf16_model_loads_jax_bf16_arrays_exactly():
    pt.seed(5)
    jm = jbert.BertForPretraining(jbert.bert_tiny()).astype("bfloat16")
    arrays = _arrays(jm)
    assert arrays["bert.pooler.weight"].dtype.name == "bfloat16"
    tm = tbert.BertForPretraining(tbert.bert_tiny(), device="cpu").astype(
        "bfloat16")
    load_jax_params(tm, arrays)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(p),
                                      arrays[name].astype(np.float32))


@pytest.mark.parametrize("kw", [dict(moe_experts=2),
                                dict(quantization="int8")])
def test_unported_configs_raise(kw):
    # both configs build and run (the MoE and quantized tests below hold
    # them to JAX)
    m = tbert.BertModel(tbert.bert_tiny(**kw), device="cpu").eval()
    with torch.no_grad():
        seq, pooled = m(np.arange(12).reshape(2, 6) % 128)
    assert seq.shape == (2, 6, 32) and torch.isfinite(seq).all()
    layer = m.layers[0]
    if "moe_experts" in kw:
        assert type(layer.mlp).__name__ == "MoELayer"
    else:
        assert layer.mlp.fc1.weight.dtype == torch.int8


def test_configs_match_jax():
    for t, j in ((tbert.bert_base(), jbert.bert_base()),
                 (tbert.bert_tiny(), jbert.bert_tiny())):
        for k in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_position", "type_vocab_size",
                  "dropout", "layer_norm_epsilon"):
            assert getattr(t, k) == getattr(j, k), k


# -- BERT MoE and quantized BERT --------------------------------------------
MOE = dict(moe_experts=4, moe_top_k=2, moe_jitter=0.0)


def _moe_pair(name="BertForPretraining", **kw):
    pt.seed(13)
    jm = getattr(jbert, name)(jbert.bert_tiny(**MOE, **kw))
    tm = getattr(tbert, name)(tbert.bert_tiny(**MOE, **kw), device="cpu")
    load_jax_params(tm, _arrays(jm))
    return jm, tm


@pytest.mark.parametrize("train", [False, True])
def test_moe_pretraining_forward_loss_and_gradients_match_jax(train):
    """Every layer's MLP a 4-expert top-2 MoELayer (jitter 0: the routing
    is deterministic in training too), dropout 0: logits, the
    loss (no balance term in either package) and every parameter's
    gradient (autograd against jax.grad; gradients within 1e-5 of their
    tensor's largest entry: two frameworks sum in other orders)."""
    import jax
    from paddle_tpu.nn.layer_base import functional_call

    jm, tm = _moe_pair()
    assert type(tm.bert.layers[0].mlp).__name__ == "MoELayer"
    assert ({k: tuple(a.shape) for k, a in _arrays(jm).items()}
            == {k: tuple(p.shape) for k, p in tm.named_parameters()})
    ids, tt, am, mp = _batch(3)
    rng = np.random.RandomState(4)
    mlm_y = rng.randint(0, 128, size=(B, P)).astype(np.int32)
    nsp_y = rng.randint(0, 2, size=(B,)).astype(np.int32)
    params = {k: p.value for k, p in jm.named_parameters()}

    def loss(params):
        mlm, nsp = functional_call(jm, params, jnp.asarray(ids),
                                   jnp.asarray(tt), jnp.asarray(am),
                                   jnp.asarray(mp), training=train)
        return jm.loss(mlm, nsp, jnp.asarray(mlm_y),
                       jnp.asarray(nsp_y)), (mlm, nsp)

    (jloss, (jmlm, jnsp)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(params)
    tm.train(train)
    mlm, nsp = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                  torch.from_numpy(am), torch.from_numpy(mp))
    tloss = tm.loss(mlm, nsp, torch.from_numpy(mlm_y),
                    torch.from_numpy(nsp_y))
    tloss.backward()
    np.testing.assert_allclose(_np(mlm), np.asarray(jmlm), **TOL)
    np.testing.assert_allclose(_np(nsp), np.asarray(jnsp), **TOL)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    for name, p in tm.named_parameters():
        want = np.asarray(jgrads[name])
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(_np(p.grad), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_moe_experts_cast_with_the_model_in_both_packages():
    """``astype("bfloat16")`` casts the experts with every other weight
    in both packages (JAX builds the MoE from a GPTConfig without BERT's
    dtype; neither package leaves the experts float32)."""
    jm, tm = _moe_pair()
    jm.astype("bfloat16")
    tm.astype("bfloat16")
    j = jm.bert.layers[0].mlp
    t = tm.bert.layers[0].mlp
    for name in ("gate", "expert_fc1", "expert_b1", "expert_fc2",
                 "expert_b2"):
        assert str(getattr(j, name).value.dtype) == "bfloat16", name
        assert getattr(t, name).dtype == torch.bfloat16, name
    ids, tt, am, mp = _batch(5)
    tm.eval()
    with torch.no_grad():
        mlm, _ = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                    torch.from_numpy(am), torch.from_numpy(mp))
    assert mlm.dtype == torch.bfloat16 and torch.isfinite(mlm).all()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_bert_forward_matches_jax(mode):
    """``BertConfig(quantization=mode)``: the JAX model quantizes its
    parallel linears at init; the port model, built the same way, takes
    the JAX codes and scales (``load_jax_params`` of the quantized tree)
    and computes the same logits (the activation codes are equal, the
    products exact in int8, float32 sums in another order in fp8)."""
    pt.seed(17)
    jm = jbert.BertForSequenceClassification(
        jbert.bert_tiny(quantization=mode))
    jm.eval()
    tm = tbert.BertForSequenceClassification(
        tbert.bert_tiny(quantization=mode), device="cpu").eval()
    qdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[mode]
    for layer in tm.bert.layers:
        for lin in (layer.attn.qkv, layer.attn.out, layer.mlp.fc1,
                    layer.mlp.fc2):
            assert lin.weight.dtype == qdt
    assert tm.classifier.weight.dtype == torch.float32  # heads stay float
    arrays = _arrays(jm)
    buffers = {k: np.asarray(b.value) for k, b in jm.named_buffers()}
    load_jax_params(tm, arrays, buffers)
    ids, tt, am, _ = _batch(6)
    want = np.asarray(jm(jnp.asarray(ids), jnp.asarray(tt),
                         jnp.asarray(am)))
    with torch.no_grad():
        got = _np(tm(torch.from_numpy(ids), torch.from_numpy(tt),
                     torch.from_numpy(am)))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
