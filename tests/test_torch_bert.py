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
from paddle_tpu_torch.framework.errors import UnimplementedError
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
    with pytest.raises(UnimplementedError, match="ROADMAP"):
        tbert.BertModel(tbert.bert_tiny(**kw), device="cpu")


def test_configs_match_jax():
    for t, j in ((tbert.bert_base(), jbert.bert_base()),
                 (tbert.bert_tiny(), jbert.bert_tiny())):
        for k in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_position", "type_vocab_size",
                  "dropout", "layer_norm_epsilon"):
            assert getattr(t, k) == getattr(j, k), k
