"""The port's Wide&Deep CTR model (``paddle_tpu_torch/models/wide_deep.py``)
and its sparse training path held against the JAX package.

From one bridged init (``bridge.load_jax_params`` maps the JAX names 1:1):
the forward logits, the loss and ``predict_proba`` at rtol 1e-6; eight
``train_batch`` steps of ``wide_deep_tiny`` — ``sparse=True`` with
``Adam(lazy_mode=True)`` (SelectedRows gradients, touched rows only) and
``sparse=False`` with dense Adam — losses and every parameter at rtol /
atol 1e-5 (Adam's normalized step turns float32 rounding of a gradient
near zero into up to lr of movement, so the bound is above the forward's);
rows no batch touched bit-equal to the init in the lazy run; ``fit`` /
``evaluate`` / ``predict`` over the sparse step; and ``bench.py``'s config 5
(120 lazy-Adam steps on 4096 seeded clicks) cut to 40 steps, whose AUC
both packages reach within 0.01 of each other.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import metric as jmetric
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import wide_deep as jwd
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.models import WideDeep, wide_deep_tiny

STEPS = 8


def _pair(sparse, **kw):
    jpt.seed(0)
    jnet = jwd.wide_deep_tiny(sparse=sparse, **kw)
    tnet = wide_deep_tiny(sparse=sparse, device="cpu", **kw)
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    return jnet, tnet


def _clicks(n, seed, vocab=64, fields=4, dense=4):
    """bench.py's config-5 data: Bernoulli clicks from a latent logit (a
    per-id effect of field 0 plus a linear dense effect)."""
    rng = np.random.RandomState(0)
    table = rng.randn(vocab)
    w_dense = rng.randn(dense) * 0.5
    r = np.random.RandomState(seed)
    ids = r.randint(0, vocab, size=(n, fields)).astype(np.int32)
    xd = r.randn(n, dense).astype(np.float32)
    s = 2.0 * (table[ids[:, 0]] + xd @ w_dense)[:, None]
    y = (r.uniform(size=(n, 1)) < 1 / (1 + np.exp(-s))).astype(np.float32)
    return ids, xd, y


def test_parameter_names_and_shapes_match_jax():
    jnet, tnet = _pair(sparse=True)
    assert {k: tuple(p.value.shape) for k, p in jnet.named_parameters()} \
        == {k: tuple(p.shape) for k, p in tnet.named_parameters()}
    from paddle_tpu_torch.framework.selected_rows import sparse_param_names
    assert sorted(sparse_param_names(tnet).values()) == [
        "embedding.weight", "wide.weight"]
    assert sparse_param_names(wide_deep_tiny(device="cpu")) == {}
    std = WideDeep(num_fields=2, vocab_size=5000, embed_dim=32, dense_dim=2,
                   device="cpu").embedding.weight.detach().std()
    assert abs(float(std) - 0.02) < 1e-3  # VocabParallelEmbedding's init


@pytest.mark.parametrize("sparse", [True, False])
def test_forward_loss_and_proba_match_jax(sparse):
    jnet, tnet = _pair(sparse)
    ids, xd, y = _clicks(32, 1)
    jl = jnet(jnp.asarray(ids), jnp.asarray(xd))
    tl = tnet(torch.from_numpy(ids), torch.from_numpy(xd))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tnet.loss(tl, torch.from_numpy(y))),
                               float(jnet.loss(jl, jnp.asarray(y))),
                               rtol=1e-6)
    np.testing.assert_allclose(tnet.predict_proba(tl).detach().numpy(),
                               np.asarray(jnet.predict_proba(jl)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sparse", [True, False])
def test_eight_train_batch_steps_match_jax(sparse):
    jnet, tnet = _pair(sparse)
    w0 = tnet.embedding.weight.detach().clone()
    jm = jpt.Model(jnet, inputs=["sparse", "dense"], labels=["label"])
    jm.prepare(optimizer=jopt.Adam(1e-2, lazy_mode=sparse), loss=jnet.loss)
    tm = tpt.Model(tnet, inputs=["sparse", "dense"], labels=["label"])
    tm.prepare(optimizer=topt.Adam(1e-2, lazy_mode=sparse), loss=tnet.loss)
    seen = []
    for step in range(STEPS):
        ids, xd, y = _clicks(64, 10 + step, vocab=48)  # rows 48-63 unseen
        seen.append(ids)
        jl = float(np.asarray(jm.train_batch([ids, xd], [y])[0]))
        tl = tm.train_batch([ids, xd], [y])[0]
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=str(step))
    for k, p in jnet.named_parameters():
        np.testing.assert_allclose(
            dict(tnet.named_parameters())[k].detach().numpy(),
            np.asarray(p.value), rtol=1e-5, atol=1e-5, err_msg=k)
    untouched = np.setdiff1d(np.arange(64), np.unique(np.stack(seen)))
    assert len(untouched) == 16
    if sparse:  # lazy: rows no batch touched never move
        assert torch.equal(tnet.embedding.weight.detach()[untouched],
                           w0[untouched])


def test_fit_evaluate_predict_through_the_sparse_step():
    from paddle_tpu_torch.io import TensorDataset

    _, tnet = _pair(sparse=True)
    ids, xd, y = _clicks(256, 3)
    data = TensorDataset([torch.from_numpy(ids), torch.from_numpy(xd),
                          torch.from_numpy(y)])
    m = tpt.Model(tnet, inputs=["sparse", "dense"], labels=["label"])
    m.prepare(optimizer=topt.Adam(1e-2, lazy_mode=True), loss=tnet.loss)
    first = m.evaluate(data, batch_size=64, verbose=0)["loss"]
    m.fit(data, batch_size=64, epochs=3, verbose=0, shuffle=False)
    assert m.evaluate(data, batch_size=64, verbose=0)["loss"] < first
    assert m._optimizer.state_dict()["count"] == 12
    out = m.predict(TensorDataset([torch.from_numpy(ids),
                                   torch.from_numpy(xd)]),
                    batch_size=64, stack_outputs=True)
    assert out.shape == (256, 1) and np.isfinite(out).all()


def test_bench_config5_cut_to_40_steps_auc_matches_jax():
    ids, xd, y = _clicks(4096, 0)
    ids_t, xd_t, y_t = _clicks(4096, 7)
    jnet, tnet = _pair(sparse=True)
    jm = jpt.Model(jnet, inputs=["sparse", "dense"], labels=["label"])
    jm.prepare(optimizer=jopt.Adam(1e-2, lazy_mode=True), loss=jnet.loss)
    tm = tpt.Model(tnet, inputs=["sparse", "dense"], labels=["label"])
    tm.prepare(optimizer=topt.Adam(1e-2, lazy_mode=True), loss=tnet.loss)
    for _ in range(40):
        jl = float(np.asarray(jm.train_batch([ids, xd], [y])[0]))
        tl = tm.train_batch([ids, xd], [y])[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    aucs = []
    for auc, logits in (
            (jmetric.Auc(), np.asarray(jm.predict_batch([ids_t, xd_t]))),
            (tmetric.Auc(), tm.predict_batch([ids_t, xd_t]).numpy())):
        prob = 1 / (1 + np.exp(-logits.reshape(-1)))
        auc.update(np.stack([1 - prob, prob], -1), y_t)
        aucs.append(float(auc.accumulate()))
    assert abs(aucs[0] - aucs[1]) < 0.01 and aucs[1] > 0.7, aucs
