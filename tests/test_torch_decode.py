"""The port's ``nn.decode`` held against the JAX package's on the CPU.

The JAX test's GRU seq2seq (embedding, GRU encoder, GRU cell decoder,
output linear) is built in both packages from one set of weights; beam
search through ``BeamSearchDecoder`` + ``dynamic_decode`` must give the
same ids, parents, scores (rtol 1e-5), final log-probs, finished flags
and lengths, with the same number of steps (the loop exits early).  Two
constructed exact ties hold the tie-break: a beam wider than the
vocabulary (dead beams' candidates tie at -1e9) and a cell whose logits
are all equal; ``jax.lax.top_k`` takes the lower index first, and so must
the port.  The helpers: teacher forcing and greedy decoding against JAX;
sampling held to invariants (its draws are the port's generator's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
from torch_nn_pairs import bridged

V, H = 12, 16
BOS, EOS = 0, 1


def _seq2seq(nn):
    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(V, H)
            self.enc = nn.GRU(H, H)
            self.cell = nn.GRUCell(H, H)
            self.out = nn.Linear(H, V)

        def encode(self, s):
            _, h = self.enc(self.emb(s))
            return h[0]

        def forward(self, s):
            return self.encode(s)

    return Seq2Seq()


def _pair(scale=1.0):
    jpt.seed(21)
    jnet = _seq2seq(jnn)
    tnet = _seq2seq(tnn)
    bridged(jnet, tnet)
    if scale != 1.0:  # sharper logits: beams finish within the cap
        for n, p in tnet.named_parameters():
            if n.startswith("out."):
                with torch.no_grad():
                    p.mul_(scale)
        for n, p in jnet.named_parameters():
            if n.startswith("out."):
                p.value = p.value * scale
    return jnet, tnet


class _Raw:
    """A decoder whose outputs stay per step (no backtrace): scores, ids
    and parents as the loop produced them."""

    @staticmethod
    def wrap(dec):
        def finalize(outputs, states, lengths):
            raise NotImplementedError
        dec.finalize = finalize
        return dec


def _decode(nn, net, src, beam, max_steps, raw=False, output_fn=None):
    dec = nn.BeamSearchDecoder(net.cell, BOS, EOS, beam,
                               embedding_fn=net.emb,
                               output_fn=output_fn or net.out)
    if raw:
        _Raw.wrap(dec)
    h0 = net.encode(src)
    return nn.dynamic_decode(dec, inits=h0, max_step_num=max_steps,
                             return_length=True)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.mark.parametrize("beam,scale,max_steps", [
    (3, 1.0, 6), (4, 3.0, 10), (2, 6.0, 20)],
    ids=["b3_cap", "b4_early", "b2_sharp"])
def test_beam_search_as_jax(beam, scale, max_steps):
    jnet, tnet = _pair(scale)
    src = np.random.RandomState(1).randint(2, V, size=(5, 4)).astype(
        np.int64)
    jo, js, jl = _decode(jnn, jnet, jnp.asarray(src), beam, max_steps)
    to, ts, tl = _decode(tnn, tnet, torch.tensor(src), beam, max_steps)
    assert to.dtype == torch.int64 and tl.dtype == torch.int64
    np.testing.assert_array_equal(_np(to), _np(jo))
    np.testing.assert_array_equal(_np(tl), _np(jl))
    np.testing.assert_array_equal(_np(ts.lengths), _np(js.lengths))
    np.testing.assert_array_equal(_np(ts.finished), _np(js.finished))
    np.testing.assert_allclose(_np(ts.log_probs), _np(js.log_probs),
                               rtol=1e-5, atol=1e-5)
    # per step: scores, ids and parents before the backtrace
    jr, _, _ = _decode(jnn, jnet, jnp.asarray(src), beam, max_steps, True)
    tr, _, _ = _decode(tnn, tnet, torch.tensor(src), beam, max_steps, True)
    np.testing.assert_array_equal(_np(tr.predicted_ids),
                                  _np(jr.predicted_ids))
    np.testing.assert_array_equal(_np(tr.parent_ids), _np(jr.parent_ids))
    np.testing.assert_allclose(_np(tr.scores), _np(jr.scores), rtol=1e-5,
                               atol=1e-5)
    assert tr.parent_ids.shape[1] <= max_steps + 1


def test_beam_wider_than_vocab_breaks_exact_ties_as_jax():
    """beam 5 over 4 tokens: the first step's fifth candidate is a dead
    beam's, and every dead candidate scores exactly -1e9 in float32."""
    jpt.seed(2)
    jcell, tcell = jnn.GRUCell(4, 4), tnn.GRUCell(4, 4)
    bridged(jcell, tcell)
    h0 = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    outs = []
    for nn, cell, arr in ((jnn, jcell, jnp.asarray), (tnn, tcell,
                                                      torch.tensor)):
        dec = _Raw.wrap(nn.BeamSearchDecoder(
            cell, start_token=2, end_token=3, beam_size=5,
            embedding_fn=lambda ids, arr=arr: arr(np.eye(4, dtype=np.float32))[
                ids]))
        outs.append(nn.dynamic_decode(dec, inits=arr(h0), max_step_num=3)[0])
    jr, tr = outs
    first = _np(tr.scores)[:, 0]
    assert (first[:, 4:] == -1e9).all()  # the tie
    np.testing.assert_array_equal(_np(tr.parent_ids), _np(jr.parent_ids))
    np.testing.assert_array_equal(_np(tr.predicted_ids),
                                  _np(jr.predicted_ids))


def test_all_equal_logits_take_the_lower_index_as_jax():
    jnet, tnet = _pair()
    src = np.random.RandomState(4).randint(2, V, size=(2, 3)).astype(
        np.int64)

    def flat_j(x):
        return jnp.zeros(x.shape[:-1] + (V,), jnp.float32)

    def flat_t(x):
        return torch.zeros(x.shape[:-1] + (V,))

    jr, _, _ = _decode(jnn, jnet, jnp.asarray(src), 3, 2, True, flat_j)
    tr, _, _ = _decode(tnn, tnet, torch.tensor(src), 3, 2, True, flat_t)
    np.testing.assert_array_equal(_np(tr.predicted_ids),
                                  _np(jr.predicted_ids))
    np.testing.assert_array_equal(_np(tr.parent_ids), _np(jr.parent_ids))
    np.testing.assert_array_equal(_np(tr.predicted_ids)[:, 0],
                                  [[0, 1, 2]] * 2)


def test_tile_beam_merge_with_batch_as_jax():
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(
        tnn.BeamSearchDecoder.tile_beam_merge_with_batch(
            torch.tensor(x), 2).numpy(),
        np.asarray(jnn.BeamSearchDecoder.tile_beam_merge_with_batch(
            jnp.asarray(x), 2)))


def _basic(nn, net, helper, max_steps=6, **kw):
    dec = nn.BasicDecoder(net.cell, helper, output_fn=net.out)
    return nn.dynamic_decode(dec, inits=kw.pop("h0"), max_step_num=max_steps,
                             return_length=True, **kw)


def test_training_helper_as_jax():
    jnet, tnet = _pair()
    rng = np.random.RandomState(5)
    src = rng.randint(2, V, size=(3, 4)).astype(np.int64)
    tgt = rng.randn(3, 5, H).astype(np.float32)
    lens = np.array([5, 2, 3], np.int64)
    jo, _, jl = _basic(jnn, jnet, jnn.TrainingHelper(jnp.asarray(tgt),
                                                     jnp.asarray(lens)),
                       h0=jnet.encode(jnp.asarray(src)))
    to, _, tl = _basic(tnn, tnet, tnn.TrainingHelper(torch.tensor(tgt),
                                                     torch.tensor(lens)),
                       h0=tnet.encode(torch.tensor(src)))
    np.testing.assert_allclose(_np(to.cell_outputs), _np(jo.cell_outputs),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(to.sample_ids), _np(jo.sample_ids))
    np.testing.assert_array_equal(_np(tl), _np(jl))
    assert to.cell_outputs.shape[1] == 5  # ends when every length is met


def test_greedy_helper_as_jax():
    jnet, tnet = _pair(scale=3.0)
    src = np.random.RandomState(6).randint(2, V, size=(4, 4)).astype(
        np.int64)
    start = np.full((4,), BOS, np.int64)
    jo, _, jl = _basic(jnn, jnet, jnn.GreedyEmbeddingHelper(
        jnet.emb, jnp.asarray(start), EOS), h0=jnet.encode(jnp.asarray(src)),
        max_steps=9)
    to, _, tl = _basic(tnn, tnet, tnn.GreedyEmbeddingHelper(
        tnet.emb, torch.tensor(start), EOS), h0=tnet.encode(torch.tensor(
            src)), max_steps=9)
    np.testing.assert_array_equal(_np(to.sample_ids), _np(jo.sample_ids))
    np.testing.assert_array_equal(_np(tl), _np(jl))


def test_sample_helper_invariants():
    _, tnet = _pair()
    src = torch.tensor(np.random.RandomState(7).randint(
        2, V, size=(6, 4)).astype(np.int64))
    start = torch.full((6,), BOS, dtype=torch.int64)

    def run(seed=None, temp=None):
        helper = tnn.SampleEmbeddingHelper(tnet.emb, start, EOS,
                                           softmax_temperature=temp,
                                           seed=seed)
        out, _, lens = _basic(tnn, tnet, helper, h0=tnet.encode(src),
                              max_steps=7)
        return out.sample_ids, lens

    a, la = run(seed=3)
    b, lb = run(seed=3)
    assert torch.equal(a, b) and torch.equal(la, lb)  # a seed pins the run
    assert ((a >= 0) & (a < V)).all() and a.dtype == torch.int64
    assert (la >= 1).all() and (la <= a.shape[1]).all()
    tpt.seed(1)
    c, _ = run()
    d, _ = run()
    assert not torch.equal(c, d)  # unseeded: the generator moves on
    cold, _ = run(seed=3, temp=1e-4)  # near-greedy at a tiny temperature
    greedy, _, _ = _basic(tnn, tnet, tnn.GreedyEmbeddingHelper(
        tnet.emb, start, EOS), h0=tnet.encode(src), max_steps=7)
    assert torch.equal(cold, greedy.sample_ids)


def test_decode_finished_at_start_runs_no_step():
    _, tnet = _pair()
    helper = tnn.TrainingHelper(torch.zeros(2, 3, H), torch.zeros(2))
    out, _, lens = _basic(tnn, tnet, helper, h0=torch.zeros(2, H))
    assert out.cell_outputs.shape == (2, 0, V) and (lens == 0).all()
