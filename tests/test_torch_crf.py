"""The port's linear-chain CRF (``paddle_tpu_torch.nn.functional.crf``)
against brute-force enumeration and against the JAX package's, forward
and ``jax.grad``; Viterbi's ties; the label-semantic-roles book test and a
``bert_tiny()`` CRF tagger in both packages.

Every input is a numpy array from a seed.  Float outputs within rtol /
atol 1e-5, paths equal in value (the port's are int64, JAX's int32),
gradients within 1e-4 of the JAX gradient's rms (``torch_op_pairs``).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from torch_op_pairs import (check_grads, check_out, jax_references,  # noqa: F401
                            np_, on_the_cpu, torch_side)

D, T, B = 3, 4, 5


def _rand(seed=0, lengths=(T, T - 1, 2, 1, T)):
    rng = np.random.RandomState(seed)
    emission = rng.randn(B, T, D).astype(np.float32)
    transition = rng.randn(D + 2, D).astype(np.float32)
    labels = rng.randint(0, D, (B, T)).astype(np.int64)
    return emission, transition, labels, np.array(lengths, np.int64)


def _path_score(e_b, transition, path):
    start, stop, trans = transition[0], transition[1], transition[2:]
    s = start[path[0]] + e_b[0, path[0]]
    for t in range(1, len(path)):
        s += trans[path[t - 1], path[t]] + e_b[t, path[t]]
    return s + stop[path[-1]]


def _brute(e_b, transition, length):
    scores = {p: _path_score(e_b[:length], transition, p)
              for p in itertools.product(range(D), repeat=length)}
    arr = np.array(list(scores.values()), np.float64)
    log_z = np.log(np.exp(arr - arr.max()).sum()) + arr.max()
    best = max(scores, key=scores.get)
    return log_z, np.array(best), scores[best]


def test_nll_and_viterbi_match_bruteforce():
    emission, transition, labels, lengths = _rand()
    nll = np_(TF.linear_chain_crf(emission, transition, labels, lengths))
    path, score = TF.viterbi_decode(emission, transition, lengths)
    path, score = np_(path), np_(score)
    assert nll.shape == (B, 1) and path.dtype == np.int64
    for b in range(B):
        L = lengths[b]
        log_z, best, best_score = _brute(emission[b], transition, L)
        gold = _path_score(emission[b][:L], transition, labels[b][:L])
        np.testing.assert_allclose(nll[b, 0], log_z - gold, rtol=1e-5)
        np.testing.assert_array_equal(path[b, :L], best)
        np.testing.assert_allclose(score[b], best_score, rtol=1e-5)
        assert (path[b, L:] == 0).all()


LENGTHS = {"ragged": (T, T - 1, 2, 1, T), "full": None,
           "all_one": (1, 1, 1, 1, 1)}


def _ln(name):
    ln = LENGTHS[name]
    return None if ln is None else np.array(ln, np.int64)


def _tie_inputs():
    """Equal emissions and a constant transition: every path ties (and
    a tie between tags 1 and 2 in row 1)."""
    emission = np.zeros((2, 5, 4), np.float32)
    emission[1, 2] = [1.0, 3.0, 3.0, 1.0]
    return emission, np.ones((6, 4), np.float32), np.array([5, 3], np.int64)


def _cases():
    """name → (JAX fn, port fn, arrays, grad) of every JAX-compared case."""
    cases = {}
    em, tr, y, _ = _rand(1)
    for n in LENGTHS:
        args = [em, tr, y] + ([] if _ln(n) is None else [_ln(n)])
        cases[f"nll/{n}"] = (JF.linear_chain_crf, TF.linear_chain_crf,
                             args, (0, 1))
    em3, tr3, y3, _ = _rand(3)
    for n in LENGTHS:
        ln = _ln(n)
        for tag, j, t in (
                ("viterbi", JF.viterbi_decode, TF.viterbi_decode),
                ("decode", JF.crf_decoding, TF.crf_decoding)):
            cases[f"{tag}/{n}"] = (
                lambda e, r, f=j, ln=ln: f(e, r, length=ln),
                lambda e, r, f=t, ln=ln: f(e, r, length=ln), [em3, tr3], ())
        cases[f"agree/{n}"] = (
            lambda e, r, l, ln=ln: JF.crf_decoding(e, r, l, length=ln),
            lambda e, r, l, ln=ln: TF.crf_decoding(e, r, l, length=ln),
            [em3, tr3, y3], ())
    te, tt, tl = _tie_inputs()
    cases["ties"] = (lambda e, r: JF.viterbi_decode(e, r, tl),
                     lambda e, r: TF.viterbi_decode(e, r, tl), [te, tt], ())
    em4, tr4, y4, _ = _rand(4)
    cases["t1/viterbi"] = (JF.viterbi_decode, TF.viterbi_decode,
                           [em4[:, :1], tr4], ())
    cases["t1/nll"] = (JF.linear_chain_crf, TF.linear_chain_crf,
                       [em4[:, :1], tr4, y4[:, :1]], (0, 1))
    em2, tr2, y2, ln2 = _rand(2)
    cases["bf16"] = (
        lambda e, r: JF.linear_chain_crf(e.astype(jnp.bfloat16), r, y2, ln2),
        lambda e, r: TF.linear_chain_crf(e.to(torch.bfloat16), r, y2, ln2),
        [em2, tr2], ())
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def crf_refs():
    """Every case's JAX output and gradients from one compile."""
    return jax_references({n: (j, a, g, lambda o: o, 1)
                           for n, (j, _, a, g) in CASES.items()})


@pytest.mark.parametrize("name", sorted(CASES))
def test_crf_op_matches_jax(name, crf_refs):
    """NLL and its gradients in emission and transition (ragged lengths
    with 1 and T, full rows, all 1, T = 1, bf16 emission scored in
    float32); Viterbi paths and scores, ``crf_decoding`` and its
    agreement mask (int64), ties taking the first maximum."""
    _, tfn, arrays, grad = CASES[name]
    jout, jg = crf_refs[name]
    got = torch_side(tfn, arrays, jout, jg, grad)
    if name == "ties":
        assert np_(got[0])[0].tolist() == [0] * 5
    if name.startswith(("decode", "agree")):
        assert got.dtype == torch.int64
    if name == "bf16":
        assert got.dtype == torch.float32


def test_crf_trains_the_gold_path():
    """Minimizing the NLL by SGD drives the decoded path to the labels."""
    emission, transition, labels, lengths = _rand()
    em = torch.tensor(emission, requires_grad=True)
    tr = torch.tensor(transition, requires_grad=True)

    def loss():
        return TF.linear_chain_crf(em, tr, labels, lengths).mean()

    l0 = float(loss())
    for _ in range(200):
        gt, ge = torch.autograd.grad(loss(), [tr, em])
        with torch.no_grad():
            tr -= 0.5 * gt
            em -= 0.5 * ge
    assert float(loss()) < 0.1 * l0
    path = np_(TF.crf_decoding(em, tr, length=lengths))
    for b in range(B):
        np.testing.assert_array_equal(path[b, :lengths[b]],
                                      labels[b, :lengths[b]])


def test_label_semantic_roles_book_test():
    """``test_book.py::TestLabelSemanticRoles`` in the port: a Markov tag
    chain whose observations alias two tags, a tagger trained through
    ``linear_chain_crf`` by ``Model.train_batch``; Viterbi decoding must
    beat per-token argmax."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Adam

    Dt, Tt, N, V = 4, 12, 256, 6
    rng = np.random.RandomState(0)
    trans_true = np.array([[0.05, 0.05, 0.85, 0.05],
                           [0.05, 0.05, 0.05, 0.85],
                           [0.45, 0.45, 0.05, 0.05],
                           [0.45, 0.45, 0.05, 0.05]])
    obs_of_tag = {0: 0, 1: 0, 2: 2, 3: 3}
    tags = np.zeros((N, Tt), np.int64)
    toks = np.zeros((N, Tt), np.int64)
    for n in range(N):
        t0 = rng.randint(Dt)
        for t in range(Tt):
            tags[n, t], toks[n, t] = t0, obs_of_tag[t0]
            t0 = rng.choice(Dt, p=trans_true[t0])
    lengths = np.full(N, Tt, np.int64)

    class Tagger(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(V, 16)
            self.proj = nn.Linear(16, Dt)
            self.transition = self.create_parameter(
                [Dt + 2, Dt],
                default_initializer=nn.initializer.Normal(std=0.1))

        def forward(self, toks):
            return self.proj(self.emb(toks)), self.transition

    def crf_loss(emissions, transition, y, ln):
        return TF.linear_chain_crf(emissions, transition, y, ln).mean()

    tpt.seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: the pool's wake-ups cost more
    net = Tagger()
    model = tpt.Model(net, inputs=["toks"], labels=["y", "len"])
    model.prepare(optimizer=Adam(learning_rate=0.1,
                                 parameters=net.parameters()),
                  loss=crf_loss)
    try:
        for _ in range(120):
            model.train_batch([toks], [tags, lengths])
    finally:
        torch.set_num_threads(threads)
    with torch.no_grad():
        emissions, transition = net(torch.from_numpy(toks))
    path = np_(TF.crf_decoding(emissions, transition, length=lengths))
    crf_acc = (path == tags).mean()
    pointwise_acc = (np_(emissions).argmax(-1) == tags).mean()
    assert crf_acc > 0.85, crf_acc
    assert crf_acc > pointwise_acc + 0.05, (crf_acc, pointwise_acc)


def test_bert_tiny_crf_tagger_matches_jax():
    """A one-layer ``bert_tiny()`` encoder, a linear head and a CRF on the same
    weights in both packages: the loss within 1e-5 and every parameter's
    gradient within 1e-4 of its rms."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.models import bert as jbert
    from paddle_tpu.nn.layer_base import functional_call
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.bridge import load_jax_params
    from paddle_tpu_torch.models import bert as tbert

    tags, Bt, S = 7, 3, 12

    class JTagger(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.bert = jbert.BertModel(jbert.bert_tiny(num_layers=1))
            self.head = jnn.Linear(32, tags)
            self.transition = self.create_parameter([tags + 2, tags])

        def forward(self, ids, am):
            return self.head(self.bert(ids, attention_mask=am)[0])

    class TTagger(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.bert = tbert.BertModel(tbert.bert_tiny(num_layers=1),
                                         device="cpu")
            self.head = tnn.Linear(32, tags)
            self.transition = self.create_parameter([tags + 2, tags])

        def forward(self, ids, am):
            return self.head(self.bert(ids, attention_mask=am)[0])

    rng = np.random.RandomState(0)
    ln = np.array([S, 1, 7], np.int64)
    ids = rng.randint(1, 128, (Bt, S)).astype(np.int64)
    am = (np.arange(S)[None] < ln[:, None]).astype(np.int64)
    y = rng.randint(0, tags, (Bt, S)).astype(np.int64)
    jm = JTagger()
    params = {k: p.value for k, p in jm.named_parameters()}
    tm = TTagger()
    load_jax_params(tm, {k: np.asarray(v) for k, v in params.items()})
    tm.eval()

    @jax.jit
    def jloss(params):
        em = functional_call(jm, params, jnp.asarray(ids), jnp.asarray(am),
                             training=False)
        return JF.linear_chain_crf(em, params["transition"], y, ln).mean()

    jl, jg = jax.value_and_grad(jloss)(params)
    tl = TF.linear_chain_crf(tm(torch.from_numpy(ids), torch.from_numpy(am)),
                             tm.transition, y, ln).mean()
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    check_grads([p.grad for _, p in tm.named_parameters()],
                [jg[n] for n in names], names)
