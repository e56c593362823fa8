"""SelectedRows sparse-embedding gradients of the port
(``paddle_tpu_torch/framework/selected_rows.py``, the optimizers' row
rules, ``nn.Embedding(sparse=True)``) held against the JAX package.

The same seeded numpy inputs go through both packages: ``SelectedRows``
algebra (``merged`` ids exact, values and ``to_dense`` at rtol 1e-6);
``Model.train_batch`` of a one-table net from one bridged init, three
steps, for every optimizer rule (the JAX package's ``_sparse_mode``:
rows only, lazy or densified), with padding ids in every batch —
parameters and every optimizer slot at rtol 1e-6 / atol 1e-6 (float32; the
same arithmetic, summed and rounded in other orders: RMSProp's and Ftrl's
square roots and powers leave ~1e-6 on entries of size ~1 after three
steps), rows the batches never touched
and the padding row bit-equal to the init in row mode.  The JAX Lamb and
Lars raise ``TypeError`` on a SelectedRows gradient; the port densifies
them, held against the JAX dense step (``sparse=False``).  Then the cases
of ``tests/test_sparse_embedding.py`` (lazy multi-step, non-lazy equal to
dense Adam, master rows, decay on touched rows only, global-norm clip with
heavy padding), out-of-range ids in both paths, the no-gradient-through-
a-second-read contract, and what amp's ``GradScaler`` does with a sparse
table.  ``gpu``-marked twins run a million-row table on the card against
the CPU (``chip_smoke.py`` S1 at full size).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.framework.selected_rows import SelectedRows as JSR
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework import selected_rows as tsr
from paddle_tpu_torch.framework.selected_rows import SelectedRows as TSR

VOCAB, DIM, B, F = 200, 8, 16, 3
PAD = 0
STEPS = 3
TIGHT = dict(rtol=1e-6, atol=1e-6)


# -- SelectedRows algebra ----------------------------------------------------
def _sr_case(seed, k, height, dim, pad_share):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, max(height // 4, 1), k).astype(np.int64)
    ids[rng.rand(k) < pad_share] = height  # the sentinel
    vals = rng.randn(k, dim).astype(np.float32)
    return ids, vals


@pytest.mark.parametrize("k,height,dim,pad_share", [
    (6, 10, 2, 0.0), (64, 40, 5, 0.3), (257, 1000, 8, 0.1), (1, 3, 4, 0.0),
    (32, 8, 3, 1.0)])
def test_selected_rows_merged_to_dense_norm_match_jax(k, height, dim,
                                                      pad_share):
    ids, vals = _sr_case(k + height, k, height, dim, pad_share)
    j = JSR(jnp.asarray(ids), jnp.asarray(vals), height)
    t = TSR(torch.from_numpy(ids), torch.from_numpy(vals), height)
    jm, tm = j.merged(), t.merged()
    np.testing.assert_array_equal(tm.ids.numpy(), np.asarray(jm.ids))
    np.testing.assert_allclose(tm.values.numpy(), np.asarray(jm.values),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.to_dense().numpy(),
                               np.asarray(j.to_dense()), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(tm.l2_norm_sq()),
                               float(jm.l2_norm_sq()), rtol=1e-6)
    np.testing.assert_allclose(float(t.l2_norm_sq()),
                               float(j.l2_norm_sq()), rtol=1e-6)
    assert tm.merged() is tm and t.merged() is tm  # merged once, cached


def test_selected_rows_empty_and_scaling():
    sr = TSR(torch.zeros(0, dtype=torch.int64), torch.zeros(0, 4), 10)
    assert sr.merged() is sr
    assert sr.to_dense().shape == (10, 4)
    assert float(sr.l2_norm_sq()) == 0.0
    t = TSR(torch.tensor([1, 1, 3]), torch.ones(3, 2), 5)
    np.testing.assert_array_equal((t * 2.0).values.numpy(), 2.0)
    np.testing.assert_array_equal((t / 2.0).values.numpy(), 0.5)
    assert t.astype(torch.bfloat16).dtype == torch.bfloat16
    both = t.concat(TSR(torch.tensor([4]), torch.ones(1, 2), 5))
    assert both.ids.tolist() == [1, 1, 3, 4]
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    with pytest.raises(InvalidArgumentError, match="height"):
        t.concat(TSR(torch.tensor([4]), torch.ones(1, 2), 6))


def test_merge_is_deterministic_and_wraps_negative_ids():
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(-50, 50, 4096))
    vals = torch.from_numpy(rng.randn(4096, 16).astype(np.float32))
    a = TSR(ids, vals, 50).merged()
    b = TSR(ids.clone(), vals.clone(), 50).merged()
    assert torch.equal(a.ids, b.ids) and torch.equal(a.values, b.values)
    # -1 and 49 are the same row: one merged slot, as JAX's to_dense adds
    dense = np.zeros((50, 16))
    np.add.at(dense, np.where(ids.numpy() < 0, ids.numpy() + 50,
                              ids.numpy()), vals.numpy().astype(np.float64))
    np.testing.assert_allclose(TSR(ids, vals, 50).to_dense().numpy(), dense,
                               rtol=1e-5, atol=1e-5)
    assert sorted(i for i in set(a.ids.tolist()) if i < 50) == list(range(50))


def test_safe_rows_copies_a_valid_slot_and_flags_all_padding():
    m = TSR(torch.tensor([7, 2, 2, 9]), torch.arange(8.).reshape(4, 2),
            9).merged()  # ids [2, 7, 9(sentinel), 9]
    ids, vals, keep = tsr.safe_rows(m)
    assert bool(keep) and ids.tolist() == [2, 7, 2, 2]
    np.testing.assert_array_equal(vals.numpy()[2:], vals.numpy()[[0, 0]])
    pad = TSR(torch.tensor([5, 5]), torch.ones(2, 2), 5).merged()
    ids, vals, keep = tsr.safe_rows(pad)
    assert not bool(keep) and ids.tolist() == [4, 4]  # one in-range row
    np.testing.assert_array_equal(vals.numpy(), 0.0)


# -- the one-table net in both packages ---------------------------------------
class JNet(jnn.Layer):
    def __init__(self, sparse, padding_idx=PAD, vocab=VOCAB):
        super().__init__()
        self.emb = jnn.Embedding(vocab, DIM, sparse=sparse,
                                 padding_idx=padding_idx)
        self.fc = jnn.Linear(DIM, 1)

    def forward(self, ids):
        return self.fc(self.emb(ids).mean(axis=1).astype(jnp.float32))


class TNet(tnn.Layer):
    def __init__(self, sparse, padding_idx=PAD, vocab=VOCAB):
        super().__init__()
        self.emb = tnn.Embedding(vocab, DIM, sparse=sparse,
                                 padding_idx=padding_idx)
        self.fc = tnn.Linear(DIM, 1)

    def forward(self, ids):
        return self.fc(self.emb(ids).mean(1).float())


def mse(out, y):
    return ((out - y) ** 2).mean()


def _pair(sparse, padding_idx=PAD, vocab=VOCAB, seed=0):
    jpt.seed(seed)
    jnet = JNet(sparse, padding_idx, vocab)
    tnet = TNet(sparse, padding_idx, vocab)
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    return jnet, tnet


def _batches(seed=0, lo=0, hi=60, pad_share=0.2, n=STEPS):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(lo, hi, (B, F)).astype(np.int32)
        ids[rng.rand(B, F) < pad_share] = PAD
        out.append((ids, rng.randn(B, 1).astype(np.float32)))
    return out


def _train(jnet, jo, tnet, to, batches):
    jm = jpt.Model(jnet, inputs=["ids"], labels=["y"])
    jm.prepare(optimizer=jo, loss=mse)
    tm = tpt.Model(tnet, inputs=["ids"], labels=["y"])
    tm.prepare(optimizer=to, loss=mse)
    jl, tl = [], []
    for ids, y in batches:
        jl.append(float(np.asarray(jm.train_batch([ids], [y])[0])))
        tl.append(tm.train_batch([ids], [y])[0])
    return jm, tm, np.asarray(jl), np.asarray(tl)


def _params(net):
    if isinstance(net, torch.nn.Module):
        return {k: p.detach().float().numpy()
                for k, p in net.named_parameters()}
    return {k: np.asarray(p.value, np.float32)
            for k, p in net.named_parameters()}


def _assert_slots(jm, tm, **tol):
    js, ts = jm._opt_state, tm._optimizer._state
    assert int(js["count"]) == ts["count"]
    for name, tslots in ts["slots"].items():
        jslots = js["slots"][name]
        assert set(tslots) == set(jslots), (name, set(tslots), set(jslots))
        for s, v in tslots.items():
            np.testing.assert_allclose(v.float().numpy(),
                                       np.asarray(jslots[s], np.float32),
                                       err_msg=f"{name}.{s}", **tol)


# name -> (factory(opt module, regularizer module), rows only)
SPARSE_CASES = {
    "sgd": (lambda o, r: o.SGD(0.5), True),
    "sgd_l2": (lambda o, r: o.SGD(0.5, weight_decay=0.1), True),
    "momentum": (lambda o, r: o.Momentum(0.1, momentum=0.9), True),
    "momentum_nesterov_wd": (lambda o, r: o.Momentum(
        0.1, momentum=0.9, use_nesterov=True, weight_decay=0.1), True),
    "adagrad": (lambda o, r: o.Adagrad(
        0.1, initial_accumulator_value=0.1), True),
    "ftrl": (lambda o, r: o.Ftrl(0.1, l1=1e-4, l2=0.01), True),
    "ftrl_lr_power": (lambda o, r: o.Ftrl(0.1, l2=0.01, lr_power=-0.7),
                      True),
    "adam_lazy": (lambda o, r: o.Adam(0.1, lazy_mode=True), True),
    "adam_lazy_l1": (lambda o, r: o.Adam(
        0.1, lazy_mode=True, weight_decay=r.L1Decay(0.01)), True),
    "adam_dense": (lambda o, r: o.Adam(0.1), False),
    "adamw_lazy": (lambda o, r: o.AdamW(0.1, weight_decay=0.5,
                                        lazy_mode=True), True),
    "adamw_lazy_decay_fn": (lambda o, r: o.AdamW(
        0.1, weight_decay=0.5, lazy_mode=True,
        apply_decay_param_fun=lambda n: n == "emb.weight"), True),
    "adamw_dense": (lambda o, r: o.AdamW(0.1, weight_decay=0.5), False),
    "adamax": (lambda o, r: o.Adamax(0.1), False),
    "rmsprop_centered": (lambda o, r: o.RMSProp(
        0.1, centered=True, momentum=0.5), False),
    "adadelta": (lambda o, r: o.Adadelta(1.0), False),
    "clip_global_norm": (lambda o, r: o.Adam(
        0.1, lazy_mode=True, grad_clip=o.ClipGradByGlobalNorm(1e-3)), True),
    "clip_norm": (lambda o, r: o.Momentum(
        0.1, grad_clip=o.ClipGradByNorm(1e-3)), True),
    "clip_value": (lambda o, r: o.SGD(
        0.5, grad_clip=o.ClipGradByValue(1e-3)), True),
}


@pytest.mark.parametrize("case", list(SPARSE_CASES))
def test_sparse_steps_match_jax(case):
    make, rows_only = SPARSE_CASES[case]
    batches = _batches(seed=len(case))
    jnet, tnet = _pair(sparse=True)
    w0 = tnet.emb.weight.detach().clone()
    jm, tm, jl, tl = _train(jnet, make(jopt, jreg), tnet, make(topt, treg),
                            batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    jp, tp = _params(jnet), _params(tnet)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], err_msg=name, **TIGHT)
    _assert_slots(jm, tm, **TIGHT)
    w = tnet.emb.weight.detach()
    assert torch.equal(w[PAD], w0[PAD])  # the padding row never moves
    if rows_only:
        seen = np.unique(np.concatenate([b[0].ravel() for b in batches]))
        untouched = np.setdiff1d(np.arange(VOCAB), seen)
        assert torch.equal(w[untouched], w0[untouched])
        for slot in tm._optimizer._state["slots"]["emb.weight"].values():
            init = 0.1 if case == "adagrad" else 0.0
            assert bool((slot[untouched] == init).all())


@pytest.mark.parametrize("case", ["lamb", "lars"])
def test_lamb_and_lars_densify_sparse_grads(case):
    """The JAX Lamb / Lars raise TypeError on a SelectedRows gradient; the
    port densifies it, which is the JAX dense step (sparse=False)."""
    make = {"lamb": lambda o: o.Lamb(0.01, lamb_weight_decay=0.01),
            "lars": lambda o: o.Lars(0.1, lars_coeff=0.01)}[case]
    batches = _batches(seed=5)
    jnet, _ = _pair(sparse=False)
    _, tnet = _pair(sparse=True)
    jm, tm, jl, tl = _train(jnet, make(jopt), tnet, make(topt), batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    jp, tp = _params(jnet), _params(tnet)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], err_msg=name, **TIGHT)
    _assert_slots(jm, tm, **TIGHT)
    jnet_s, _ = _pair(sparse=True)
    with pytest.raises(TypeError):
        _train(jnet_s, make(jopt), TNet(True), make(topt), batches[:1])


def test_lazy_multistep_first_touch_and_nonlazy_equals_dense():
    # step 1 touches ids < 50, step 2 ids 100..150: a row first seen at
    # step 2 updates as a first touch; step-1 rows stay put in step 2
    batches = (_batches(0, 1, 50, 0.0, 1) + _batches(1, 100, 150, 0.0, 1))
    jnet, tnet = _pair(sparse=True)
    jm, tm, _, _ = _train(jnet, jopt.Adam(0.1, lazy_mode=True), tnet,
                          topt.Adam(0.1, lazy_mode=True), batches[:1])
    after1 = tnet.emb.weight.detach().clone()
    jm.train_batch([batches[1][0]], [batches[1][1]])
    tm.train_batch([batches[1][0]], [batches[1][1]])
    t1 = np.unique(batches[0][0])
    assert torch.equal(tnet.emb.weight.detach()[t1], after1[t1])
    np.testing.assert_allclose(_params(tnet)["emb.weight"],
                               _params(jnet)["emb.weight"], **TIGHT)
    # non-lazy sparse Adam == dense Adam, in the port and against JAX
    batches = _batches(seed=2)
    _, t_dense = _pair(sparse=False)
    jnet, tnet = _pair(sparse=True)
    _train(jnet, jopt.Adam(0.1), tnet, topt.Adam(0.1), batches)
    tm_d = tpt.Model(t_dense, inputs=["ids"], labels=["y"])
    tm_d.prepare(optimizer=topt.Adam(0.1), loss=mse)
    for ids, y in batches:
        tm_d.train_batch([ids], [y])
    np.testing.assert_allclose(_params(tnet)["emb.weight"],
                               _params(t_dense)["emb.weight"], **TIGHT)


def test_multi_precision_master_rows_bf16():
    batches = _batches(seed=4)
    jnet, tnet = _pair(sparse=True)
    jnet.emb.weight.value = jnet.emb.weight.value.astype(jnp.bfloat16)
    tnet.emb.to(torch.bfloat16)
    w0 = tnet.emb.weight.detach().clone()
    mk = lambda o: o.Adam(0.1, lazy_mode=True, multi_precision=True)
    jm, tm, jl, tl = _train(jnet, mk(jopt), tnet, mk(topt), batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    slots = tm._optimizer._state["slots"]["emb.weight"]
    assert slots["master"].dtype == torch.float32
    jmaster = np.asarray(jm._opt_state["slots"]["emb.weight"]["master"])
    # the rows' gradients are bf16 (the deltas take the table's dtype) and
    # may round one step apart in the two packages; Adam's normalized step
    # turns that into up to lr * 2^-7 of the master
    np.testing.assert_allclose(slots["master"].numpy(), jmaster, rtol=1e-6,
                               atol=0.1 * 2 ** -7)
    w = tnet.emb.weight.detach()
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, slots["master"].to(torch.bfloat16))
    seen = np.unique(np.concatenate([b[0].ravel() for b in batches]))
    untouched = np.setdiff1d(np.arange(VOCAB), seen)
    assert torch.equal(w[untouched], w0[untouched])


def test_global_norm_clip_with_heavy_padding_matches_dense():
    """Padded positions carry a zero cotangent: the sparse global norm
    equals the dense path's, in both packages."""
    rng = np.random.RandomState(1)
    ids = rng.randint(1, 50, (B, F)).astype(np.int32)
    ids[:, 1:] = PAD  # two thirds of every sample is padding
    batches = [(ids, rng.randn(B, 1).astype(np.float32))]
    mk = lambda o, lazy: o.Adam(0.1, lazy_mode=lazy,
                                grad_clip=o.ClipGradByGlobalNorm(1e-3))
    jnet, tnet = _pair(sparse=True)
    _train(jnet, mk(jopt, True), tnet, mk(topt, True), batches)
    _, t_dense = _pair(sparse=False)
    tm = tpt.Model(t_dense, inputs=["ids"], labels=["y"])
    tm.prepare(optimizer=mk(topt, False), loss=mse)
    tm.train_batch([ids], [batches[0][1]])
    touched = np.setdiff1d(np.unique(ids), [PAD])
    for other in (_params(jnet), _params(t_dense)):
        np.testing.assert_allclose(_params(tnet)["emb.weight"][touched],
                                   other["emb.weight"][touched], **TIGHT)


def test_clip_norm_counts_each_row_once():
    ids = torch.tensor([3, 3, 3, 5])
    vals = torch.ones(4, 2)
    g = {"t": TSR(ids, vals, 8)}
    out = topt.ClipGradByGlobalNorm(1.0)(g)["t"]
    # merged rows [3]*3 and [5]: norm sqrt(9+9+1+1) = sqrt(20)
    np.testing.assert_allclose(float(out.l2_norm_sq()), 1.0, rtol=1e-6)
    np.testing.assert_allclose(out.values[0].numpy(), 3 / np.sqrt(20),
                               rtol=1e-6)
    v = topt.ClipGradByValue(2.0)(g)["t"]
    np.testing.assert_array_equal(v.values[0].numpy(), 2.0)  # summed, then


# -- ids outside the table -----------------------------------------------------
def test_out_of_range_ids_both_paths_match_jax():
    jnet, tnet = _pair(sparse=True, padding_idx=None, vocab=10)
    ids = np.array([[1, 12, -1, -10, -11, 10, 9]], np.int32)
    jw = jnet.emb.weight.value
    # dense path: NaN rows for ids >= n or < -n, negative ids wrap
    from paddle_tpu.nn import functional as jF
    from paddle_tpu_torch.nn import functional as tF
    np.testing.assert_allclose(
        tF.embedding(torch.from_numpy(ids), tnet.emb.weight).detach().numpy(),
        np.asarray(jF.embedding(jnp.asarray(ids), jw)), **TIGHT)
    np.testing.assert_allclose(
        tnet.emb(ids).detach().numpy(),                      # sparse flag,
        np.asarray(jnet.emb(jnp.asarray(ids))), **TIGHT)  # no tape: dense
    # sparse tap: zeros for ids outside, the same wrap
    from paddle_tpu.framework import selected_rows as jsr
    with jsr.sparse_tape([jnp.zeros((1, 7, DIM))]):
        jrows = jnet.emb(jnp.asarray(ids))
    with tsr.sparse_tape() as tape:
        trows = tnet.emb(ids)
    np.testing.assert_allclose(trows.detach().numpy(), np.asarray(jrows),
                               **TIGHT)
    assert len(tape.taps) == 1
    # a training step with such ids: the inside ids update as JAX's, the
    # rest is dropped
    y = np.ones((1, 1), np.float32)
    w0 = tnet.emb.weight.detach().clone()
    _train(jnet, jopt.SGD(1.0), tnet, topt.SGD(1.0), [(ids, y)])
    np.testing.assert_allclose(_params(tnet)["emb.weight"],
                               _params(jnet)["emb.weight"], **TIGHT)
    moved = (tnet.emb.weight.detach() != w0).any(1).nonzero().ravel()
    assert moved.tolist() == [0, 1, 9]  # -10 -> 0, -1 -> 9, 1


def test_padding_idx_dense_forward_and_zero_row_at_build():
    jnet, tnet = _pair(sparse=False, padding_idx=2, vocab=6)
    assert float(tnet.emb.weight[2].abs().sum()) == 0.0
    fresh = tnn.Embedding(6, 3, padding_idx=4)
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    assert float(fresh.weight[4].abs().sum()) == 0.0
    ids = np.array([[2, 0, 5, 2]], np.int32)
    np.testing.assert_allclose(tnet.emb(ids).detach().numpy(),
                               np.asarray(jnet.emb(jnp.asarray(ids))),
                               **TIGHT)


# -- the contract: lookups are a sparse table's only gradient -----------------
class _TwoReads(tnn.Layer):
    def __init__(self, sparse):
        super().__init__()
        self.emb = tnn.Embedding(VOCAB, DIM, sparse=sparse)
        self.fc = tnn.Linear(DIM, 1)

    def forward(self, ids):
        # the second read: a regularization-like term over the whole table
        return self.fc(self.emb(ids).mean(1)) + self.emb.weight.sum() * 1e-3


class _JTwoReads(jnn.Layer):
    def __init__(self, sparse):
        super().__init__()
        self.emb = jnn.Embedding(VOCAB, DIM, sparse=sparse)
        self.fc = jnn.Linear(DIM, 1)

    def forward(self, ids):
        return (self.fc(self.emb(ids).mean(axis=1))
                + self.emb.weight.value.sum() * 1e-3)


@pytest.mark.parametrize("sparse", [True, False])
def test_second_read_of_a_sparse_table_gets_no_gradient(sparse):
    jpt.seed(0)
    jnet = _JTwoReads(sparse)
    tnet = _TwoReads(sparse)
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    w0 = tnet.emb.weight.detach().clone()
    batches = _batches(seed=7, pad_share=0.0, n=2)
    _train(jnet, jopt.SGD(0.5), tnet, topt.SGD(0.5), batches)
    np.testing.assert_allclose(_params(tnet)["emb.weight"],
                               _params(jnet)["emb.weight"], **TIGHT)
    seen = np.unique(np.concatenate([b[0].ravel() for b in batches]))
    untouched = np.setdiff1d(np.arange(VOCAB), seen)
    w = tnet.emb.weight.detach()
    # sparse: the sum's gradient (1e-3 on every row) trains nothing; dense:
    # it moves every row
    assert torch.equal(w[untouched], w0[untouched]) == sparse
    assert tnet.emb.weight.requires_grad  # restored after the step


def test_sparse_flag_is_inert_outside_a_sparse_step_grad_scaler():
    """The JAX GradScaler has no SelectedRows branch; the port's eager
    loop (scale, backward, step) never builds a tape, so a sparse table
    gets a dense ``.grad`` there and trains as sparse=False does."""
    out = []
    for sparse in (True, False):
        tpt.seed(0)
        net = TNet(sparse)
        for m in net.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(torch.Generator().manual_seed(0))
        opt = topt.Adam(0.1, parameters=dict(net.named_parameters()))
        scaler = tpt.amp.GradScaler(init_loss_scaling=2.0 ** 10)
        for ids, y in _batches(seed=9):
            loss = mse(net(ids), torch.from_numpy(y))
            scaler.scale(loss).backward()
            assert net.emb.weight.grad is not None
            assert net.emb.weight.grad.shape == (VOCAB, DIM)
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
        out.append(net.emb.weight.detach().clone())
    assert torch.equal(out[0], out[1])


# -- init, the rest of the slice's surface ------------------------------------
def test_embedding_default_init_is_standard_normal_in_both_packages():
    jpt.seed(0)
    jw = np.asarray(jnn.Embedding(4000, 64).weight.value)
    t = tnn.Embedding(4000, 64)
    t.reset_parameters(torch.Generator().manual_seed(0))
    for w in (jw, t.weight.detach().numpy()):
        assert abs(w.std() - 1.0) < 0.01 and abs(w.mean()) < 0.01
    from paddle_tpu_torch.distributed.meta_parallel import \
        VocabParallelEmbedding
    from paddle_tpu_torch.models import bert as tbert
    from paddle_tpu_torch.models import gpt as tgpt
    v = VocabParallelEmbedding(4000, 64, sparse=True)
    v.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(v.weight.std()) - 0.02) < 2e-4 and v.sparse
    bert = tbert.BertModel(tbert.bert_tiny(), device="cpu")
    gpt = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu").gpt
    for table in (bert.embeddings.position, bert.embeddings.token_type,
                  gpt.wpe):
        assert float(table.weight.std()) < 0.05, table


def test_distributed_names_raise_citing_distributed_execution():
    # ported since: all_gather_rows over a one-rank data axis is the rows
    # scaled, and DGCMomentum builds but refuses the eager step, as JAX's
    got = tsr.all_gather_rows(TSR(torch.tensor([0, 2]), torch.ones(2, 2), 3),
                              "data", scale=0.5)
    np.testing.assert_array_equal(got.ids.numpy(), [0, 2])
    np.testing.assert_array_equal(got.values.numpy(), np.full((2, 2), 0.5))
    with pytest.raises(Exception, match="only runs through Model.prepare"):
        topt.DGCMomentum(0.1).step()
    # ParamAttr is ported (the k-step slice): an Embedding honors its
    # initializer instead of raising
    emb = tnn.Embedding(4, 2, sparse=True, weight_attr=tnn.ParamAttr(
        initializer=tnn.initializer.Constant(0.5)))
    emb.reset_parameters()
    assert bool((emb.weight == 0.5).all()) and emb.weight.sparse


def test_sparse_param_names_survive_deepcopy():
    import copy

    net = TNet(True)
    assert list(tsr.sparse_param_names(net).values()) == ["emb.weight"]
    twin = copy.deepcopy(net)
    assert list(tsr.sparse_param_names(twin).values()) == ["emb.weight"]
    assert tsr.sparse_param_names(TNet(False)) == {}


# -- on the card: a million-row table against the CPU -------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card-against-CPU twins of "
                    "chip_smoke.py S1")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sgd", "momentum", "adagrad", "ftrl",
                                  "adam_lazy", "adam_dense", "adamw_lazy"])
def test_card_rows_match_cpu_and_repeat_bit_equal(case):
    dev = _card()
    make, rows_only = SPARSE_CASES[case]
    vocab = 1_000_000
    tpt.seed(0)
    cpu = TNet(True, vocab=vocab)
    for m in cpu.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (256, 8)).astype(np.int64)
    ids[:, :3] = rng.randint(0, 64, (256, 3))   # repeated ids
    ids[rng.rand(256, 8) < 0.1] = PAD
    y = rng.randn(256, 1).astype(np.float32)
    runs = []
    for d in (torch.device("cpu"), dev, dev):
        net = TNet(True, vocab=vocab).to(d)
        net.load_state_dict(cpu.state_dict())
        m = tpt.Model(net, inputs=["ids"], labels=["y"])
        m.prepare(optimizer=make(topt, treg), loss=mse)
        m.train_batch([ids], [y])
        runs.append(net.emb.weight.detach().cpu())
    touched = np.unique(ids)
    np.testing.assert_allclose(runs[1][touched].numpy(),
                               runs[0][touched].numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(runs[1], runs[2])
    w0 = cpu.emb.weight.detach()
    assert torch.equal(runs[1][PAD], w0[PAD])
    if rows_only:
        keep = torch.ones(vocab, dtype=torch.bool)
        keep[touched] = False
        assert torch.equal(runs[1][keep], w0[keep])
