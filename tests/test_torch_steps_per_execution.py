"""``Model.prepare(steps_per_execution=k)`` in the port held against the
JAX package's k-step ``lax.scan`` (``paddle_tpu/hapi/model.py``), and the
SelectedRows merge's fixed summation order.

On the CPU the k steps of an execution run eagerly, so an execution must
equal k ``train_batch`` calls bit for bit; against JAX's
``_train_batches_device`` the parameters are held to the JAX test's rtol
1e-5 / atol 1e-6 (``tests/test_hapi.py::TestStepsPerExecution``), Adam's
to 1e-5 (its normalized step turns float32 rounding of a near-zero
gradient into up to lr of movement, as in ``test_torch_ctr.py``).
``gpu``-marked twins run the same executions on the card, where every
execution after the first is one CUDA graph replay, against eager steps.
"""
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.optimizer import gradient_merge as _jgm  # noqa: F401
from paddle_tpu.framework.selected_rows import SelectedRows as JRows
from paddle_tpu.models import wide_deep as jwd
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.framework.selected_rows import SelectedRows
from paddle_tpu_torch.models import wide_deep_tiny
from paddle_tpu_torch.optimizer import gradient_merge as _tgm  # noqa: F401
from paddle_tpu_torch.optimizer.optimizer import _bias_correction

RTOL, ATOL = 1e-5, 1e-6


def _data(n=24, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6).astype(np.float32)
    w = rng.randn(6, 1).astype(np.float32)
    return x, (x @ w + 0.1).astype(np.float32)


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _nets(device="cpu"):
    """The JAX test's MLP in both packages, from one bridged init."""
    jpt.seed(3)
    jnet = jnn.Sequential(jnn.Linear(6, 8), jnn.ReLU(), jnn.Linear(8, 1))
    tnet = tnn.Sequential(tnn.Linear(6, 8), tnn.ReLU(), tnn.Linear(8, 1))
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    return jnet, tnet.to(device)


def _jmodel(jnet, opt, spe, **kw):
    m = jpt.Model(jnet, inputs=["x"], labels=["y"])
    m.prepare(optimizer=opt, loss=jnn.MSELoss(), steps_per_execution=spe,
              **kw)
    return m


def _tmodel(tnet, opt, spe, **kw):
    m = tpt.Model(tnet, inputs=["x"], labels=["y"])
    m.prepare(optimizer=opt, loss=_mse, steps_per_execution=spe, **kw)
    return m


def _params(net):
    return {k: p.detach().cpu().numpy().copy()
            for k, p in net.named_parameters()}


def _jparams(net):
    return {k: np.asarray(p.value) for k, p in net.named_parameters()}


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_close(port, jax_, rtol=RTOL, atol=ATOL):
    for k in jax_:
        np.testing.assert_allclose(port[k], jax_[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# -- the k-step trajectory ---------------------------------------------------
def test_trajectory_matches_single_steps_and_jax():
    x, y = _data()
    batches = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 24, 8)]
    jnet, tnet1 = _nets()
    m1 = _tmodel(tnet1, topt.SGD(0.05), 1)
    for bx, by in batches:
        m1.train_batch([bx], [by])
    _, tnet3 = _nets()
    m3 = _tmodel(tnet3, topt.SGD(0.05), 3)
    losses = m3._train_batches_device(batches)
    assert losses.shape == (3,)
    _assert_equal(_params(tnet3), _params(tnet1))
    jm = _jmodel(jnet, jopt.SGD(learning_rate=0.05), 3)
    jlosses = np.asarray(jm._train_batches_device(batches))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=RTOL)
    _assert_close(_params(tnet3), _jparams(jnet))


@pytest.mark.parametrize("n,epochs", [(56, 3), (44, 2)],
                         ids=["ragged_tail", "partial_batch_in_group"])
def test_fit_groups_and_flushes_as_jax(n, epochs):
    """56 samples / batch 8: two full groups of 3 and one single step an
    epoch; 44: 8, 8, 8 | 8, 8, 4 — the 4-sample batch flushes its group
    as single steps.  The same trajectory as JAX's fit, and as the port's
    fit at k = 1 bit for bit; callbacks fire once per execution."""
    x, y = _data(n=n)
    jnet, tnet = _nets()
    _, tnet1 = _nets()
    tm = _tmodel(tnet, topt.SGD(0.05), 3)
    seen = []

    class Count(tpt.hapi.callbacks.Callback):
        def on_train_begin(self, logs=None):
            seen.append(("steps", self.params.get("steps")))

        def on_train_batch_end(self, step, logs=None):
            seen.append((step, float(logs["loss"]), logs["batch_size"]))

    tm.fit(tpt.io.TensorDataset([x, y]), batch_size=8, epochs=epochs,
           verbose=0, shuffle=False, callbacks=[Count()])
    _tmodel(tnet1, topt.SGD(0.05), 1).fit(
        tpt.io.TensorDataset([x, y]), batch_size=8, epochs=epochs, verbose=0,
        shuffle=False)
    jm = _jmodel(jnet, jopt.SGD(learning_rate=0.05), 3)
    jm.fit(jpt.io.TensorDataset([x, y]), batch_size=8, epochs=epochs,
           verbose=0, shuffle=False)
    _assert_equal(_params(tnet), _params(tnet1))
    _assert_close(_params(tnet), _jparams(jnet))
    assert seen[0] == ("steps", None)
    per_epoch = {56: [24, 24, 8], 44: [24, 8, 8, 4]}[n]
    assert [s[2] for s in seen[1:]] == per_epoch * epochs
    assert [s[0] for s in seen[1:]] == list(range(len(per_epoch))) * epochs


def test_validation_as_jax():
    net = tnn.Linear(4, 1)
    m = tpt.Model(net, inputs=["x"], labels=["y"])
    with pytest.raises(InvalidArgumentError, match="steps_per_execution"):
        m.prepare(optimizer=topt.SGD(0.1), loss=_mse, steps_per_execution=0)
    with pytest.raises(InvalidArgumentError, match="metrics"):
        m.prepare(optimizer=topt.SGD(0.1), loss=_mse,
                  metrics=[tpt.metric.Accuracy()], steps_per_execution=2)
    fleet = topt.SGD(0.1)
    fleet._fleet_strategy = object()
    # JAX's error since the distributed slice: a plan runs single steps
    with pytest.raises(InvalidArgumentError,
                       match="does not yet compose with fleet strategies"):
        m.prepare(optimizer=fleet, loss=_mse, steps_per_execution=2)
    m.prepare(optimizer=topt.SGD(0.1), loss=_mse)
    with pytest.raises(InvalidArgumentError, match="steps_per_execution"):
        m._train_batches_device([(np.zeros((2, 4), np.float32),
                                  np.zeros((2, 1), np.float32))])
    m.prepare(optimizer=topt.SGD(0.1), loss=_mse, steps_per_execution=2)
    with pytest.raises(InvalidArgumentError, match="takes 2 batches"):
        m._train_batches_device([(np.zeros((2, 4), np.float32),
                                  np.zeros((2, 1), np.float32))])


def test_lr_scheduler_read_once_per_execution_as_jax():
    """A per-batch LRScheduler callback steps once per execution: the k
    steps of an execution share one learning rate (with the warning)."""
    x, y = _data(n=48)
    jnet, tnet = _nets()
    tsched = topt.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    jsched = jopt.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    with pytest.warns(UserWarning, match="read once per execution"):
        tm = _tmodel(tnet, topt.SGD(tsched), 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = _jmodel(jnet, jopt.SGD(learning_rate=jsched), 3)
    lrs = []

    class Seen(tpt.hapi.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            lrs.append(tsched.last_lr)

    tm.fit(tpt.io.TensorDataset([x, y]), batch_size=8, epochs=1, verbose=0,
           shuffle=False, callbacks=[tpt.hapi.callbacks.LRScheduler(
               by_step=True), Seen()])
    jm.fit(jpt.io.TensorDataset([x, y]), batch_size=8, epochs=1, verbose=0,
           shuffle=False, callbacks=[jpt.hapi.callbacks.LRScheduler(
               by_step=True)])
    assert lrs == [0.1, 0.05]
    _assert_close(_params(tnet), _jparams(jnet))


# -- the sparse branch and the optimizers with host branches -----------------
def _clicks(n, seed, vocab=48, fields=4, dense=4):
    r = np.random.RandomState(seed)
    ids = r.randint(0, vocab, size=(n, fields)).astype(np.int32)
    xd = r.randn(n, dense).astype(np.float32)
    y = (r.uniform(size=(n, 1)) < 0.4).astype(np.float32)
    return ids, xd, y


def test_sparse_wide_deep_k4_matches_single_steps_and_jax():
    jpt.seed(0)
    jnet = jwd.wide_deep_tiny(sparse=True)
    tnet = wide_deep_tiny(sparse=True, device="cpu")
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    w0 = tnet.embedding.weight.detach().clone()
    _, tnet1 = None, wide_deep_tiny(sparse=True, device="cpu")
    load_jax_params(tnet1, {k: np.asarray(p.value)
                            for k, p in jnet.named_parameters()})
    jm = jpt.Model(jnet, inputs=["sparse", "dense"], labels=["label"])
    jm.prepare(optimizer=jopt.Adam(1e-2, lazy_mode=True), loss=jnet.loss,
               steps_per_execution=4)
    tm = tpt.Model(tnet, inputs=["sparse", "dense"], labels=["label"])
    tm.prepare(optimizer=topt.Adam(1e-2, lazy_mode=True), loss=tnet.loss,
               steps_per_execution=4)
    tm1 = tpt.Model(tnet1, inputs=["sparse", "dense"], labels=["label"])
    tm1.prepare(optimizer=topt.Adam(1e-2, lazy_mode=True), loss=tnet1.loss)
    batches = [_clicks(64, 10 + s) for s in range(8)]
    for e in range(2):
        group = batches[4 * e:4 * e + 4]
        tl = tm._train_batches_device(group)
        jl = np.asarray(jm._train_batches_device(group))
        np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5)
        for ids, xd, y in group:
            tm1.train_batch([ids, xd], [y])
    _assert_equal(_params(tnet), _params(tnet1))
    _assert_close(_params(tnet), _jparams(jnet), rtol=1e-5, atol=1e-5)
    unseen = np.arange(48, 64)  # ids are drawn below 48: lazy rows stay
    assert torch.equal(tnet.embedding.weight.detach()[unseen], w0[unseen])


def _lookahead(pkg, lr):
    return pkg.Lookahead(pkg.SGD(lr), alpha=0.5, k=5)


def _gradient_merge(pkg, lr):
    return pkg.gradient_merge.GradientMergeOptimizer(pkg.Adam(lr),
                                                     k_steps=3)


@pytest.mark.parametrize("make", [_lookahead, _gradient_merge],
                         ids=["lookahead_k5", "gradient_merge_k3"])
def test_periodic_optimizers_with_k_not_dividing_their_period(make):
    """Graph k = 4 against a period of 5 (Lookahead) and 3 (gradient
    merge): three executions cross the sync / apply steps at different
    places of an execution; equal to 12 single steps, and to JAX's
    multi-step."""
    x, y = _data(n=96, seed=1)
    batches = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 96, 8)]
    jnet, tnet = _nets()
    _, tnet1 = _nets()
    tm = _tmodel(tnet, make(topt, 0.05), 4)
    tm1 = _tmodel(tnet1, make(topt, 0.05), 1)
    jm = _jmodel(jnet, make(jopt, 0.05), 4)
    for e in range(3):
        group = batches[4 * e:4 * e + 4]
        tm._train_batches_device(group)
        jm._train_batches_device(group)
        for bx, by in group:
            tm1.train_batch([bx], [by])
    _assert_equal(_params(tnet), _params(tnet1))
    _assert_close(_params(tnet), _jparams(jnet), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt", ["Adam", "AdamW", "Adamax", "Lamb"])
def test_step_scalars_are_the_host_arithmetic(opt):
    """The per-step scalar table holds ``_bias_correction``'s float32
    bits (and AdamW's decay in double): a step reads what the host
    computed, whether the row came from an eager copy or a graph's
    table."""
    b1, b2 = 0.9, 0.999
    o = getattr(topt, opt)(0.01)
    state = {"count": 0}
    for t in range(1, 9):
        plan = o._plan(state, 0.01)
        plan.materialize("cpu")
        if opt == "Adamax":
            want = 0.01 / _bias_correction(b1, t)
            assert plan.values[plan.names["step"]] == want
            continue
        for name, beta in (("bc1", b1), ("bc2", b2)):
            got = plan.get(name)
            assert got.dtype == torch.float32
            assert np.float32(got.item()).tobytes() == np.float32(
                _bias_correction(beta, t)).tobytes()
        if opt == "AdamW":
            assert plan.values[plan.names["decay"]] == 1.0 - 0.01 * 0.01
    assert state["count"] == 8


# -- the SelectedRows merge ----------------------------------------------------
def _merge_both(ids, values, height):
    t = SelectedRows(torch.from_numpy(ids), torch.from_numpy(values),
                     height).merged()
    j = JRows(jnp.asarray(ids), jnp.asarray(values), height).merged()
    return (t.ids.numpy(), t.values.numpy(), np.asarray(j.ids),
            np.asarray(j.values))


def test_merge_small_segment_after_large_row_bit_equal_to_jax():
    ids = np.array([0, 1, 2, 2])
    values = np.array([[1e3], [3e-7], [1e-9], [2e-9]], np.float32)
    ti, tv, ji, jv = _merge_both(ids, values, 10)
    np.testing.assert_array_equal(ti, ji)
    assert tv.tobytes() == jv.tobytes()
    assert tv[2, 0] == np.float32(2.9999998e-9)


def test_merge_one_row_segments_in_a_1m_table_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    ids = rng.choice(1_000_000, 2048, replace=False)
    values = rng.randn(2048, 8).astype(np.float32)
    small = rng.choice(2048, 2048 // 100, replace=False)
    values[small] *= np.float32(1e-6)
    ti, tv, ji, jv = _merge_both(ids, values, 1_000_000)
    np.testing.assert_array_equal(ti, ji)
    assert tv.tobytes() == jv.tobytes()


def test_merge_repeated_segments_within_one_ulp_of_fsum():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 500, 2048)
    values = rng.randn(2048, 4).astype(np.float32)
    values[::7] *= np.float32(1e4)  # large and small terms in a segment
    sr = SelectedRows(torch.from_numpy(ids), torch.from_numpy(values), 500)
    m = sr.merged()
    uniq = np.unique(ids)
    np.testing.assert_array_equal(m.ids.numpy()[:len(uniq)], uniq)
    got = m.values.numpy()[:len(uniq)]
    ref = np.array([[math.fsum(values[ids == i, c].astype(np.float64))
                     for c in range(4)] for i in uniq], np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()
    assert (m.values.numpy()[len(uniq):] == 0).all()


# -- on the card: executions after the first are CUDA graph replays ----------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: k-step executions as CUDA graph "
                    "replays against eager steps")
    return torch.device("cuda")


def _dropout_mlp(device):
    tpt.seed(7)
    net = tnn.Sequential(tnn.Linear(6, 64), tnn.ReLU(), tnn.Dropout(0.1),
                         tnn.Linear(64, 1))
    net[0].reset_parameters(torch.Generator().manual_seed(1))
    net[3].reset_parameters(torch.Generator().manual_seed(2))
    return net.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [
    lambda: topt.AdamW(1e-2, multi_precision=True),
    lambda: _lookahead(topt, 0.05), lambda: _gradient_merge(topt, 0.05)],
    ids=["adamw", "lookahead_k5", "gradient_merge_k3"])
def test_graph_equals_eager_on_the_card(make):
    dev = _card()
    x, y = _data(n=96, seed=2)
    batches = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 96, 8)]
    _, eager_net = _nets(dev)
    _, graph_net = _nets(dev)
    eager = _tmodel(eager_net, make(), 1)
    graph = _tmodel(graph_net, make(), 4)
    for e in range(3):
        group = batches[4 * e:4 * e + 4]
        graph._train_batches_device(group)
        for bx, by in group:
            eager.train_batch([bx], [by])
    assert graph._graph_steps.executions == 3
    assert graph._graph_steps.captures >= 1
    _assert_equal(_params(graph_net), _params(eager_net))


@pytest.mark.gpu
def test_dropout_masks_differ_across_steps_and_replays_on_the_card():
    dev = _card()
    x, y = _data(n=96, seed=3)
    batches = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 96, 8)]
    eager_net, graph_net = _dropout_mlp(dev), _dropout_mlp(dev)
    tpt.seed(11)
    eager = _tmodel(eager_net, topt.SGD(0.05), 1)
    el = [eager.train_batch([bx], [by])[0] for bx, by in batches]
    tpt.seed(11)
    graph = _tmodel(graph_net, topt.SGD(0.05), 4)
    gl = torch.cat([graph._train_batches_device(batches[4 * e:4 * e + 4])
                    for e in range(3)]).tolist()
    assert gl == el  # the same masks, step for step
    _assert_equal(_params(graph_net), _params(eager_net))
    # same inputs every step: the losses differ only through the masks
    tpt.seed(11)
    probe = _tmodel(_dropout_mlp(dev), topt.SGD(0.0), 4)
    same = [batches[0]] * 4
    losses = torch.cat([probe._train_batches_device(same)
                        for _ in range(3)]).tolist()
    assert len(set(losses)) == 12, losses


@pytest.mark.gpu
def test_launch_counters_count_each_replay_on_the_card():
    from paddle_tpu_torch.ops.fused_softmax_xent import softmax_cross_entropy
    dev = _card()
    net = tnn.Sequential(tnn.Linear(6, 32)).to(dev)
    m = tpt.Model(net, inputs=["x"], labels=["y"])
    m.prepare(optimizer=topt.SGD(0.1), loss=lambda logits, y:
              softmax_cross_entropy(logits, y.squeeze(-1)).mean(),
              steps_per_execution=4)
    rng = np.random.RandomState(0)
    group = [(rng.randn(16, 6).astype(np.float32),
              rng.randint(0, 32, (16, 1)).astype(np.int64))
             for _ in range(4)]
    per_step = []
    for _ in range(3):
        softmax_cross_entropy.launches = 0
        m._train_batches_device(group)
        per_step.append(softmax_cross_entropy.launches)
    assert per_step == [4, 4, 4], per_step


@pytest.mark.gpu
def test_merge_bit_equal_across_two_runs_on_the_card():
    dev = _card()
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 1_000_000, (2048,), generator=g)
    values = torch.randn(2048, 32, generator=g)
    a = SelectedRows(ids.to(dev), values.to(dev), 1_000_000).merged()
    b = SelectedRows(ids.to(dev), values.to(dev), 1_000_000).merged()
    assert torch.equal(a.ids, b.ids) and torch.equal(a.values, b.values)
    cpu = SelectedRows(ids, values, 1_000_000).merged()
    assert torch.equal(a.ids.cpu(), cpu.ids)
    assert torch.equal(a.values.cpu(), cpu.values)
