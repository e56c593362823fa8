"""``Executor.run_steps`` of the port: N chained optimizer steps in one
call, held to N sequential ``Executor.run`` calls (the cases of
``tests/test_run_steps.py``) and to the JAX package's ``run_steps``.

On the CPU the N steps run eagerly, so a chain equals N ``run`` calls
bit for bit; the test holds it at rtol 1e-5 / atol 1e-6, the JAX test's
tolerance, and the chain against the JAX chain (same program, bridged
scope) at the same.  The learning rate of each step is the scheduler's
after the steps before it: a closed-form scheduler gives N ``run`` calls'
rates and parameters.  ``gpu``-marked tests (skipped without a card): on
the card a replayed chain (one CUDA graph) equals N eager ``run`` steps
bit for bit, and each replay advances the kernels' launch counters.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as tpt
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.static.graph import reset_default_programs as jreset
from paddle_tpu_torch.bridge import load_jax_program
from paddle_tpu_torch.framework import device as tdevice
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.static import ExecutionStrategy
from paddle_tpu_torch.static.graph import reset_default_programs as treset


@pytest.fixture(autouse=True)
def _fresh():
    saved = tdevice._chosen
    tdevice.set_device("cpu")
    jreset()
    treset()
    yield
    jreset()
    treset()
    tdevice._chosen = saved


def _key(name):
    return name.split("_", 2)[2]


def _params(prog):
    return {_key(k): v for k, v in prog.parameters_numpy().items()}


def _mlp(opt_factory, fluid=tfluid, pkg=tpt):
    pkg.seed(0)  # identical init across the programs a test builds
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 13])
        y = fluid.data("y", [-1, 1])
        h = fluid.layers.fc(x, 8, act="relu")
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        opt = opt_factory(fluid)
        opt.minimize(loss)
    return main, startup, loss, opt


def _exe(**kw):
    return tfluid.Executor(tfluid.CPUPlace(), **kw)


def _batches(n, bs=8, din=13):
    rng = np.random.RandomState(0)
    return (rng.rand(n, bs, din).astype(np.float32),
            rng.rand(n, bs, 1).astype(np.float32))


def _run_both(opt_factory, n=5):
    X, Y = _batches(n)
    main, startup, loss, opt_a = _mlp(opt_factory)
    exe = _exe()
    exe.run(startup)
    seq = [float(exe.run(main, feed={"x": X[t], "y": Y[t]},
                         fetch_list=[loss])[0]) for t in range(n)]
    main2, startup2, loss2, opt_b = _mlp(opt_factory)
    exe2 = _exe()
    exe2.run(startup2)
    fused, = exe2.run_steps(main2, feed={"x": X, "y": Y},
                            fetch_list=[loss2])
    return seq, np.asarray(fused), _params(main), _params(main2), \
        opt_a, opt_b


def _close(pa, pb):
    for k, v in pb.items():
        np.testing.assert_allclose(v, pa[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("make", [
    lambda f: f.optimizer.SGD(learning_rate=0.1),
    lambda f: f.optimizer.AdamOptimizer(learning_rate=0.01),
    lambda f: f.optimizer.MomentumOptimizer(0.05, momentum=0.9)],
    ids=["sgd", "adam", "momentum"])
def test_chain_matches_sequential_runs(make):
    seq, fused, pa, pb, _, _ = _run_both(make)
    np.testing.assert_allclose(fused.ravel(), seq, rtol=1e-5, atol=1e-6)
    _close(pa, pb)


@pytest.mark.parametrize("make", [
    lambda f: f.optimizer.SGD(learning_rate=0.1),
    lambda f: f.optimizer.AdamOptimizer(learning_rate=0.01)],
    ids=["sgd", "adam"])
def test_chain_matches_the_jax_chain(make):
    n = 6
    X, Y = _batches(n)
    jmain, jstart, jloss, _ = _mlp(make, jfluid, jpt)
    tmain, tstart, tloss, _ = _mlp(make)
    jexe, texe = jfluid.Executor(), _exe()
    jexe.run(jstart)
    texe.run(tstart)
    load_jax_program(tmain, {k: np.asarray(v)
                             for k, v in jmain.scope.items()})
    jl, = jexe.run_steps(jmain, feed={"x": X, "y": Y}, fetch_list=[jloss])
    tl, = texe.run_steps(tmain, feed={"x": X, "y": Y}, fetch_list=[tloss])
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5, atol=1e-6)
    _close({_key(k): np.asarray(v) for k, v in jmain.scope.items()},
           _params(tmain))


def test_one_dispatch_per_chain():
    X, Y = _batches(6)
    main, startup, loss, _ = _mlp(lambda f: f.optimizer.SGD(0.1))
    exe = _exe()
    exe.run(startup)  # empty startup: no dispatch
    assert exe.dispatches == 0
    exe.run_steps(main, feed={"x": X, "y": Y}, fetch_list=[loss])
    assert exe.dispatches == 1
    exe.run_steps(main, feed={"x": X, "y": Y}, fetch_list=[loss])
    assert exe.dispatches == 2
    stats = exe.cache_stats()
    assert stats["hits"] == 1 and stats["misses"] == 1


def test_closed_form_scheduler_gives_the_sequential_rates():
    """StepDecay over a 6-step chain: each step's rate is the scheduler's
    after the steps before it, as 6 ``run`` calls step it; the parameters
    follow, and the scheduler ends where the sequential one does."""
    def make(f):
        return f.optimizer.SGD(
            tpt.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5))

    X, Y = _batches(6)
    main, startup, loss, opt_a = _mlp(make)
    exe = _exe()
    exe.run(startup)
    seq_rates = []
    for t in range(6):
        seq_rates.append(opt_a.get_lr())
        exe.run(main, feed={"x": X[t], "y": Y[t]}, fetch_list=[loss])
    main2, startup2, loss2, opt_b = _mlp(make)
    exe2 = _exe()
    exe2.run(startup2)
    seen = []
    orig = opt_b._plan

    def spy(state, lr):
        seen.append(lr)
        return orig(state, lr)

    opt_b._plan = spy
    exe2.run_steps(main2, feed={"x": X, "y": Y}, fetch_list=[loss2])
    assert seen == seq_rates == [0.1, 0.1, 0.05, 0.05, 0.025, 0.025]
    assert opt_b.lr_scheduler.last_epoch == opt_a.lr_scheduler.last_epoch
    _close(_params(main), _params(main2))


def test_bn_buffers_match_sequential():
    def build():
        tpt.seed(0)
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.data("x", [-1, 6])
            y = tfluid.data("y", [-1, 1])
            b = tfluid.layers.batch_norm(tfluid.layers.fc(x, 8))
            pred = tfluid.layers.fc(b, 1)
            loss = tfluid.layers.mean(
                tfluid.layers.square_error_cost(pred, y))
            tfluid.optimizer.SGD(0.1).minimize(loss)
        return main, startup, loss

    n = 4
    rng = np.random.RandomState(0)
    X = rng.rand(n, 16, 6).astype(np.float32)
    Y = rng.rand(n, 16, 1).astype(np.float32)
    main, startup, loss = build()
    exe = _exe()
    exe.run(startup)
    bufs0 = main.state_dict()
    for t in range(n):
        exe.run(main, feed={"x": X[t], "y": Y[t]}, fetch_list=[loss])
    seq = {_key(k): v for k, v in main.state_dict().items()}
    assert any(not np.array_equal(bufs0[k], v.detach().numpy())
               for k, v in main.buffers.items())
    main2, startup2, loss2 = build()
    exe2 = _exe()
    exe2.run(startup2)
    exe2.run_steps(main2, feed={"x": X, "y": Y}, fetch_list=[loss2])
    _close(seq, {_key(k): v for k, v in main2.state_dict().items()})


def test_fetch_every_subsamples():
    X, Y = _batches(6)
    main, startup, loss, _ = _mlp(lambda f: f.optimizer.SGD(0.1))
    exe = _exe()
    exe.run(startup)
    all_losses, = exe.run_steps(main, feed={"x": X, "y": Y},
                                fetch_list=[loss])
    main2, startup2, loss2, _ = _mlp(lambda f: f.optimizer.SGD(0.1))
    exe2 = _exe()
    exe2.run(startup2)
    sub, = exe2.run_steps(main2, feed={"x": X, "y": Y},
                          fetch_list=[loss2], fetch_every=2)
    assert sub.shape[0] == 3
    np.testing.assert_allclose(sub, all_losses[1::2], rtol=1e-5, atol=1e-6)
    with pytest.raises(InvalidArgumentError, match="fetch_every"):
        exe2.run_steps(main2, feed={"x": X, "y": Y}, fetch_list=[loss2],
                       fetch_every=0)


def test_iterator_of_feed_dicts():
    X, Y = _batches(4)
    main, startup, loss, _ = _mlp(lambda f: f.optimizer.SGD(0.1))
    exe = _exe()
    exe.run(startup)
    stacked, = exe.run_steps(main, feed={"x": X, "y": Y}, fetch_list=[loss])
    main2, startup2, loss2, _ = _mlp(lambda f: f.optimizer.SGD(0.1))
    exe2 = _exe()
    exe2.run(startup2)
    it = ({"x": X[t], "y": Y[t]} for t in range(4))
    from_iter, = exe2.run_steps(main2, feed=it, fetch_list=[loss2])
    np.testing.assert_allclose(from_iter, stacked, rtol=1e-6)
    with pytest.raises(InvalidArgumentError, match="empty feed iterator"):
        exe2.run_steps(main2, feed=iter(()), fetch_list=[loss2])


def test_constant_feeds_not_stacked():
    n = 3
    X, Y = _batches(n)
    main, startup, loss, _ = _mlp(lambda f: f.optimizer.SGD(0.1))
    exe = _exe()
    exe.run(startup)
    out, = exe.run_steps(main, feed={"x": X, "y": Y[0]},
                         fetch_list=[loss], constant_feeds=("y",))
    assert out.shape == (n,)
    # all feeds constant: iterations is required
    with pytest.raises(InvalidArgumentError, match="iterations=N"):
        exe.run_steps(main, feed={"x": X[0], "y": Y[0]}, fetch_list=[loss],
                      constant_feeds=("x", "y"))


def test_strategy_default_chain_length():
    n = 4
    X, Y = _batches(n)
    strat = ExecutionStrategy()
    strat.num_iteration_per_run = n
    main, startup, loss, _ = _mlp(lambda f: f.optimizer.SGD(0.1))
    exe = _exe(strategy=strat)
    exe.run(startup)
    out, = exe.run_steps(main, feed={"x": X[0], "y": Y[0]},
                         fetch_list=[loss], constant_feeds=("x", "y"))
    assert out.shape == (n,)


def test_requires_optimizer_and_ops():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 4])
        tfluid.layers.fc(x, 2)
    with pytest.raises(InvalidArgumentError, match="minimize"):
        _exe().run_steps(main, feed={"x": np.zeros((3, 8, 4), np.float32)})
    empty = tfluid.Program()
    empty._optimizer = tpt.optimizer.SGD(0.1)
    with pytest.raises(InvalidArgumentError, match="empty program"):
        _exe().run_steps(empty, feed={})


def test_minimize_again_builds_a_new_runner():
    X, Y = _batches(4)
    main, startup, loss, _ = _mlp(lambda f: f.optimizer.SGD(0.1))
    exe = _exe()
    exe.run(startup)
    exe.run_steps(main, feed={"x": X, "y": Y}, fetch_list=[loss])
    adam = tfluid.optimizer.AdamOptimizer(learning_rate=0.01)
    adam.minimize(loss)  # a runner of the SGD binding would be stale
    assert main._opt_state is None
    exe.run_steps(main, feed={"x": X, "y": Y}, fetch_list=[loss])
    assert exe.cache_stats()["misses"] == 2
    assert main._optimizer is adam and main._opt_state is not None


def test_mismatched_leading_dim_rejected():
    X, Y = _batches(4)
    main, startup, loss, _ = _mlp(lambda f: f.optimizer.SGD(0.1))
    exe = _exe()
    exe.run(startup)
    with pytest.raises(InvalidArgumentError, match="leading dim"):
        exe.run_steps(main, feed={"x": X, "y": Y[:2]}, fetch_list=[loss])


def test_lru_eviction_at_cap():
    main, startup, loss, _ = _mlp(lambda f: f.optimizer.SGD(0.1))
    exe = _exe(cache_capacity=2)
    exe.run(startup)
    rng = np.random.RandomState(0)

    def run(bs):
        exe.run(main, feed={"x": rng.rand(bs, 13).astype(np.float32),
                            "y": rng.rand(bs, 1).astype(np.float32)},
                fetch_list=[loss])

    for bs in (4, 8, 16):  # 3 geometries through a capacity-2 cache
        run(bs)
    s = exe.cache_stats()
    assert s == {**s, "misses": 3, "evictions": 1, "size": 2}
    run(4)  # evicted (LRU): a miss again
    assert exe.cache_stats()["misses"] == 4
    run(4)  # now resident: a hit
    assert exe.cache_stats()["hits"] == 1
    exe.close()
    assert exe.cache_stats()["size"] == 0


# -- on the card: a chain after the first is one CUDA graph replay ------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run_steps as a CUDA graph replay "
                    "against eager run steps")
    return torch.device("cuda", 0)


def _card_mlp(dropout=0.0):
    tpt.seed(0)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 13])
        y = tfluid.data("y", [-1, 1])
        h = tfluid.layers.fc(x, 64, act="relu")
        h = tfluid.layers.dropout(h, dropout,
                                  dropout_implementation="upscale_in_train")
        pred = tfluid.layers.fc(h, 1)
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
        tpt.optimizer.AdamW(1e-2, multi_precision=True).minimize(loss)
    return main, startup, loss


@pytest.mark.gpu
def test_replayed_chain_equals_eager_runs_on_the_card():
    _card()
    n = 4
    X, Y = _batches(3 * n)
    main, startup, loss = _card_mlp()
    ref, rstart, rloss = _card_mlp()
    exe = tfluid.Executor(tfluid.CUDAPlace(0))
    rexe = tfluid.Executor(tfluid.CUDAPlace(0))
    exe.run(startup)
    rexe.run(rstart)
    got = []
    for e in range(3):  # eager, capture + replay, replay
        out, = exe.run_steps(main, feed={"x": X[e * n:(e + 1) * n],
                                         "y": Y[e * n:(e + 1) * n]},
                             fetch_list=[loss])
        got += list(out)
    want = [rexe.run(ref, feed={"x": X[t], "y": Y[t]},
                     fetch_list=[rloss])[0] for t in range(3 * n)]
    assert np.array_equal(np.ravel(got), np.ravel(want))
    for n_, t in main.scope.items():
        assert torch.equal(t, ref.scope[n_.replace(
            f"_{main.idx}_", f"_{ref.idx}_", 1)]), n_


@pytest.mark.gpu
def test_minimize_again_after_a_replay_on_the_card():
    _card()
    n = 4
    X, Y = _batches(4 * n)
    progs = [_card_mlp(), _card_mlp()]
    exes = [tfluid.Executor(tfluid.CUDAPlace(0)) for _ in progs]
    for exe, (_, startup, _) in zip(exes, progs):
        exe.run(startup)
    (main, _, loss), (ref, _, rloss) = progs
    got, want = [], []
    for e in range(4):  # eager, capture + replay; then again, rebound
        if e == 2:
            for _, _, lo in progs:
                tpt.optimizer.Adam(5e-3).minimize(lo)
        feed = {"x": X[e * n:(e + 1) * n], "y": Y[e * n:(e + 1) * n]}
        got += list(exes[0].run_steps(main, feed=feed,
                                      fetch_list=[loss])[0])
        want += [exes[1].run(ref, feed={"x": X[t], "y": Y[t]},
                             fetch_list=[rloss])[0]
                 for t in range(e * n, (e + 1) * n)]
    assert np.array_equal(np.ravel(got), np.ravel(want))
    for n_, t in main.scope.items():
        assert torch.equal(t, ref.scope[n_.replace(
            f"_{main.idx}_", f"_{ref.idx}_", 1)]), n_


@pytest.mark.gpu
def test_replays_advance_the_launch_counters_on_the_card():
    from paddle_tpu_torch.ops.fused_softmax_xent import softmax_cross_entropy
    _card()
    tpt.seed(0)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 6])
        y = tfluid.data("y", [-1], "int64")
        logits = tfluid.layers.fc(x, 32)
        loss = tpt.static.graph.record_call(
            lambda lg, lab: softmax_cross_entropy(lg, lab).mean(),
            logits, y)
        tpt.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CUDAPlace(0))
    exe.run(startup)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4, 16, 6).astype(np.float32),
            "y": rng.randint(0, 32, (4, 16)).astype(np.int64)}
    per_call = []
    for _ in range(3):
        softmax_cross_entropy.launches = 0
        exe.run_steps(main, feed=feed, fetch_list=[loss])
        per_call.append(softmax_cross_entropy.launches)
    assert per_call == [4, 4, 4], per_call
