"""The sequence-tagging slice as a whole against the JAX package: the 1.x
RNN and loss builders in Programs, a LAC-shaped BiGRU-CRF Program,
``fluid.io``'s reference-format persistables (written by either package,
read by the other), ``fluid.metrics`` and ``fluid.dygraph``.

Each Program is built by ONE function from the package it is given, so
both record the same builders in the same order; the JAX scope and
buffers go into the port's by name (``bridge.load_jax_program``) and both
run the same seeded numpy feeds in float32.  Tolerances: builder outputs,
losses and the trained parameters and buffers rtol / atol 1e-5; the LAC
Program's losses over three Adam steps rtol 1e-4, its decoded paths and
``chunk_eval`` counts equal.  ``nce`` is built over one class, so its
negatives are fixed (the port cannot reproduce ``jax.random``'s draws).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as tpt
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu import nn as jnn
from paddle_tpu.static.builders import layer_op as jlayer_op
from paddle_tpu.static.graph import reset_default_programs as jreset
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.bridge import load_jax_program
from paddle_tpu_torch.static.builders import layer_op as tlayer_op
from paddle_tpu_torch.static.graph import reset_default_programs as treset
from torch_op_pairs import np_, on_the_cpu  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = {"jax": (jfluid, jnn, jlayer_op), "port": (tfluid, tnn, tlayer_op)}


@pytest.fixture(autouse=True)
def _fresh():
    jpt.seed(0)
    tpt.seed(0)
    jreset()
    treset()
    yield
    jreset()
    treset()


def _exe(fluid):
    return (fluid.Executor(fluid.CPUPlace()) if fluid is tfluid
            else fluid.Executor())


def _key(name):
    return name.split("_", 2)[2]


def _by_key(d):
    return {_key(k): np_(v).astype(np.float32) if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float32) for k, v in d.items()}


def _pair(build, feeds, steps=2):
    """``build(fluid) -> (main, startup, fetches, loss)`` in both packages
    from one scope: ``steps`` training runs with every fetch and the loss
    compared, then the scope and buffers."""
    out = {}
    for name, (fluid, _, _) in PKGS.items():
        main, start, fetch, loss = build(fluid)
        exe = _exe(fluid)
        exe.run(start)
        out[name] = (main, exe, list(fetch) + [loss])
    (jmain, jexe, jf), (tmain, texe, tf) = out["jax"], out["port"]
    load_jax_program(tmain, {k: np.asarray(v) for k, v in jmain.scope.items()},
                     {k: np.asarray(v) for k, v in jmain.buffers.items()})
    for _ in range(steps):
        jv = jexe.run(jmain, feed=feeds, fetch_list=jf)
        tv = texe.run(tmain, feed=feeds, fetch_list=tf)
        for i, (a, b) in enumerate(zip(tv, jv)):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=str(i),
                                       **TOL)
    for mine, theirs in ((tmain.scope, jmain.scope),
                         (tmain.buffers, jmain.buffers)):
        t, j = _by_key(mine), _by_key(theirs)
        assert sorted(t) == sorted(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)
    return tmain


def _rnd(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rnn(fluid):
    """dynamic_gru (both origin modes, reverse, h_0, a relu candidate),
    gru_unit, dynamic_lstm (peepholes on and off, hard_sigmoid gates, h_0 /
    c_0), dynamic_lstmp (clips), lstm_unit and the bidirectional lstm
    builder in one Program."""
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x6 = fluid.data("x6", [-1, 5, 6])
        x8 = fluid.data("x8", [-1, 5, 8])
        xt = fluid.data("xt", [-1, 3])
        h = fluid.data("h", [-1, 2])
        c = fluid.data("c", [-1, 2])
        x3 = fluid.data("x3", [-1, 4, 3])
        h0 = fluid.data("h0", [2, -1, 5])
        c0 = fluid.data("c0", [2, -1, 5])
        outs = [fluid.layers.dynamic_gru(x6, 2, candidate_activation="relu"),
                fluid.layers.dynamic_gru(x6, 2, is_reverse=True,
                                         origin_mode=True, h_0=h)]
        outs += list(fluid.layers.gru_unit(x6[:, 1], h, 6))
        outs += list(fluid.layers.gru_unit(x6[:, 2], h, 6, origin_mode=True))
        outs += list(fluid.layers.dynamic_lstm(x8, 8))
        outs += list(fluid.layers.dynamic_lstm(
            x8, 8, use_peepholes=False, is_reverse=True,
            gate_activation="hard_sigmoid", h_0=h, c_0=c))
        outs += list(fluid.layers.dynamic_lstmp(x8, 8, proj_size=3,
                                                cell_clip=0.5,
                                                proj_clip=0.8))
        outs += list(fluid.layers.lstm_unit(xt, h, c, forget_bias=1.0))
        outs += list(fluid.layers.lstm(x3, h0, c0, 4, 5, 1, is_bidirec=True))
        loss = fluid.layers.sums([fluid.layers.mean(o) for o in outs])
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, start, outs, loss


def _losses(fluid):
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x = fluid.data("x", [-1, 6])
        lbl = fluid.data("lbl", [-1, 1], dtype="int64")
        zero = fluid.data("zero", [-1, 1], dtype="int64")
        seq = fluid.data("seq", [-1, 5, 3])
        img = fluid.data("img", [-1, 3, 4, 4])
        outs = [fluid.layers.nce(x, zero, num_total_classes=1,
                                 num_neg_samples=3),
                fluid.layers.center_loss(x, lbl, num_classes=5, alpha=0.1),
                fluid.layers.data_norm(x, enable_scale_and_shift=True),
                fluid.layers.sequence_conv(seq, num_filters=4,
                                           filter_size=3, act="tanh"),
                fluid.layers.sequence_conv(seq, num_filters=2,
                                           filter_size=2, padding_start=0),
                fluid.layers.inplace_abn(img, act="relu")]
        loss = fluid.layers.sums([fluid.layers.mean(o) for o in outs])
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, start, outs, loss


BUILDERS = {
    "rnn": (_rnn, {"x6": _rnd(0, 3, 5, 6), "x8": _rnd(1, 3, 5, 8),
                   "xt": _rnd(2, 3, 3), "h": _rnd(3, 3, 2),
                   "c": _rnd(4, 3, 2), "x3": _rnd(5, 3, 4, 3),
                   "h0": _rnd(6, 2, 3, 5) * 0.1,
                   "c0": _rnd(7, 2, 3, 5) * 0.1}),
    "losses": (_losses, {
        "x": _rnd(0, 4, 6), "seq": _rnd(1, 4, 5, 3),
        "img": _rnd(2, 2, 3, 4, 4),
        "lbl": np.array([[1], [4], [1], [0]], np.int64),
        "zero": np.zeros((4, 1), np.int64)}),
}


@pytest.mark.parametrize("group", sorted(BUILDERS))
def test_builders_match_jax(group):
    build, feeds = BUILDERS[group]
    main = _pair(build, feeds)
    if group == "losses":  # the buffer updates of training runs
        names = " ".join(main.buffers)
        assert "center_loss" in names and "data_norm" in names


def test_builders_are_in_static_nn_and_raise_eagerly():
    import paddle_tpu_torch.static.nn as tsnn
    from paddle_tpu_torch.framework.errors import InvalidArgumentError

    x, h = torch.zeros(2, 3, 12), torch.zeros(2, 3)
    args = {"nce": (x, h, 5), "center_loss": (x, h, 5, 0.1),
            "sequence_conv": (x, 4), "inplace_abn": (x,),
            "lstm": (x, h, h, 3, 4, 1), "data_norm": (x,),
            "gru_unit": (x, h, 12), "lstm_unit": (x, h, h),
            "dynamic_lstm": (x, 12), "dynamic_lstmp": (x, 12, 2),
            "dynamic_gru": (x, 4)}
    for name, a in args.items():
        fn = getattr(tsnn, name)
        assert fn is getattr(tfluid.layers, name)
        with pytest.raises(InvalidArgumentError, match="graph mode"):
            fn(*a)


# -- the LAC-shaped Program ----------------------------------------------------
V, E, H, TAGS, B, T = 50, 16, 8, 9, 4, 10
LEN = np.array([10, 1, 6, 3], np.int64)


def lac(fluid, nn, layer_op):
    """LAC's nets.py at a small width: embedding, two stacked BiGRU layers
    (fc(3H) → dynamic_gru each way, concatenated), fc(tags) emissions, the
    CRF loss on a trained transition and Viterbi decoding."""
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        word = fluid.data("word", [-1, T], dtype="int64")
        target = fluid.data("target", [-1, T], dtype="int64")
        length = fluid.data("length", [-1], dtype="int64")
        h = fluid.layers.embedding(word, size=[V, E])
        for _ in range(2):
            fw = fluid.layers.dynamic_gru(
                fluid.layers.fc(h, 3 * H, num_flatten_dims=2), H)
            bw = fluid.layers.dynamic_gru(
                fluid.layers.fc(h, 3 * H, num_flatten_dims=2), H,
                is_reverse=True)
            h = fluid.layers.concat([fw, bw], axis=2)
        emission = fluid.layers.fc(h, TAGS, num_flatten_dims=2)

        class Crf(nn.Layer):
            def __init__(self):
                super().__init__()
                self.transition = self.create_parameter([TAGS + 2, TAGS])

            def forward(self, x):
                return self.transition * 1.0

        transition = layer_op(Crf(), emission, prefix="crfw")
        cost = fluid.layers.linear_chain_crf(emission, transition, target,
                                             length)
        loss = fluid.layers.mean(cost)
        decode = fluid.layers.crf_decoding(emission, transition,
                                           length=length)
        fluid.optimizer.AdamOptimizer(1e-2).minimize(loss)
    return main, start, loss, decode


def lac_batch(seed=0):
    """Tags from a Markov chain over the tags; each word names its tag's
    chunk type, with B- and I- of a type aliased (the transitions decide
    them)."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.full(TAGS, 0.3), TAGS)
    tags = np.zeros((B, T), np.int64)
    for b in range(B):
        t = rng.randint(TAGS)
        for s in range(T):
            tags[b, s] = t
            t = rng.choice(TAGS, p=trans[t])
    words = (tags // 2) * 10 + rng.randint(0, 10, (B, T))
    pad = np.arange(T)[None] >= LEN[:, None]
    return {"word": np.where(pad, 0, words).astype(np.int64),
            "target": np.where(pad, 0, tags).astype(np.int64),
            "length": LEN}


def test_lac_program_matches_jax():
    """Three Adam steps of the BiGRU-CRF: losses rtol 1e-4, the decoded
    paths and chunk_eval's counts (IOB, 4 chunk types) equal."""
    from paddle_tpu.metric import chunk_eval as jchunk
    from paddle_tpu_torch.metric import chunk_eval as tchunk

    feed = lac_batch()
    runs = {}
    for name, pkg in PKGS.items():
        main, start, loss, decode = lac(*pkg)
        exe = _exe(pkg[0])
        exe.run(start)
        runs[name] = (main, exe, [loss, decode])
    (jmain, jexe, jf), (tmain, texe, tf) = runs["jax"], runs["port"]
    load_jax_program(tmain, {k: np.asarray(v) for k, v in jmain.scope.items()})
    losses = []
    for _ in range(3):
        jl, jd = jexe.run(jmain, feed=feed, fetch_list=jf)
        tl, td = texe.run(tmain, feed=feed, fetch_list=tf)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4)
        np.testing.assert_array_equal(td, np.asarray(jd))
        j = [int(np.asarray(v)) for v in jchunk(
            np.asarray(jd), feed["target"], "IOB", 4, seq_length=LEN)[3:]]
        t = [int(np_(v)) for v in tchunk(
            torch.from_numpy(td), torch.from_numpy(feed["target"]), "IOB", 4,
            seq_length=torch.from_numpy(LEN))[3:]]
        assert j == t
        losses.append(float(tl))
    assert losses[-1] < losses[0]
    assert (td[1, 1:] == 0).all() and (td[3, 3:] == 0).all()


def test_create_parameter_in_a_program_is_trained():
    """``fluid.layers.create_parameter`` under program_guard registers a
    trainable scope parameter (1.x semantics) that the optimizer moves."""
    main, start = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, start):
        x = tfluid.data("x", [-1, 3])
        w = tfluid.layers.create_parameter([3, 2], "float32", name="w")
        loss = tfluid.layers.mean(tfluid.layers.matmul(x, w))
        tfluid.optimizer.SGD(0.5).minimize(loss)
    assert w.name in main.scope and type(main.scope[w.name]) is tnn.Parameter
    exe = _exe(tfluid)
    exe.run(start)
    before = main.scope[w.name].detach().clone()
    exe.run(main, feed={"x": np.ones((4, 3), np.float32)},
            fetch_list=[loss])
    torch.testing.assert_close(before - main.scope[w.name].detach(),
                               torch.full((3, 2), 0.25))


# -- fluid.io --------------------------------------------------------------------
def _io_program(fluid, nn, layer_op):
    """Parameters (an embedding, an fc, a BatchNorm's scale and shift) and
    buffers (its statistics)."""
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        word = fluid.data("word", [-1, 4], dtype="int64")
        h = fluid.layers.fc(fluid.layers.embedding(word, size=[20, 6]), 8,
                            num_flatten_dims=2)
        fluid.layers.batch_norm(fluid.layers.reshape(h, [-1, 8, 4, 1]))
    return main, start


@pytest.mark.parametrize("filename", [None, "params"])
def test_persistables_written_by_either_package_load_in_the_other(
        tmp_path, filename):
    progs = {}
    for name, pkg in PKGS.items():
        main, start = _io_program(*pkg)
        _exe(pkg[0]).run(start)
        progs[name] = main
    jmain, tmain = progs["jax"], progs["port"]
    # the port's state goes out, into the JAX program
    for d in (tmain.scope, tmain.buffers):
        for v in d.values():
            with torch.no_grad():
                v.add_(0.125)
    tfluid.io.save_persistables(None, str(tmp_path / "t"), tmain, filename)
    jfluid.io.load_persistables(None, str(tmp_path / "t"), jmain, filename)
    for mine, theirs in ((tmain.scope, jmain.scope),
                         (tmain.buffers, jmain.buffers)):
        t, j = _by_key(mine), _by_key(theirs)
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_array_equal(j[k], t[k], err_msg=k)
    # and the JAX state back into a fresh port program (names adapted)
    jfluid.io.save_persistables(None, str(tmp_path / "j"), jmain, filename)
    treset()
    fresh = _io_program(*PKGS["port"])[0]
    tfluid.io.load_persistables(None, str(tmp_path / "j"), fresh, filename)
    for mine, want in ((fresh.scope, tmain.scope),
                       (fresh.buffers, tmain.buffers)):
        f, t = _by_key(mine), _by_key(want)
        for k in t:
            np.testing.assert_array_equal(f[k], t[k], err_msg=k)
    # save_params writes the parameters only
    tfluid.io.save_params(None, str(tmp_path / "p"), tmain, filename)
    got = sorted(os.listdir(tmp_path / "p"))
    assert "__model__" in got and len(got) == (
        2 if filename else len(tmain.scope) + 1)


def test_persistables_keep_bfloat16_and_subsets(tmp_path):
    state = {"w": torch.randn(3, 4).to(torch.bfloat16),
             "b": torch.arange(5, dtype=torch.int64)}
    tfluid.io.save_vars(None, str(tmp_path), state)
    lay = tnn.Layer()
    lay.w = tnn.Parameter(torch.zeros(3, 4, dtype=torch.bfloat16))
    tfluid.io.load_vars(None, str(tmp_path), lay, vars=["w"])
    assert torch.equal(lay.w.detach(), state["w"])
    assert sorted(os.listdir(tmp_path)) == ["__model__", "b", "w"]


# -- fluid.metrics ---------------------------------------------------------------
def _metric_updates(m, pkg):
    rng = np.random.RandomState(0)
    name = type(m).__name__
    if name == "Accuracy":
        for v, w in ((0.8, 10), (0.5, 30), (1.0, 2)):
            m.update(v, w)
    elif name in ("Precision", "Recall", "CompositeMetric"):
        for _ in range(3):
            m.update(rng.rand(20) > 0.5, rng.randint(0, 2, 20))
    elif name == "ChunkEvaluator":
        for counts in ((7, 9, 5), (3, 2, 2), (0, 4, 0)):
            m.update(*[np.asarray(c) for c in counts])
    elif name == "EditDistance":
        m.update(np.array([0.0, 2.0, 1.0, 0.0]), 4)
        m.update(np.array([3.0]), 1)
    elif name == "Auc":
        for _ in range(2):
            p = rng.rand(32)
            m.update(np.stack([1 - p, p], 1), (rng.rand(32) < p)
                     .astype(np.int64)[:, None])
    elif name == "DetectionMAP":
        det = [np.array([[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                         [1, 0.6, 0.5, 0.5, 0.9, 0.9],
                         [2, 0.8, 0.2, 0.2, 0.6, 0.6],
                         [-1, 0.0, 0, 0, 0, 0]], np.float32)]
        m.update(det, [np.array([1, 2])],
                 [np.array([[0.1, 0.1, 0.4, 0.4], [0.2, 0.2, 0.6, 0.5]])])


METRICS = ["Accuracy", "Precision", "Recall", "ChunkEvaluator",
           "EditDistance", "Auc", "CompositeMetric", "DetectionMAP"]


@pytest.mark.parametrize("name", METRICS)
def test_fluid_metrics_match_jax(name):
    vals = []
    for fluid in (jfluid, tfluid):
        m = getattr(fluid.metrics, name)()
        if name == "CompositeMetric":
            m.add_metric(fluid.metrics.Precision())
            m.add_metric(fluid.metrics.Recall())
        _metric_updates(m, fluid)
        vals.append(np.asarray(m.eval(), np.float64))
        m.reset()
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-12)


# -- fluid.dygraph ---------------------------------------------------------------
def _bridge_layer(jl, tl):
    j = {n: np.asarray(p.value) for n, p in jl.named_parameters()}
    with torch.no_grad():
        for n, p in tl.named_parameters():
            p.copy_(torch.from_numpy(j[n]))


DYGRAPH = {
    "Linear": (lambda d: d.Linear(4, 3, act="tanh"), [(5, 4)]),
    "Conv2D": (lambda d: d.Conv2D(3, 4, 3, padding=1, act="relu"),
               [(2, 3, 5, 5)]),
    "BatchNorm": (lambda d: d.BatchNorm(3, act="relu"), [(4, 3, 2, 2)]),
    "BatchNorm_test": (lambda d: d.BatchNorm(3, is_test=True),
                       [(4, 3, 2, 2)]),
    "LayerNorm": (lambda d: d.LayerNorm([3, 4], act="sigmoid"), [(2, 3, 4)]),
    "PRelu_all": (lambda d: d.PRelu("all"), [(2, 3, 4)]),
    "PRelu_channel": (lambda d: d.PRelu("channel", channel=3),
                      [(2, 3, 4, 4)]),
    "PRelu_element": (lambda d: d.PRelu("element", input_shape=[2, 3, 4]),
                      [(2, 3, 4)]),
    "GRUUnit": (lambda d: d.GRUUnit(6), [(3, 6), (3, 2)]),
    "GRUUnit_origin": (lambda d: d.GRUUnit(6, origin_mode=True,
                                           activation="relu"),
                       [(3, 6), (3, 2)]),
    "Dropout_infer": (lambda d: d.Dropout(0.3, is_test=True), [(3, 4)]),
    "NCE_one_class": (lambda d: d.NCE(1, 4, num_neg_samples=3), [(5, 4)]),
}


@pytest.mark.parametrize("name", sorted(DYGRAPH))
def test_dygraph_layer_matches_jax(name):
    import jax
    import jax.numpy as jnp

    make, shapes = DYGRAPH[name]
    jl, tl = make(jfluid.dygraph), make(tfluid.dygraph)
    _bridge_layer(jl, tl)
    arrays = [_rnd(i, *s) for i, s in enumerate(shapes)]
    if name.startswith("NCE"):
        arrays.append(np.zeros((5, 1), np.int64))
    want = jax.jit(lambda *xs: jl(*xs))(*[jnp.asarray(a) for a in arrays])
    got = tl(*[torch.from_numpy(a) for a in arrays])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), **TOL)


def test_dygraph_embedding_guard_and_checkpoints(tmp_path):
    import jax.numpy as jnp

    jl, tl = (jfluid.dygraph.Embedding([7, 3], padding_idx=0),
              tfluid.dygraph.Embedding([7, 3], padding_idx=0))
    _bridge_layer(jl, tl)
    ids = np.array([[0, 3, 6]], np.int64)
    np.testing.assert_allclose(np_(tl(torch.from_numpy(ids))),
                               np.asarray(jl(jnp.asarray(ids))), **TOL)
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        assert tfluid.dygraph.enabled()
    assert tfluid.dygraph_guard is tfluid.dygraph.guard
    # save_dygraph picks .pdparams / .pdopt; either package reads the other
    tfluid.dygraph.save_dygraph(tl.state_dict(), str(tmp_path / "t"))
    tfluid.dygraph.save_dygraph({"count": np.int64(3)}, str(tmp_path / "t"))
    params, opt = jfluid.dygraph.load_dygraph(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(params["weight"]),
                                  np_(tl.weight))
    assert int(np.asarray(opt["count"])) == 3
    jfluid.dygraph.save_dygraph(
        {k: p.value for k, p in jl.named_parameters()}, str(tmp_path / "j"))
    params, opt = tfluid.dygraph.load_dygraph(str(tmp_path / "j"))
    assert opt is None
    np.testing.assert_array_equal(np.asarray(params["weight"]),
                                  np.asarray(jl.weight.value))
