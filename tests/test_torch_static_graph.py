"""The port's 1.x static graph (``paddle_tpu_torch.static`` /
``paddle_tpu_torch.fluid``) held against the JAX package's.

Each program is built by ONE function from the ``fluid`` module it is
given, so both packages record the same builders in the same order; the
JAX program's scope and buffers go into the port's through
``bridge.load_jax_program`` (names match with their ``_{idx}_`` prefix
stripped), and both run on the same seeded numpy feeds in float32
(``tests/conftest.py`` sets ``jax_default_matmul_precision="highest"``).

Tolerances: fit_a_line (SGD) losses and parameters rtol 1e-5 / atol
1e-6 over 5 ``run`` steps; the recognize_digits convnet (Adam) losses
rtol 1e-5, the moving variance rtol 1e-5 / atol 1e-6, parameters atol
1e-4, the conv bias and the moving mean rtol 1e-5 / atol 1e-6 but in a
channel whose JAX bias gradient is rounding noise at every step (the
BatchNorm after it subtracts the channel mean), which Adam's normalized
step turns into up to ``lr`` of movement a step (see
``test_torch_training.py``): there the bias is held within 2·steps·lr
and the moving mean within (1 - momentum^steps) of that;
``layer_op`` over a 2-layer BERT with AdamW: losses rtol 1e-5 over 3
steps.

Also here: the repair of this slice (``nn.Linear`` / ``nn.Embedding`` /
``nn.LayerNorm`` built on their own are initialized, as the JAX layers
are), the build-time shape probe on the meta device, the test clone's
frozen buffers, placement, and ``static.save`` / ``load`` in the JAX
format.  On the card (``gpu``-marked): one program run on the card and
on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as tpt
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.static.graph import reset_default_programs as jreset
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.bridge import load_jax_program
from paddle_tpu_torch.framework import device as tdevice
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.static.graph import reset_default_programs as treset


@pytest.fixture(autouse=True)
def _fresh():
    saved = tdevice._chosen
    tdevice.set_device("cpu")
    jpt.seed(0)
    tpt.seed(0)
    jreset()
    treset()
    yield
    jreset()
    treset()
    tdevice._chosen = saved


def _exe(fluid):
    return (fluid.Executor(fluid.CPUPlace()) if fluid is tfluid
            else fluid.Executor())


def _bridge(jmain, tmain):
    load_jax_program(tmain,
                     {k: np.asarray(v) for k, v in jmain.scope.items()},
                     {k: np.asarray(v) for k, v in jmain.buffers.items()})


def _key(name):
    return name.split("_", 2)[2]


def _by_key(d):
    return {_key(k): (v.detach().float().numpy().copy()
                      if isinstance(v, torch.Tensor)
                      else np.asarray(v, np.float32)) for k, v in d.items()}


def fit_a_line(fluid, lr=0.1):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 13])
        y = fluid.data("y", [-1, 1])
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss, pred


def _line_data():
    rng = np.random.RandomState(0)
    X = rng.rand(64, 13).astype(np.float32)
    Y = (X @ rng.randn(13))[:, None].astype(np.float32)
    return X, Y


def convnet(fluid, make_opt=lambda f: f.optimizer.AdamOptimizer(
        learning_rate=0.01)):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("img", [-1, 1, 12, 12])
        label = fluid.data("label", [-1, 1], dtype="int64")
        c = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                act="relu")
        p = fluid.layers.pool2d(c, pool_size=2, pool_stride=2)
        b = fluid.layers.batch_norm(p)
        pred = fluid.layers.fc(b, size=10, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        make_opt(fluid).minimize(loss)
    return main, startup, loss, pred


def _digits():
    rng = np.random.RandomState(0)
    protos = rng.rand(10, 1, 12, 12).astype(np.float32)
    yb = rng.randint(0, 10, 64)
    Xb = protos[yb] + 0.05 * rng.randn(64, 1, 12, 12).astype(np.float32)
    return {"img": Xb, "label": yb[:, None].astype(np.int64)}


# -- the repair: layers built on their own are initialized -------------------
def test_standalone_layers_are_initialized_as_in_jax():
    """JAX layers draw their parameters at construction; the port's
    Linear / Embedding / LayerNorm left theirs uninitialized until a model
    constructor filled them, so ``nn.Sequential(nn.Linear(...))`` (bench.py
    config 1) trained from garbage.  Now each is filled at construction
    by the JAX defaults: Xavier-normal weights and zero biases, N(0, 1)
    embeddings, unit / zero LayerNorm, seeded by ``seed``."""
    tpt.seed(3)
    lin = tpt.nn.Linear(400, 300)
    w = lin.weight.detach().numpy()
    assert np.isfinite(w).all()
    assert abs(w.std() - np.sqrt(2.0 / 700)) < 0.05 * np.sqrt(2.0 / 700)
    assert abs(w.mean()) < 1e-3
    assert (lin.bias.detach().numpy() == 0).all()
    emb = tpt.nn.Embedding(1000, 64)
    e = emb.weight.detach().numpy()
    assert abs(e.std() - 1.0) < 0.02 and abs(e.mean()) < 0.02
    ln = tpt.nn.LayerNorm(16)
    assert (ln.weight.detach().numpy() == 1).all()
    assert (ln.bias.detach().numpy() == 0).all()
    tpt.seed(3)
    assert torch.equal(tpt.nn.Linear(400, 300).weight, lin.weight)


def test_model_constructors_draw_each_weight_once():
    """A model constructor fills its layers itself, from its generator:
    the layers built inside it skip their construction-time fill, so a
    model built after ``seed(s)`` equals one built from a generator
    seeded with ``s`` and the CPU generator is left where that fill
    leaves it."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, intermediate_size=64,
                     max_position=16)
    tpt.seed(5)
    a = BertForPretraining(cfg, device="cpu")
    after = tpt.framework.random.default_generator().get_state()
    gen = torch.Generator().manual_seed(5)
    b = BertForPretraining(cfg, device="cpu", generator=gen)
    assert torch.equal(after, gen.get_state())
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


# -- fit_a_line ---------------------------------------------------------------
def test_fit_a_line_matches_jax():
    jmain, jstart, jloss, _ = fit_a_line(jfluid)
    tmain, tstart, tloss, _ = fit_a_line(tfluid)
    assert [_key(n) for n in tmain.scope] == [_key(n) for n in jmain.scope]
    jexe, texe = _exe(jfluid), _exe(tfluid)
    jexe.run(jstart)
    texe.run(tstart)
    _bridge(jmain, tmain)
    X, Y = _line_data()
    for _ in range(5):
        jl, = jexe.run(jmain, feed={"x": X, "y": Y}, fetch_list=[jloss])
        tl, = texe.run(tmain, feed={"x": X, "y": Y}, fetch_list=[tloss])
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    jp, tp = _by_key(jmain.scope), _by_key(tmain.scope)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-6)


def test_fit_a_line_trains_to_low_loss():
    main, startup, loss, _ = fit_a_line(tfluid)
    exe = _exe(tfluid)
    exe.run(startup)
    X, Y = _line_data()
    losses = [float(exe.run(main, feed={"x": X, "y": Y},
                            fetch_list=[loss])[0]) for _ in range(100)]
    assert losses[-1] < losses[0] * 0.02, (losses[0], losses[-1])


def test_startup_rerun_reinitializes_in_place():
    main, startup, loss, _ = fit_a_line(tfluid, lr=0.5)
    exe = _exe(tfluid)
    exe.run(startup)
    w0 = dict(main.parameters_numpy())
    ptrs = {n: t.data_ptr() for n, t in main.scope.items()}
    X, Y = _line_data()
    exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
    slots0 = {n: s["moment1"].data_ptr() if "moment1" in s else None
              for n, s in main._opt_state["slots"].items()}
    assert any(not np.array_equal(v, main.parameters_numpy()[k])
               for k, v in w0.items())
    exe.run(startup)  # back to init, storage kept
    for k, v in w0.items():
        np.testing.assert_array_equal(v, main.parameters_numpy()[k])
    assert {n: t.data_ptr() for n, t in main.scope.items()} == ptrs
    assert main._opt_state["count"] == 0
    assert {n: s["moment1"].data_ptr() if "moment1" in s else None
            for n, s in main._opt_state["slots"].items()} == slots0


def test_init_values_are_host_copies_that_survive_training():
    main, startup, loss, _ = fit_a_line(tfluid, lr=0.5)
    assert main._init_values
    for n, v in main._init_values.items():
        assert v.device.type == "cpu"
        assert v.data_ptr() != main.scope[n].data_ptr()
    exe = _exe(tfluid)
    exe.run(startup)
    X, Y = _line_data()
    exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
    exe.run(startup)
    out, = exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
    assert np.isfinite(out).all()


def test_clone_snapshots_ops_and_gets_fresh_cache_key():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 4])
        out = tfluid.layers.fc(x, 3)
    test_prog = main.clone(for_test=True)
    n_ops = len(test_prog.ops)
    assert test_prog.idx != main.idx
    with tfluid.program_guard(main, startup):
        tfluid.layers.mean(out)
    assert len(test_prog.ops) == n_ops
    assert len(main.ops) == n_ops + 1
    with pytest.raises(InvalidArgumentError, match="for_test=False"):
        main.clone()


def test_fetch_by_name_and_scope_read():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 4])
        out = tfluid.layers.fc(x, 3)
    exe = _exe(tfluid)
    X = np.ones((2, 4), np.float32)
    r1, = exe.run(main, feed={"x": X}, fetch_list=[out])
    r2, = exe.run(main, feed={"x": X}, fetch_list=[out.name])
    np.testing.assert_array_equal(r1, r2)
    pname = main.all_parameters()[0].name
    with tfluid.program_guard(main, startup):
        t = tfluid.global_scope().find_var(pname)
    assert t is not None and t.get_tensor().shape == (4, 3)


def test_build_time_shapes_match_jax_and_touch_no_device():
    """The meta-device probe gives every recorded Variable the shape the
    JAX probe (``jax.eval_shape`` at batch 1) gives it."""
    jmain = convnet(jfluid)[0]
    tmain = convnet(tfluid)[0]
    jshapes = {_key(n): tuple(v.shape) for n, v in jmain.vars.items()
               if n.startswith("_")}
    tshapes = {_key(n): tuple(v.shape) for n, v in tmain.vars.items()
               if n.startswith("_")}
    assert tshapes == jshapes
    for t in list(tmain.scope.values()) + list(tmain.buffers.values()):
        assert t.device.type == "cpu"


# -- recognize_digits ----------------------------------------------------------
def _jax_grad(twin, exe, main, feed, key):
    """The JAX gradient of ``main``'s parameter ``key`` at its current
    state: ``twin`` records the same program under SGD at rate 1, so one
    run from ``main``'s scope moves the parameter by minus the gradient."""
    for k, v in main.scope.items():
        twin.scope[f"_{twin.idx}_{_key(k)}"] = jnp.array(np.asarray(v))
    name = f"_{twin.idx}_{key}"
    before = np.asarray(twin.scope[name]).copy()
    exe.run(twin, feed=feed)
    return before - np.asarray(twin.scope[name])


def test_recognize_digits_convnet_matches_jax():
    steps, lr, momentum = 5, 0.01, 0.9  # convnet's Adam, batch_norm's
    jmain, jstart, jloss, jpred = convnet(jfluid)
    tmain, tstart, tloss, tpred = convnet(tfluid)
    twin, twin_start = convnet(
        jfluid, lambda f: f.optimizer.SGD(learning_rate=1.0))[:2]
    jexe, texe = _exe(jfluid), _exe(tfluid)
    jexe.run(jstart)
    texe.run(tstart)
    jexe.run(twin_start)
    _bridge(jmain, tmain)
    feed = _digits()
    b0 = _by_key(tmain.buffers)
    bias = next(k for k in _by_key(tmain.scope)
                if k.startswith("conv2d.bias"))
    grads = []
    for _ in range(steps):
        grads.append(_jax_grad(twin, jexe, jmain, feed, bias))
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss])
        tl, = texe.run(tmain, feed=feed, fetch_list=[tloss])
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jb, tb = _by_key(jmain.buffers), _by_key(tmain.buffers)
    assert any(not np.array_equal(b0[k], tb[k]) for k in tb)
    jp, tp = _by_key(jmain.scope), _by_key(tmain.scope)
    # A conv channel whose JAX bias gradient is rounding noise at every
    # step (relu and the max pool pass the bias through, and the
    # BatchNorm after them subtracts the channel mean) has an Adam step
    # of up to lr in either package: its bias is held within
    # 2·steps·lr, and its moving mean, a sum of batch means with weights
    # (1 - momentum)·momentum^i totalling 1 - momentum^steps, within
    # that times (1 - momentum^steps).  Every other channel is held at
    # rtol 1e-5 / atol 1e-6, every other parameter at atol 1e-4.
    g = np.abs(np.stack(grads)).max(axis=0)
    noise = g <= 1e-5 * g.max()
    assert noise.sum() < len(noise)  # some channel carries a gradient
    bias_bound = 2 * steps * lr
    mean_bound = (1 - momentum ** steps) * bias_bound
    for k in jp:
        if k == bias:
            assert np.abs(tp[k] - jp[k])[noise].max(initial=0) \
                <= bias_bound, k
            np.testing.assert_allclose(tp[k][~noise], jp[k][~noise],
                                       rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(tp[k], jp[k], atol=1e-4)
    for k in jb:
        if "_mean" in k:
            assert np.abs(tb[k] - jb[k])[noise].max(initial=0) \
                <= mean_bound, k
            np.testing.assert_allclose(tb[k][~noise], jb[k][~noise],
                                       rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(tb[k], jb[k], rtol=1e-5, atol=1e-6)
    # a test clone evaluates with the moving statistics and leaves them
    # (from JAX's trained state, so both evaluate the same values)
    _bridge(jmain, tmain)
    jclone, tclone = jmain.clone(for_test=True), tmain.clone(for_test=True)
    jo, = jexe.run(jclone, feed=feed, fetch_list=[jpred])
    before = {k: v.clone() for k, v in tmain.buffers.items()}
    to, = texe.run(tclone, feed=feed, fetch_list=[tpred])
    to2, = texe.run(tclone, feed=feed, fetch_list=[tpred])
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(to, to2)
    for k, v in tmain.buffers.items():
        assert torch.equal(v, before[k]), k


def test_recognize_digits_trains_and_bn_stats_move():
    main, startup, loss, _ = convnet(tfluid)
    exe = _exe(tfluid)
    exe.run(startup)
    bufs0 = {k: v.clone() for k, v in main.buffers.items()}
    feed = _digits()
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
              for _ in range(25)]
    assert losses[-1] < losses[0] * 0.3, (losses[0], losses[-1])
    assert any(not torch.equal(v, main.buffers[k]) for k, v in bufs0.items())


def test_static_graph_example_flow_on_the_cpu_place():
    """``examples/static_graph_1x.py``'s program, run on
    ``Executor(CPUPlace())`` for 20 steps: the loss falls."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        img = tfluid.data("img", [-1, 1, 28, 28])
        label = tfluid.data("label", [-1, 1], dtype="int64")
        conv = tfluid.layers.conv2d(img, num_filters=8, filter_size=5,
                                    act="relu")
        pool = tfluid.layers.pool2d(conv, pool_size=2, pool_stride=2)
        bn = tfluid.layers.batch_norm(pool)
        pred = tfluid.layers.fc(bn, size=10, act="softmax")
        loss = tfluid.layers.mean(tfluid.layers.cross_entropy(pred, label))
        tfluid.optimizer.AdamOptimizer(learning_rate=0.01).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    rng = np.random.RandomState(0)
    protos = rng.rand(10, 1, 28, 28).astype(np.float32)
    losses = []
    for _ in range(20):
        y = rng.randint(0, 10, 64)
        x = protos[y] + 0.1 * rng.randn(64, 1, 28, 28).astype(np.float32)
        losses.append(float(exe.run(
            main, feed={"img": x, "label": y[:, None].astype(np.int64)},
            fetch_list=[loss])[0]))
    assert losses[-1] < losses[0] * 0.5, losses


# -- layer_op over a port model ------------------------------------------------
def _bert_program(pkg, fluid, net, B, S, P):
    from_layer = pkg.static.builders.layer_op
    record = pkg.static.graph.record_call
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids_v = fluid.data("input_ids", [B, S], "int32")
        tt_v = fluid.data("token_type_ids", [B, S], "int32")
        am_v = fluid.data("attention_mask", [B, S], "int32")
        mp_v = fluid.data("masked_positions", [B, P], "int32")
        mlm_y = fluid.data("mlm_labels", [B, P], "int32")
        nsp_y = fluid.data("nsp_labels", [B, 1], "int32")
        mlm_logits, nsp_logits = from_layer(
            net, ids_v, prefix="bert", extra_args=(tt_v, am_v, mp_v))
        loss = record(net.loss, mlm_logits, nsp_logits, mlm_y, nsp_y,
                      prefix="bert_loss")
        pkg.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                            multi_precision=True).minimize(loss)
    return main, startup, loss


def test_layer_op_bert_matches_jax_and_leaves_the_layer():
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.bridge import load_jax_params
    from paddle_tpu_torch.models import bert as tbert

    kw = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128, max_position=64, dropout=0.0)
    B, S, P = 4, 16, 3
    jnet = jbert.BertForPretraining(jbert.BertConfig(**kw))
    tnet = tbert.BertForPretraining(tbert.BertConfig(**kw), device="cpu")
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    jbefore = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    tbefore = {k: p.detach().clone() for k, p in tnet.named_parameters()}
    jmain, jstart, jloss = _bert_program(jpt, jfluid, jnet, B, S, P)
    tmain, tstart, tloss = _bert_program(tpt, tfluid, tnet, B, S, P)
    jexe, texe = _exe(jfluid), _exe(tfluid)
    jexe.run(jstart)
    texe.run(tstart)
    _bridge(jmain, tmain)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (B, S)).astype(np.int32)
    pos = np.stack([np.sort(rng.choice(S, P, replace=False))
                    for _ in range(B)]).astype(np.int32)
    feed = {"input_ids": ids,
            "token_type_ids": (rng.rand(B, S) < 0.5).astype(np.int32),
            "attention_mask": np.ones((B, S), np.int32),
            "masked_positions": pos,
            "mlm_labels": np.take_along_axis(ids, pos, axis=1),
            "nsp_labels": rng.randint(0, 2, (B, 1)).astype(np.int32)}
    for _ in range(3):
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss])
        tl, = texe.run(tmain, feed=feed, fetch_list=[tloss])
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    # the caller's layer keeps its values in both packages
    for k, p in jnet.named_parameters():
        np.testing.assert_array_equal(np.asarray(p.value), jbefore[k])
    for k, p in tnet.named_parameters():
        assert torch.equal(p.detach(), tbefore[k]), k
    # while the scope trained
    assert not torch.equal(tmain.scope[list(tmain.scope)[0]].detach(),
                           tbefore["bert.embeddings.word.weight"])


# -- graph contract ------------------------------------------------------------
def test_builders_raise_outside_graph_mode():
    with pytest.raises(InvalidArgumentError, match="graph mode"):
        tfluid.layers.fc(torch.ones(2, 3), 4)


def test_symbolic_numpy_read_raises():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 4])
        with pytest.raises(InvalidArgumentError, match="fetch"):
            x.numpy()
        with pytest.raises(InvalidArgumentError, match="string"):
            tfluid.data("bad", ["N", 4])


def test_minimize_outside_graph_mode_raises_and_narrows_in_it():
    with pytest.raises(InvalidArgumentError, match="graph mode"):
        tpt.optimizer.SGD(0.1).minimize(torch.ones(()))
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 4])
        y = tfluid.data("y", [-1, 1])
        h = tfluid.layers.fc(x, 8, act="relu")
        pred = tfluid.layers.fc(h, 1)
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
        first = [p for p in main.all_parameters()][:2]
        ops, pg = tpt.optimizer.SGD(0.1).minimize(loss, parameter_list=first)
    assert ops == [] and [p for p, _ in pg] == first
    exe = _exe(tfluid)
    before = {n: t.detach().clone() for n, t in main.scope.items()}
    rng = np.random.RandomState(0)
    exe.run(main, feed={"x": rng.rand(8, 4).astype(np.float32),
                        "y": rng.rand(8, 1).astype(np.float32)},
            fetch_list=[loss])
    for n, t in main.scope.items():
        moved = not torch.equal(t.detach(), before[n])
        assert moved == (n in {p.name for p in first}), n


def test_state_dict_roundtrip_and_save_load_in_the_jax_format(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 4])
        out = tfluid.layers.fc(x, 2)
    exe = _exe(tfluid)
    X = np.ones((2, 4), np.float32)
    r1, = exe.run(main, feed={"x": X}, fetch_list=[out])
    path = str(tmp_path / "prog")
    tstatic.save(main, path)
    # the JAX package reads the file the port wrote
    from paddle_tpu.static import load_program_state as jload
    state = jload(path)
    assert set(state) == set(main.state_dict())
    fluid_state = {k: np.zeros_like(v) for k, v in state.items()}
    tfluid.set_program_state(main, fluid_state)
    r2, = exe.run(main, feed={"x": X}, fetch_list=[out])
    np.testing.assert_array_equal(r2, np.zeros_like(r1))
    tstatic.load(main, path)
    r3, = exe.run(main, feed={"x": X}, fetch_list=[out])
    np.testing.assert_array_equal(r3, r1)


def test_step_counter_advances_and_test_clone_freezes_it():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        tfluid.data("x", [-1, 2])
        step = tfluid.layers.autoincreased_step_counter(begin=1)
    clone = main.clone(for_test=True)
    exe = _exe(tfluid)
    feed = {"x": np.zeros((2, 2), np.float32)}
    vals = [int(exe.run(main, feed=feed, fetch_list=[step])[0])
            for _ in range(3)]
    assert vals == [1, 2, 3]
    v1 = int(exe.run(clone, feed=feed, fetch_list=[step])[0])
    v2 = int(exe.run(clone, feed=feed, fetch_list=[step])[0])
    assert v1 == v2 == 4


def test_training_flag_overrides_the_mode():
    """``run(training=True)`` on a test clone normalizes with the batch's
    statistics (BatchNorm in training mode) and still writes nothing
    back."""
    main, startup, loss, pred = convnet(tfluid)
    exe = _exe(tfluid)
    exe.run(startup)
    feed = _digits()
    clone = main.clone(for_test=True)
    ev, = exe.run(clone, feed=feed, fetch_list=[pred])
    tr, = exe.run(clone, feed=feed, fetch_list=[pred], training=True)
    assert not np.allclose(ev, tr)
    np.testing.assert_array_equal(
        exe.run(clone, feed=feed, fetch_list=[pred])[0], ev)


def test_scope_lives_on_the_executors_place():
    main, startup, loss, _ = fit_a_line(tfluid)
    exe = _exe(tfluid)
    exe.run(startup)
    X, Y = _line_data()
    exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
    assert main._placement["device"] == torch.device("cpu")
    assert main._placement["moves"] == 0
    for t in main.scope.values():
        assert t.device.type == "cpu" and t.requires_grad
    # a windowed average pool2d builds (the avg_pool2d of nn.functional)
    pooled = tfluid.layers.pool2d(tfluid.data("z", [-1, 1, 4, 4]), 2,
                                  pool_type="avg")
    assert pooled.shape[1:] == (1, 3, 3)  # pool_stride 1


# -- the vision builders ------------------------------------------------------
#: (feed shape, build(fluid, x) -> output Variable)
VISION_BUILDERS = {
    "conv2d_transpose": ((2, 4, 5, 5), lambda f, x: f.layers.conv2d_transpose(
        x, num_filters=6, filter_size=4, stride=2, padding=1, act="relu")),
    "conv2d_transpose_nhwc_groups": ((2, 5, 5, 4), lambda f, x:
                                     f.layers.conv2d_transpose(
                                         x, num_filters=6, filter_size=3,
                                         stride=2, groups=2,
                                         data_format="NHWC")),
    "conv3d": ((2, 3, 4, 5, 5), lambda f, x: f.layers.conv3d(
        x, num_filters=4, filter_size=3, padding=1, stride=2, act="tanh")),
    "conv3d_ndhwc_groups": ((2, 4, 5, 5, 4), lambda f, x: f.layers.conv3d(
        x, num_filters=4, filter_size=[2, 3, 3], groups=2,
        data_format="NDHWC")),
    "conv3d_transpose": ((2, 3, 3, 4, 4), lambda f, x:
                         f.layers.conv3d_transpose(
                             x, num_filters=2, filter_size=2, stride=2,
                             padding=[1, 0, 1])),
    "pool2d_avg_ceil_inclusive": ((2, 3, 7, 7), lambda f, x: f.layers.pool2d(
        f.layers.conv2d(x, num_filters=4, filter_size=3), pool_size=3,
        pool_type="avg", pool_stride=2, pool_padding=1, ceil_mode=True,
        exclusive=False)),
    "pool2d_avg_nhwc": ((2, 7, 7, 3), lambda f, x: f.layers.pool2d(
        f.layers.conv2d(x, num_filters=4, filter_size=3, data_format="NHWC"),
        pool_size=2, pool_type="avg", pool_stride=2, ceil_mode=True,
        data_format="NHWC")),
    "pool3d_max": ((2, 3, 5, 5, 5), lambda f, x: f.layers.pool3d(
        f.layers.conv3d(x, num_filters=4, filter_size=2), pool_size=2,
        pool_stride=2, ceil_mode=True)),
    "pool3d_avg": ((2, 3, 5, 5, 5), lambda f, x: f.layers.pool3d(
        f.layers.conv3d(x, num_filters=4, filter_size=2), pool_size=3,
        pool_type="avg", pool_stride=2, pool_padding=1, exclusive=True)),
}


@pytest.mark.parametrize("case", list(VISION_BUILDERS))
def test_vision_builder_as_jax(case):
    """Each builder of the vision slice in a Program with a mean loss and
    SGD, both packages from one set of parameters: the output and loss of
    3 training runs (rtol 1e-5 / atol 1e-5), then every parameter (atol
    1e-5)."""
    shape, body = VISION_BUILDERS[case]

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", [-1] + list(shape[1:]))
            out = body(fluid, x)
            loss = fluid.layers.mean(out)
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return main, startup, out, loss

    jmain, jstart, jout, jloss = build(jfluid)
    tmain, tstart, tout, tloss = build(tfluid)
    assert tout.shape[1:] == tuple(jout.shape[1:])
    jexe, texe = _exe(jfluid), _exe(tfluid)
    jexe.run(jstart)
    texe.run(tstart)
    _bridge(jmain, tmain)
    feed = {"x": np.random.RandomState(len(case)).randn(*shape).astype(
        np.float32)}
    for _ in range(3):
        jo, jl = jexe.run(jmain, feed=feed, fetch_list=[jout, jloss])
        to, tl = texe.run(tmain, feed=feed, fetch_list=[tout, tloss])
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    jp, tp = _by_key(jmain.scope), _by_key(tmain.scope)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-5, err_msg=k)


def test_vision_builders_are_in_static_nn():
    import paddle_tpu.static.nn as jsnn
    import paddle_tpu_torch.static.nn as tsnn

    for name in ("conv2d_transpose", "conv3d", "conv3d_transpose"):
        assert not getattr(getattr(tsnn, name), "__shim__", False)
        assert getattr(tsnn, name) is getattr(tfluid.layers, name)
        assert name in tsnn.__all__ and name in jsnn.__all__
    assert not getattr(tfluid.layers.pool3d, "__shim__", False)


# -- on the card ---------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scope on the card, moved from "
                    "and back to the CPU")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_one_program_on_the_card_and_on_the_cpu():
    """A program run on ``Executor(CUDAPlace(0))`` moves its scope there;
    then on ``Executor(CPUPlace())`` back: the losses follow one
    trajectory (card and CPU at rtol 1e-5) and the scope moved twice."""
    _card()
    tpt.seed(0)
    main, startup, loss, _ = fit_a_line(tfluid)
    tpt.seed(0)  # the same initial values
    ref, rstart, rloss, _ = fit_a_line(tfluid)
    card = tfluid.Executor(tfluid.CUDAPlace(0))
    cpu = tfluid.Executor(tfluid.CPUPlace())
    cpu.run(startup)
    cpu.run(rstart)
    X, Y = _line_data()
    feed = {"x": X, "y": Y}
    got = [card.run(main, feed=feed, fetch_list=[loss])[0]
           for _ in range(3)]
    assert all(t.device.type == "cuda" for t in main.scope.values())
    got += [cpu.run(main, feed=feed, fetch_list=[loss])[0]
            for _ in range(3)]
    assert all(t.device.type == "cpu" for t in main.scope.values())
    assert main._placement["moves"] == 2
    want = [cpu.run(ref, feed=feed, fetch_list=[rloss])[0]
            for _ in range(6)]
    np.testing.assert_allclose(np.ravel(got), np.ravel(want), rtol=1e-5)


# -- the detection builders and names -----------------------------------------
def _det_feeds(seed):
    rng = np.random.RandomState(seed)
    return {"f0": rng.randn(2, 4, 6, 6).astype(np.float32),
            "f1": rng.randn(2, 6, 3, 3).astype(np.float32),
            "f2": rng.randn(2, 5, 2, 2).astype(np.float32),
            "img": rng.randn(2, 3, 48, 48).astype(np.float32)}


def _mbox(f, feeds):
    maps = [f.data(k, [-1] + list(feeds[k].shape[1:]))
            for k in ("f0", "f1", "f2")]
    img = f.data("img", [-1, 3, 48, 48])
    locs, confs, boxes, var = f.layers.multi_box_head(
        maps, img, base_size=48, num_classes=3,
        aspect_ratios=[[2.0], [2.0, 3.0], [2.0]], min_ratio=20,
        max_ratio=90, flip=True, clip=True)
    return (locs, confs, boxes, var), (f.layers.mean(locs)
                                       + f.layers.mean(confs))


def _dcn(modulated):
    def body(f, feeds):
        x = f.data("x", [-1, 4, 7, 7])
        off = f.data("off", [-1, 18, 7, 7])
        m = f.data("m", [-1, 9, 7, 7]) if modulated else None
        out = f.layers.deformable_conv(x, off, m, num_filters=5,
                                       filter_size=3, padding=1,
                                       modulated=modulated)
        return (out,), f.layers.mean(out)
    return body


def _dcn_feeds(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(2, 4, 7, 7).astype(np.float32),
            "off": rng.randn(2, 18, 7, 7).astype(np.float32),
            "m": rng.uniform(size=(2, 9, 7, 7)).astype(np.float32)}


#: name: (feeds(seed), build(fluid, feeds) -> (outputs, loss))
DETECTION_BUILDERS = {
    "multi_box_head": (_det_feeds, _mbox),
    "deformable_conv_v1": (_dcn_feeds, _dcn(False)),
    "deformable_conv_v2": (_dcn_feeds, _dcn(True)),
}


@pytest.mark.parametrize("case", list(DETECTION_BUILDERS))
def test_detection_builder_as_jax(case):
    """multi_box_head / deformable_conv in a Program with a mean loss and
    SGD, both packages from one set of parameters: every output and the
    loss of 3 runs (rtol / atol 1e-5), then every parameter."""
    make_feeds, body = DETECTION_BUILDERS[case]
    feeds = make_feeds(len(case))
    if case == "deformable_conv_v1":
        feeds.pop("m")

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            outs, loss = body(fluid, feeds)
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return main, startup, list(outs) + [loss]

    jmain, jstart, jfetch = build(jfluid)
    tmain, tstart, tfetch = build(tfluid)
    jexe, texe = _exe(jfluid), _exe(tfluid)
    jexe.run(jstart)
    texe.run(tstart)
    _bridge(jmain, tmain)
    for _ in range(3):
        jo = jexe.run(jmain, feed=feeds, fetch_list=jfetch)
        to = texe.run(tmain, feed=feeds, fetch_list=tfetch)
        for t, j in zip(to, jo):
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    jp, tp = _by_key(jmain.scope), _by_key(tmain.scope)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-5, err_msg=k)


def test_detection_layers_record_as_jax():
    """The 1.x detection names called with Variables record into the
    Program (as in the JAX package) and run as JAX's do: proposals, their
    RoI features, multi-class NMS of a box head."""
    rng = np.random.RandomState(3)
    A, H, W = 3, 5, 6
    feeds = {
        "scores": rng.uniform(size=(2, A, H, W)).astype(np.float32),
        "deltas": (rng.randn(2, 4 * A, H, W) * 0.2).astype(np.float32),
        "info": np.array([[80, 96, 1.0], [80, 96, 1.0]], np.float32),
        "feat": rng.randn(2, 4, H, W).astype(np.float32),
        "cls": rng.uniform(size=(2, 3, 20)).astype(np.float32)}

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        L = fluid.layers
        with fluid.program_guard(main, startup):
            v = {k: fluid.data(k, [-1] + list(a.shape[1:]))
                 for k, a in feeds.items()}
            anchors, var = L.anchor_generator(
                v["feat"], [16.0, 32.0, 48.0], [1.0], stride=[16.0, 16.0])
            rois, probs, num = L.generate_proposals(
                v["scores"], v["deltas"], v["info"], anchors, var,
                pre_nms_top_n=50, post_nms_top_n=20, nms_thresh=0.6,
                return_rois_num=True)
            flat = L.reshape(rois, [-1, 4])
            pooled = L.roi_align(v["feat"], flat, 2, 2, 1.0 / 16, 2,
                                 rois_num=num)
            dets = L.multiclass_nms(rois, v["cls"], 0.2, 15, 10, 0.5)
        return main, [rois, probs, num, pooled, dets]

    jmain, jf = build(jfluid)
    tmain, tf = build(tfluid)
    jo = _exe(jfluid).run(jmain, feed=feeds, fetch_list=jf)
    to = _exe(tfluid).run(tmain, feed=feeds, fetch_list=tf)
    for t, j in zip(to, jo):
        np.testing.assert_allclose(np.asarray(t, np.float32),
                                   np.asarray(j, np.float32), rtol=1e-5,
                                   atol=1e-5)
    assert all(not getattr(getattr(tfluid.layers, n), "__shim__", False)
               for n in ("roi_align", "multiclass_nms", "generate_proposals",
                         "retinanet_detection_output", "multi_box_head",
                         "deformable_conv"))


def test_retinanet_detection_output_as_jax():
    rng = np.random.RandomState(4)
    N, C = 2, 3
    anchors = [np.asarray(jpt.nn.functional.anchor_generator(
        np.zeros((1, 1, h, h), np.float32), [s], [1.0],
        stride=[64 // h, 64 // h])[0]).reshape(-1, 4)
        for h, s in ((4, 16.0), (2, 32.0))]
    bboxes = [(rng.randn(N, len(a), 4) * 0.2).astype(np.float32)
              for a in anchors]
    scores = [rng.uniform(size=(N, len(a), C)).astype(np.float32)
              for a in anchors]
    info = np.array([[64, 64, 1.0], [64, 64, 0.5]], np.float32)
    kw = dict(score_threshold=0.3, nms_top_k=12, keep_top_k=10,
              nms_threshold=0.5, nms_eta=0.9)
    want = jfluid.layers.retinanet_detection_output(bboxes, scores, anchors,
                                                    info, **kw)
    got = tfluid.layers.retinanet_detection_output(
        [torch.from_numpy(b) for b in bboxes], scores, anchors, info, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_detection_builders_are_in_static_nn():
    import paddle_tpu.static.nn as jsnn
    import paddle_tpu_torch.static.nn as tsnn

    for name in ("multi_box_head", "deformable_conv"):
        assert getattr(tsnn, name) is getattr(tfluid.layers, name)
        assert name in tsnn.__all__
        assert not hasattr(getattr(tsnn, name), "__shim__")
    assert tsnn.deform_conv2d is tpt.nn.functional.deform_conv2d
    assert "multi_box_head" in jsnn.__all__
    assert "deform_conv2d" in jsnn.__all__
