"""The port's ``fluid`` and ``static`` namespaces against the JAX
package's.

* Name coverage: every public name of ``paddle_tpu.static``,
  ``paddle_tpu.static.nn``, ``paddle_tpu.fluid`` and
  ``paddle_tpu.fluid.layers`` resolves in the port — implemented, or a
  function / class / module that raises ``UnimplementedError`` naming a
  ROADMAP queue-A item; one case a name.
* The 1.x calling-convention wrappers of ``fluid.layers`` against the JAX
  ones on the same seeded inputs (float32, rtol 1e-5 / atol 1e-6; the
  integer and boolean results exactly), eagerly and recorded into a
  Program.
* ``fluid.optimizer``'s 1.x spellings, ``fluid.core``, the places and
  the static-mode switches.
* bench.py's three programs written with the port's API line for line:
  config 1 (``bench_mnist``) exactly, on the CPU (accuracy >= 0.97, one
  dispatch for the 150-step chain); configs 3 (``bench_bert``) and 2
  (``bench_resnet50``) with the same lines at a tiny size (a 2-layer BERT,
  ResNet-50 at 32 x 32), two ``run_steps`` windows each.
"""
import math
import re
import types

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.fluid.layers as jfl
import paddle_tpu.static as jstatic
import paddle_tpu.static.nn as jsnn
import paddle_tpu_torch as tpt
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.fluid.layers as tfl
import paddle_tpu_torch.static as tstatic
import paddle_tpu_torch.static.nn as tsnn
from paddle_tpu.static.graph import reset_default_programs as jreset
from paddle_tpu_torch.framework import device as tdevice
from paddle_tpu_torch.framework.errors import (UnavailableError,
                                               UnimplementedError)
from paddle_tpu_torch.static.graph import reset_default_programs as treset

#: the names of ROADMAP queue A's items, as the port's errors cite them
ITEMS = ("generation serving", "training step", "quantized serving",
         "vision", "MoE, LoRA and tenancy", "distributed execution",
         "control plane and operations", "static graph and the long tail")
#: imports of the JAX modules, not API
_IMPORTS = {"annotations", "Optional", "Sequence", "np", "jax", "jnp",
            "contextlib", "convert_dtype", "control_flow"}


def _public(mod):
    names = set(getattr(mod, "__all__", ()))
    names |= {n for n in dir(mod) if not n.startswith("_")}
    names |= set(getattr(mod, "_STATIC_ONLY", ()))
    return sorted(names - _IMPORTS)


MODULES = {"static": (jstatic, tstatic), "static.nn": (jsnn, tsnn),
           "fluid": (jfluid, tfluid), "fluid.layers": (jfl, tfl)}
CASES = [(m, n) for m, (jmod, _) in MODULES.items() for n in _public(jmod)]


@pytest.fixture(autouse=True)
def _fresh():
    saved = tdevice._chosen
    tdevice.set_device("cpu")
    jreset()
    treset()
    tpt.seed(0)
    yield
    jreset()
    treset()
    tpt.disable_static()
    tdevice._chosen = saved


def _raises_item(call):
    with pytest.raises(UnimplementedError) as e:
        call()
    m = re.search(r"ROADMAP queue A, ([^)]+)\)", str(e.value))
    assert m and m.group(1) in ITEMS, str(e.value)


def test_name_coverage_counts():
    assert len(CASES) == len(set(CASES))
    assert {m: sum(1 for mm, _ in CASES if mm == m) for m in MODULES} == {
        "static": 36, "static.nn": 28, "fluid": 61, "fluid.layers": 286}


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m}.{n}" for m, n in CASES])
def test_every_jax_name_resolves_in_the_port(module, name):
    tmod = MODULES[module][1]
    obj = getattr(tmod, name)  # never a bare AttributeError
    if isinstance(obj, tfluid._UnportedModule):
        _raises_item(lambda: obj.anything)
    elif getattr(obj, "__shim__", False):
        _raises_item(obj)
    else:
        assert callable(obj) or isinstance(obj, (types.ModuleType, dict,
                                                 str, int, type)), name


# -- the 1.x wrappers against JAX's ---------------------------------------
def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


WRAPPERS = {
    "reduce_sum": lambda r: ((_f32(r, 3, 4),), dict(dim=1, keep_dim=True)),
    "reduce_mean": lambda r: ((_f32(r, 3, 4),), dict(dim=0)),
    "reduce_max": lambda r: ((_f32(r, 3, 4),), dict(dim=-1)),
    "reduce_min": lambda r: ((_f32(r, 3, 4),), {}),
    "reduce_prod": lambda r: ((_f32(r, 3, 4),), dict(dim=1)),
    "reduce_all": lambda r: ((_f32(r, 3, 4) > 0,), dict(dim=1)),
    "reduce_any": lambda r: ((_f32(r, 3, 4) > 0,), dict(dim=0)),
    "softmax": lambda r: ((_f32(r, 3, 5),), {}),
    "relu": lambda r: ((_f32(r, 3, 5),), {}),
    "matmul": lambda r: ((_f32(r, 2, 4, 3), _f32(r, 2, 5, 3)),
                         dict(transpose_y=True, alpha=0.5)),
    "mul": lambda r: ((_f32(r, 2, 3, 4), _f32(r, 12, 5)),
                      dict(x_num_col_dims=1)),
    "one_hot": lambda r: ((r.randint(0, 6, (5, 1)),), dict(depth=6)),
    "scale": lambda r: ((_f32(r, 3, 4),), dict(scale=2.0, bias=1.0,
                                                bias_after_scale=False)),
    "elementwise_add": lambda r: ((_f32(r, 2, 3, 4), _f32(r, 3)),
                                  dict(axis=1)),
    "elementwise_sub": lambda r: ((_f32(r, 2, 3), _f32(r, 2, 3)), {}),
    "elementwise_mul": lambda r: ((_f32(r, 2, 3, 4), _f32(r, 3, 4)),
                                  dict(axis=1, act="relu")),
    "elementwise_div": lambda r: ((_f32(r, 2, 3), 1.5 + np.abs(
        _f32(r, 2, 3))), {}),
    "elementwise_max": lambda r: ((_f32(r, 2, 3), _f32(r, 2, 3)), {}),
    "elementwise_min": lambda r: ((_f32(r, 2, 3), _f32(r, 2, 3)), {}),
    "elementwise_pow": lambda r: ((np.abs(_f32(r, 2, 3)) + 0.5,
                                   _f32(r, 2, 3)), {}),
    "l2_normalize": lambda r: ((_f32(r, 3, 4),), dict(axis=1)),
    "cos_sim": lambda r: ((_f32(r, 3, 4), _f32(r, 3, 4)), {}),
    "cross_entropy": lambda r: ((np.abs(_f32(r, 4, 5)) + 0.1,
                                 r.randint(0, 5, (4, 1))), {}),
    "softmax_with_cross_entropy": lambda r: ((_f32(r, 4, 5),
                                              r.randint(0, 5, (4, 1))), {}),
    "square_error_cost": lambda r: ((_f32(r, 4, 1), _f32(r, 4, 1)), {}),
    "sigmoid_cross_entropy_with_logits": lambda r: (
        (_f32(r, 4, 3), (r.rand(4, 3) > 0.5).astype(np.float32)), {}),
    "smooth_l1": lambda r: ((_f32(r, 4, 3), _f32(r, 4, 3)),
                            dict(sigma=2.0)),
    "hard_sigmoid": lambda r: ((_f32(r, 3, 4),), {}),
    "hard_swish": lambda r: ((3 * _f32(r, 3, 4),), {}),
    "brelu": lambda r: ((30 * _f32(r, 3, 4),), {}),
    "soft_relu": lambda r: ((_f32(r, 3, 4),), {}),
    "reshape": lambda r: ((_f32(r, 3, 4),), dict(shape=[2, 6], act="tanh")),
    "split": lambda r: ((_f32(r, 4, 6),), dict(num_or_sections=3, dim=1)),
    "expand": lambda r: ((_f32(r, 2, 3),), dict(expand_times=[2, 1])),
    "mean": lambda r: ((_f32(r, 3, 4),), {}),
    "teacher_student_sigmoid_loss": lambda r: (
        (_f32(r, 6, 1), np.array([[-1], [0.2], [1.0], [1.5], [0], [2.0]],
                                 np.float32)), {}),
    "pad_constant_like": lambda r: ((_f32(r, 4, 5), _f32(r, 2, 3)),
                                    dict(pad_value=0.5)),
}


def _to_port(a):
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a))
    return a


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _compare(got, want):
    got, want = _host(got), _host(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _compare(g, w)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_one_x_wrapper_matches_jax(name):
    import jax.numpy as jnp

    args, kw = WRAPPERS[name](np.random.RandomState(0))
    want = getattr(jfl, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                else a for a in args], **kw)
    got = getattr(tfl, name)(*[_to_port(a) for a in args], **kw)
    _compare(got, want)
    # the same call recorded into a Program gives the same values
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        feeds = {f"a{i}": a for i, a in enumerate(args)
                 if isinstance(a, np.ndarray)}
        vs = [tfluid.data(f"a{i}", a.shape, a.dtype)
              if isinstance(a, np.ndarray) else a
              for i, a in enumerate(args)]
        out = getattr(tfl, name)(*vs, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    res = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feeds, fetch_list=outs)
    _compare(res if isinstance(out, (tuple, list)) else res[0], want)


def test_lr_decay_functions_follow_the_1x_formulas():
    s = tfl.exponential_decay(0.1, decay_steps=10, decay_rate=0.5)
    for _ in range(20):
        s.step()
    assert math.isclose(s.last_lr, 0.1 * 0.5 ** 2, rel_tol=1e-9)
    s = tfl.exponential_decay(0.1, 10, 0.5, staircase=True)
    for _ in range(15):
        s.step()
    assert math.isclose(s.last_lr, 0.05, rel_tol=1e-9)
    s = tfl.cosine_decay(0.2, step_each_epoch=3, epochs=4)
    for _ in range(6):
        s.step()
    assert math.isclose(s.last_lr, 0.2 * 0.5 * (math.cos(2 * math.pi / 4)
                                                 + 1), rel_tol=1e-9)
    assert tfl.piecewise_decay([2], [0.1, 0.01]).last_lr == 0.1


# -- fluid.optimizer, core, places, modes -----------------------------------
def test_fluid_optimizer_spellings():
    from paddle_tpu_torch.regularizer import L2Decay

    p = torch.nn.Parameter(torch.ones(3))
    opt = tfluid.optimizer.SGDOptimizer(0.1, parameter_list=[p],
                                        regularization=L2Decay(0.5))
    assert isinstance(opt, tpt.optimizer.SGD) and opt._weight_decay == 0.5
    assert tfluid.optimizer.Momentum is tfluid.optimizer.MomentumOptimizer
    lamb = tfluid.optimizer.LambOptimizer(0.01)
    assert isinstance(lamb, tpt.optimizer.Lamb)
    inner = tfluid.optimizer.AdamOptimizer(0.01)
    la = tfluid.optimizer.LookaheadOptimizer(inner, alpha=0.5, k=3)
    assert la.k == 3
    _raises_item(tfluid.optimizer.RecomputeOptimizer)
    with pytest.raises(UnimplementedError, match="parameter_list"):
        tfluid.optimizer.ExponentialMovingAverage(0.9)


def test_fluid_core_and_places():
    from paddle_tpu_torch.fluid import core

    assert issubclass(core.EOFException, Exception)
    assert core.globals()["FLAGS_executor_cache_capacity"] == 64
    with pytest.raises(UnimplementedError, match="core.ops.matmul"):
        core.ops.matmul
    assert tfluid.CPUPlace().torch_device() == torch.device("cpu")
    assert tfluid.CUDAPinnedPlace().torch_device() == torch.device("cpu")
    for place in (tfluid.TPUPlace, tfluid.XPUPlace):
        with pytest.raises(UnavailableError):
            place()
    assert tstatic.cpu_places(2) == [tfluid.CPUPlace()] * 2
    assert len(tstatic.cuda_places()) == torch.cuda.device_count()
    if not torch.cuda.is_available():  # the card by default, never the CPU
        tdevice._chosen = None
        with pytest.raises(UnavailableError):
            tfluid.Executor()


def test_static_mode_switches():
    assert tpt.in_dygraph_mode() and tfluid.in_dygraph_mode()
    assert isinstance(tstatic.data("x", [-1, 3]), tstatic.InputSpec)
    tpt.enable_static()
    assert not tpt.in_dygraph_mode()
    v = tstatic.data("x", [-1, 3])
    assert isinstance(v, tstatic.Variable) and v.shape == (None, 3)
    c = tfl.fill_constant([2], "float32", 3.0)
    assert isinstance(c, tstatic.Variable)
    tpt.disable_static()
    assert tpt.in_dygraph_mode()
    out = tfluid.Executor(tfluid.CPUPlace()).run(
        tstatic.default_main_program(), feed={"x": np.ones((1, 3),
                                                           np.float32)},
        fetch_list=[c])[0]
    np.testing.assert_array_equal(out, [3.0, 3.0])


# -- bench.py's programs in the port --------------------------------------
MNIST_ACC_GATE = 0.97


def test_bench_config_1_mnist_exactly():
    """``bench_mnist`` (bench.py:293-347) line for line with the port's
    API: 150 SGD steps in one ``run_steps`` on 4096 rows, then the test
    clone on 2048 rows."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.static.builders import layer_op
    from paddle_tpu_torch.static.graph import record_call

    tpt.seed(0)
    rng = np.random.RandomState(0)
    protos = rng.uniform(0, 1, (10, 784)).astype(np.float32)

    def batch(n, seed):
        r = np.random.RandomState(seed)
        y = r.randint(0, 10, n).astype(np.int32)
        x = protos[y] + r.normal(0, 0.35, (n, 784)).astype(np.float32)
        return (x - 0.5).astype(np.float32), y

    net = nn.Sequential(nn.Linear(784, 128), nn.ReLU(),
                        nn.Linear(128, 64), nn.ReLU(), nn.Linear(64, 10))

    def nll(logits, y):
        lp = torch.log_softmax(logits, -1)
        return -torch.take_along_dim(lp, y[:, None].long(), 1).mean()

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 784])
        y = tfluid.data("y", [-1], "int32")
        logits = layer_op(net, x, prefix="mlp")
        loss = record_call(nll, logits, y, prefix="nll")
        popt.SGD(learning_rate=0.05).minimize(loss)

    xs, ys = batch(4096, 1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    out, = exe.run_steps(main, feed={"x": xs, "y": ys}, fetch_list=[loss],
                         iterations=150, fetch_every=150,
                         constant_feeds=("x", "y"))
    assert out.shape == (1,) and np.isfinite(out).all()
    assert exe.dispatches == 1
    xt, yt = batch(2048, 2)
    test_prog = main.clone(for_test=True)
    pred, = exe.run(test_prog, feed={"x": xt, "y": yt}, fetch_list=[logits])
    acc = float((np.asarray(pred).argmax(-1) == yt).mean())
    assert acc >= MNIST_ACC_GATE, acc


def _bench_bert_feeds(vocab, B, S, P):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, size=(B, S)).astype(np.int32)
    positions = np.stack([np.sort(rng.choice(S, P, replace=False))
                          for _ in range(B)]).astype(np.int32)
    return {
        "input_ids": ids,
        "token_type_ids": (rng.uniform(size=(B, S)) < 0.5).astype(np.int32),
        "attention_mask": np.ones((B, S), np.int32),
        "masked_positions": positions,
        "mlm_labels": np.take_along_axis(ids, positions, axis=1),
        "nsp_labels": rng.randint(0, 2, size=(B, 1)).astype(np.int32),
    }


def test_bench_config_3_bert_lines_at_a_tiny_size():
    """``bench_bert``'s program lines (bench.py:151-222) over a 2-layer
    BERT in bf16: ``layer_op(..., extra_args=)``, ``record_call(net.loss)``,
    ``AdamW(multi_precision=True).minimize``, ``run_steps(iterations=2,
    fetch_every=2, constant_feeds=all)``; float32 masters in the state."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.models import BertForPretraining
    from paddle_tpu_torch.models.bert import bert_tiny
    from paddle_tpu_torch.static.builders import layer_op
    from paddle_tpu_torch.static.graph import record_call

    BATCH, SEQ, MAX_PRED, N_STEPS = 4, 16, 3, 2
    tpt.seed(0)
    cfg = bert_tiny()
    net = BertForPretraining(cfg, device="cpu").astype("bfloat16")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids_v = tfluid.data("input_ids", [BATCH, SEQ], "int32")
        tt_v = tfluid.data("token_type_ids", [BATCH, SEQ], "int32")
        am_v = tfluid.data("attention_mask", [BATCH, SEQ], "int32")
        mp_v = tfluid.data("masked_positions", [BATCH, MAX_PRED], "int32")
        mlm_y = tfluid.data("mlm_labels", [BATCH, MAX_PRED], "int32")
        nsp_y = tfluid.data("nsp_labels", [BATCH, 1], "int32")
        mlm_logits, nsp_logits = layer_op(
            net, ids_v, prefix="bert", extra_args=(tt_v, am_v, mp_v))
        loss = record_call(net.loss, mlm_logits, nsp_logits, mlm_y, nsp_y,
                           prefix="bert_loss")
        popt.AdamW(learning_rate=1e-4, weight_decay=0.01,
                   multi_precision=True).minimize(loss)
    feeds = _bench_bert_feeds(cfg.vocab_size, BATCH, SEQ, MAX_PRED)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    finals = []
    for _ in range(2):
        out, = exe.run_steps(main, feed=feeds, fetch_list=[loss],
                             iterations=N_STEPS, fetch_every=N_STEPS,
                             constant_feeds=tuple(feeds))
        finals.append(float(out[-1]))
    assert all(math.isfinite(v) for v in finals)
    slots = main._opt_state["slots"]
    assert all(s["master"].dtype == torch.float32 for s in slots.values())
    assert all(t.dtype == torch.bfloat16 for t in main.scope.values())


def test_bench_config_2_resnet_lines_at_a_tiny_size():
    """``bench_resnet50``'s program lines (bench.py:225-290) over
    ``resnet50(NHWC, s2d)`` at 32 x 32, batch 2, in float32 (a CPU
    convolution in bf16 is not on the card's path): the loss on
    ``logits.float()``, ``Momentum(multi_precision=True)``, ``run_steps``
    windows with constant feeds; the BatchNorm buffers move."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.static.builders import layer_op
    from paddle_tpu_torch.static.graph import record_call
    from paddle_tpu_torch.vision.models import resnet50

    BATCH, HW, N_STEPS = 2, 32, 2
    tpt.seed(0)
    net = resnet50(data_format="NHWC", stem_space_to_depth=True,
                   num_classes=10, device="cpu")
    loss_layer = tpt.nn.CrossEntropyLoss()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        img = tfluid.data("image", [BATCH, HW, HW, 3], "float32")
        label = tfluid.data("label", [BATCH, 1], "int32")
        logits = layer_op(net, img, prefix="resnet50")
        loss = record_call(lambda o, y: loss_layer(o.float(), y),
                           logits, label, prefix="xent")
        popt.Momentum(learning_rate=0.1, momentum=0.9, multi_precision=True,
                      weight_decay=1e-4).minimize(loss)
    rng = np.random.RandomState(0)
    feeds = {"image": rng.uniform(-1, 1, (BATCH, HW, HW, 3))
             .astype(np.float32),
             "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int32)}
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    bufs = {k: v.clone() for k, v in main.buffers.items()}
    out, = exe.run_steps(main, feed=feeds, fetch_list=[loss],
                         iterations=N_STEPS, fetch_every=N_STEPS,
                         constant_feeds=("image", "label"))
    assert np.isfinite(out).all()
    assert any(not torch.equal(v, main.buffers[k]) for k, v in bufs.items())
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    exe.run_steps(main, feed=feeds, fetch_list=[loss], iterations=N_STEPS,
                  constant_feeds=("image", "label"))
    for k, p in net.named_parameters():
        assert torch.equal(p.detach(), before[k]), k
