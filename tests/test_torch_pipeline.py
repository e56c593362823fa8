"""The port's pipeline parallelism against the JAX package's
(``paddle_tpu.distributed.pipeline_parallel``, ``Model.prepare``'s
pipeline branch).

Two spawned worlds (``torch_dist_workers.pipeline_world``): 2 gloo ranks
for ``pp`` 2 and 4 for ``pp`` 2 x ``dp`` 2 and ``pp`` 2 x ``mp`` 2, each
schedule (GPipe, 1F1B) through ``fleet.init`` → ``distributed_optimizer``
→ ``Model.prepare`` → two ``train_batch`` steps of ``gpt_tiny(num_layers=
4)`` from the JAX init.  The JAX runs use the same strategy on as many of
the 8 host devices.  Tolerances (``gpt_tiny``'s at ``sharding`` 2 x
``model`` 2, ``test_torch_distributed_training.py``): losses rtol 1e-5,
gathered parameters atol 1e-4 — the key third of every ``qkv.bias``
(gradient 0 in exact arithmetic, moved by Adam on rounding noise in both
packages) held within 2·lr of its start.  Both schedules are also held
to the JAX step without a pipeline, and to each other at dropout 0.1
(their masks come from per-(block, microbatch) streams).
"""
import numpy as np
import pytest

import jax

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import pipeline_parallel as jpipe
from paddle_tpu.distributed.mesh import build_mesh as jbuild
from paddle_tpu.distributed.mesh import set_mesh as jset
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.distributed import pipeline_parallel as tpipe
from paddle_tpu_torch.distributed import spawn

import torch_dist_workers as W

LR = 1e-3
B = 8


def _configs():
    out = {}
    for name, extra in (("pp2", dict(dp_degree=1)),
                        ("pp2dp2", dict(dp_degree=2)),
                        ("pp2mp2", dict(dp_degree=1, mp_degree=2))):
        for sched, micro in (("gpipe", 2), ("1f1b", 4)):
            out[f"{name}_{sched}"] = dict(
                pp_degree=2, pipeline=True,
                pipeline_configs={"accumulate_steps": micro,
                                  "schedule": sched}, **extra)
    out["pp2"] = dict(pp_degree=2, pipeline=True, dp_degree=1,
                      pipeline_configs={"accumulate_steps": 2})
    return out


def _inputs():
    jpt.seed(0)
    net = jgpt.GPTForCausalLM(jgpt.gpt_tiny(num_layers=4))
    rng = np.random.RandomState(9)
    return {"init": {k: np.asarray(p.value)
                     for k, p in net.named_parameters()},
            "batches": [rng.randint(0, 128, (B, 16)).astype(np.int32)
                        for _ in range(2)],
            "configs": _configs(), "cfg": {"num_layers": 4}}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


_WORLDS = {}


def _world(n, inputs):
    if n not in _WORLDS:
        _WORLDS[n] = spawn(W.pipeline_world, (inputs,), nprocs=n,
                           backend="gloo", timeout=240).results
    return _WORLDS[n]


@pytest.fixture(autouse=True)
def _jax_mesh():
    jset(jbuild())
    yield
    jset(jbuild())
    jfleet._initialized = False
    jfleet._strategy = None


def _ok(res):
    assert not (isinstance(res, dict) and "error" in res), res.get("error")
    return res


def _jax_train(inputs, kw, n):
    jfleet._initialized = False
    if kw is not None:
        jfleet.init(is_collective=True,
                    strategy=jfleet.DistributedStrategy(**kw),
                    devices=jax.devices()[:n])
    net = jgpt.GPTForCausalLM(jgpt.gpt_tiny(num_layers=4))
    net.set_state_dict({k: jax.numpy.asarray(v)
                        for k, v in inputs["init"].items()})
    opt = jopt.Adam(learning_rate=LR)
    if kw is not None:
        opt = jfleet.distributed_optimizer(opt)
    model = jpt.Model(net)
    model.prepare(optimizer=opt, loss=net.loss)
    losses = [model.train_batch([ids], [ids])[0]
              for ids in inputs["batches"]]
    params = {k: np.asarray(p.value) for k, p in net.named_parameters()}
    jfleet._initialized = False
    jset(jbuild())
    return np.asarray(losses), params


_JAX = {}


def _jax(inputs, name, kw, n):
    if name not in _JAX:
        _JAX[name] = _jax_train(inputs, kw, n)
    return _JAX[name]


def _close(got, want, init):
    for k, v in want.items():
        g = got[k]
        if k.endswith("attn.qkv.bias"):
            d = v.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], init[k][d:2 * d], rtol=0,
                                       atol=2 * LR, err_msg=k)
            g, v = np.delete(g, np.s_[d:2 * d]), np.delete(v, np.s_[
                d:2 * d])
        np.testing.assert_allclose(g, v, rtol=0, atol=1e-4, err_msg=k)


CASES = [(n, m) for n in ("pp2", "pp2dp2", "pp2mp2")
         for m in ("gpipe", "1f1b")]


@pytest.mark.parametrize("name,sched", CASES,
                         ids=[f"{n}_{m}" for n, m in CASES])
def test_schedules_match_jax_train_batch(inputs, name, sched):
    # one JAX run a mesh (its 1F1B step): JAX's two schedules are one
    # function, and so are the port's (the next test)
    kw = inputs["configs"][f"{name}_1f1b"]
    n = 2 if name == "pp2" else 4
    world = _world(n, inputs)
    losses, params = _jax(inputs, name, kw, n)
    flat_losses, _ = _jax(inputs, "flat", None, 1)
    np.testing.assert_allclose(losses, flat_losses, rtol=1e-5)
    for r in range(n):
        got = _ok(world[r][f"{name}_{sched}"])
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["losses"], flat_losses, rtol=1e-5)
        _close(got["params"], params, inputs["init"])


@pytest.mark.parametrize("name", ["pp2", "pp2dp2", "pp2mp2"])
def test_gpipe_equals_1f1b_and_stages_own_their_blocks(inputs, name):
    n = 2 if name == "pp2" else 4
    world = _world(n, inputs)
    for r in range(n):
        g = _ok(world[r][f"{name}_gpipe"])
        f = _ok(world[r][f"{name}_1f1b"])
        np.testing.assert_allclose(g["losses"], f["losses"], rtol=1e-5)
        for k in g["params"]:
            np.testing.assert_allclose(g["params"][k], f["params"][k],
                                       rtol=0, atol=1e-4, err_msg=k)
        # stage s updates blocks [2s, 2s + 1] of the 4
        stage = r // (n // 2)
        assert {int(k.split(".")[2]) for k in f["owned"]} == {
            2 * stage, 2 * stage + 1}


def test_1f1b_keeps_at_most_ring_buffer_slots_live(inputs):
    assert tpipe.ring_buffer_slots(2) == jpipe.ring_buffer_slots(2) == 3
    for name, n in (("pp2", 2), ("pp2dp2", 4)):
        world = _world(n, inputs)
        for r in range(n):
            # 4 microbatches: 1F1B holds 3 at stage 0 (GPipe would hold 4)
            assert _ok(world[r][f"{name}_1f1b"])["max_live"] <= 3


def test_refusals_raise_in_both_packages(inputs):
    world = _world(2, inputs)
    jfleet.init(is_collective=True, strategy=jfleet.DistributedStrategy(
        pp_degree=2), devices=jax.devices()[:2])
    jnn = jpt.nn
    jblocks = [jnn.Linear(4, 4) for _ in range(3)]
    z = jax.numpy.zeros((4, 4))
    jax_errors = {}
    for name, call in (
            ("blocks", lambda: jpipe.pipeline_blocks(jblocks, z)),
            ("batch", lambda: jpipe.pipeline_blocks(
                jblocks[:2], jax.numpy.zeros((3, 4)), num_microbatches=2)),
            ("buffers", lambda: jpipe.pipeline_blocks(
                [jnn.BatchNorm1D(4), jnn.BatchNorm1D(4)], z)),
            ("schedule", lambda: jpipe.pipeline_train_step(
                jblocks[:2], z, jax.numpy.zeros(4),
                lambda y, lbl: y.sum(), schedule="zigzag"))):
        with pytest.raises(Exception) as e:
            call()
        jax_errors[name] = (type(e.value).__name__, str(e.value))
    for r in range(2):
        got = _ok(world[r]["refusals"])
        for name, (kind, msg) in jax_errors.items():
            assert got[name][0] == kind, (name, got[name], kind)
            assert got[name][1] == msg, (name, got[name][1], msg)
        assert got["structure"][0] == "InvalidArgumentError"
        assert "structurally identical" in got["structure"][1]
        assert got["mask"][0] == "ValueError"
        assert "causal mask only" in got["mask"][1]
        assert got["prepare_1f1b"][0] == "InvalidArgumentError"
        assert "pipeline_decompose" in got["prepare_1f1b"][1]


def test_dropout_masks_do_not_depend_on_the_schedule(inputs):
    world = _world(2, inputs)
    for r in range(2):
        got = _ok(world[r]["dropout_schedules"])
        np.testing.assert_allclose(got["gpipe"], got["1f1b"], rtol=1e-5)
    # the masks are drawn (dropout 0.1 moves the loss off the dropout-0 one)
    zero = _ok(world[0]["pp2_gpipe"])["losses"]
    assert not np.allclose(_ok(world[0]["dropout_schedules"])["gpipe"],
                           zero, rtol=1e-4)


def test_eval_and_predict_run_the_pipelined_forward(inputs):
    world = _world(2, inputs)
    net = jgpt.GPTForCausalLM(jgpt.gpt_tiny(num_layers=4))
    net.set_state_dict({k: jax.numpy.asarray(v)
                        for k, v in inputs["init"].items()})
    ids = inputs["batches"][0]
    model = jpt.Model(net)
    model.prepare(loss=net.loss)
    want = model.eval_batch([ids], [ids])[0]
    logits = np.asarray(model.predict_batch([ids])[0])
    for r in range(2):
        got = _ok(world[r]["eval_forward"])
        np.testing.assert_allclose(got["loss"], want, rtol=1e-5)
        np.testing.assert_allclose(got["logits"], logits, rtol=1e-4,
                                   atol=1e-5)


def test_1f1b_metrics_compute_a_microbatch_on_the_last_stage(inputs):
    world = _world(2, inputs)
    for r in range(2):
        got = _ok(world[r]["metrics_1f1b"])
        np.testing.assert_allclose(got["pp"], got["flat"], rtol=1e-6)
