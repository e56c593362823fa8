"""The port's ``expert`` mesh axis against the JAX package's MoE under
``strategy.expert_parallel`` (``paddle_tpu/moe/layer.py``'s expert specs,
GSPMD's all-to-alls).

One spawned world of 4 gloo ranks (``torch_dist_workers.expert_world``):
``ep`` 4 x ``dp`` 1 and ``ep`` 2 x ``dp`` 2, each through ``fleet.init``
→ ``distributed_optimizer`` → ``Model.prepare`` → two ``train_batch``
steps of a top-2 MoE ``gpt_tiny`` (4 experts, no jitter) from the JAX
init, against JAX's 4-device mesh under the same strategy: losses rtol
1e-5, gathered parameters atol 1e-4 after two Adam steps and 1e-5 after
two SGD steps (the gradients, scaled), the qkv key-bias third (zero
gradient in exact arithmetic) within 2·lr of its start under Adam and
1e-8 under SGD.  The routing counters of every rank equal
one device's over the global batch.  The dryrun's leg 7(a) invariant:
at top-1, capacity >= tokens and identical experts, the expert-parallel
MoE model's loss equals the dense model's (rtol 1e-6) and the summed
expert gradients the dense MLP's (atol 1e-5).  The dryrun's sparse CTR
leg runs in the same world at ``dp`` 2 x ``mp`` 2: ``wide_deep_tiny``'s
sparse tables sharded over the vocabulary, lazy Adam, two steps against
JAX's (losses rtol 1e-5, parameters atol 1e-6), the rows no id touched
bit-equal to their start.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.mesh import build_mesh as jbuild
from paddle_tpu.distributed.mesh import set_mesh as jset
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.moe import stats as jstats
from paddle_tpu_torch.distributed import spawn

import torch_dist_workers as W

E = 4
CFG = dict(moe_experts=E, moe_top_k=2, moe_jitter=0.0)
MESHES = {
    "ep4": dict(dp_degree=1, expert_parallel=True,
                expert_parallel_configs={"expert_parallel_degree": 4}),
    "ep2dp2": dict(dp_degree=2, expert_parallel=True,
                   expert_parallel_configs={"expert_parallel_degree": 2}),
}


def _tree(net):
    return {k: np.asarray(p.value) for k, p in net.named_parameters()}


def _inputs():
    jpt.seed(0)
    moe = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**CFG))
    jpt.seed(0)
    dense = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    d = _tree(dense)
    # every expert = the dense MLP, the rest the dense model's
    jpt.seed(0)
    eq = _tree(jgpt.GPTForCausalLM(jgpt.gpt_tiny(
        moe_experts=E, moe_top_k=1, moe_capacity_factor=8.0,
        moe_jitter=0.0, moe_balance_weight=0.0)))
    for k in eq:
        if k in d:
            eq[k] = d[k]
    for i in range(2):
        b = f"gpt.blocks.{i}.mlp."
        for e_name, d_name in (("expert_fc1", "fc1.weight"),
                               ("expert_b1", "fc1.bias"),
                               ("expert_fc2", "fc2.weight"),
                               ("expert_b2", "fc2.bias")):
            eq[b + e_name] = np.broadcast_to(
                d[b + d_name], eq[b + e_name].shape).copy()
    rng = np.random.RandomState(11)
    from paddle_tpu.models import wide_deep_tiny as jwd

    jpt.seed(0)
    crng = np.random.RandomState(6)
    ids = crng.randint(0, 256, size=(16, 4)).astype(np.int32)
    ctr = {"init": _tree(jwd(vocab_size=512, sparse=True)), "ids": ids,
           "dense": crng.randn(16, 4).astype(np.float32),
           "y": (ids[:, :1] < 128).astype(np.float32)}
    return {"init": _tree(moe), "dense_init": d, "equiv_init": eq,
            "batches": [rng.randint(0, 128, (4, 16)).astype(np.int32)
                        for _ in range(2)],
            "cfg": CFG, "meshes": MESHES, "ctr": ctr}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs):
    return spawn(W.expert_world, (inputs,), nprocs=4, backend="gloo",
                 timeout=240).results


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


def _jax_train(inputs, kw, opt):
    jfleet._initialized = False
    jfleet.init(is_collective=True, strategy=jfleet.DistributedStrategy(
        **kw), devices=jax.devices()[:4])
    net = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**CFG))
    net.set_state_dict({k: jnp.asarray(v) for k, v in inputs["init"].items()})
    model = jpt.Model(net)
    model.prepare(optimizer=jfleet.distributed_optimizer(opt),
                  loss=net.loss)
    losses = [model.train_batch([ids], [ids])[0]
              for ids in inputs["batches"]]
    out = np.asarray(losses), _tree(net)
    jfleet._initialized = False
    jset(jbuild())
    return out


_JAX = {}


def _jax(inputs, mesh, opt):
    if (mesh, opt) not in _JAX:
        jo = jopt.Adam(learning_rate=1e-3) if opt == "adam" else \
            jopt.SGD(learning_rate=0.1)
        _JAX[mesh, opt] = _jax_train(inputs, MESHES[mesh], jo)
    return _JAX[mesh, opt]


def _close(got, want, init, atol, key_atol):
    for k, v in want.items():
        g = got[k]
        if k.endswith("attn.qkv.bias"):
            d = v.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], init[k][d:2 * d], rtol=0,
                                       atol=key_atol, err_msg=k)
            g, v = np.delete(g, np.s_[d:2 * d]), np.delete(v, np.s_[
                d:2 * d])
        np.testing.assert_allclose(g, v, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_expert_parallel_steps_match_jax(world, inputs, mesh, opt):
    losses, params = _jax(inputs, mesh, opt)
    key = mesh if opt == "adam" else mesh + "_sgd"
    ep = MESHES[mesh]["expert_parallel_configs"]["expert_parallel_degree"]
    for r in range(4):
        got = _ok(world[r][key])
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        # the key biases: Adam moves them by up to lr a step on rounding
        # noise, SGD by lr times that noise
        _close(got["params"], params, inputs["init"],
               1e-4 if opt == "adam" else 1e-5,
               2e-3 if opt == "adam" else 1e-8)
        # each rank holds E / ep experts
        assert got["local_fc1"][0] == E // ep


@pytest.mark.parametrize("mesh", list(MESHES))
def test_routing_counters_equal_one_devices(world, inputs, mesh):
    net = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**CFG))
    net.set_state_dict({k: jnp.asarray(v) for k, v in inputs["init"].items()})
    net.eval()
    # the ranks counted after their two steps: JAX's trained parameters
    _, params = _jax(inputs, mesh, "adam")
    net.set_state_dict({k: jnp.asarray(v) for k, v in params.items()})
    with jstats.collect() as ms:
        net.gpt(jnp.asarray(inputs["batches"][0]))
    want = np.asarray(ms.counts(E))
    for r in range(4):
        got = _ok(world[r][mesh])["counts"]
        np.testing.assert_array_equal(got, want)


def test_dense_equivalence_on_the_expert_axis(world):
    for r in range(4):
        got = _ok(world[r]["dense_equivalence"])
        d, m = got["dense"], got["moe"]
        np.testing.assert_allclose(m["loss"], d["loss"], rtol=1e-6)
        for k, g in d["grads"].items():
            if ".mlp." in k:
                continue
            np.testing.assert_allclose(m["grads"][k], g, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        for i in range(2):
            b = f"gpt.blocks.{i}.mlp."
            for e_name, d_name in (("expert_fc1", "fc1.weight"),
                                   ("expert_b1", "fc1.bias"),
                                   ("expert_fc2", "fc2.weight"),
                                   ("expert_b2", "fc2.bias")):
                ge = m["grads"][b + e_name]
                assert np.abs(ge).max() > 0, e_name
                np.testing.assert_allclose(ge.sum(0), d["grads"][b + d_name],
                                           rtol=0, atol=1e-5,
                                           err_msg=b + e_name)


def test_sparse_ctr_leg_with_vocabulary_sharded_tables(world, inputs):
    from paddle_tpu.models import wide_deep_tiny as jwd

    c = inputs["ctr"]
    jfleet.init(is_collective=True, strategy=jfleet.DistributedStrategy(
        dp_degree=2, tensor_parallel=True,
        tensor_parallel_configs={"tensor_parallel_degree": 2}),
        devices=jax.devices()[:4])
    net = jwd(vocab_size=512, sparse=True)
    net.set_state_dict({k: jnp.asarray(v) for k, v in c["init"].items()})
    model = jpt.Model(net, inputs=["sparse", "dense"], labels=["label"])
    model.prepare(optimizer=jfleet.distributed_optimizer(
        jopt.Adam(learning_rate=1e-2, lazy_mode=True)), loss=net.loss)
    losses = [model.train_batch([c["ids"], c["dense"]], [c["y"]])[0]
              for _ in range(2)]
    params = _tree(net)
    untouched = np.setdiff1d(np.arange(512), np.unique(c["ids"]))
    for r in range(4):
        got = _ok(world[r]["sparse_ctr"])
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(
            got["params"]["embedding.weight"][untouched],
            c["init"]["embedding.weight"][untouched])
        # the table is vocabulary-sharded: each rank holds 256 rows, and
        # its rows no id touched are bit-unchanged
        assert got["local_rows"] == 256
        m = r % 2  # the model coordinate
        mine = untouched[(untouched >= 256 * m) & (untouched < 256 * (m + 1))]
        np.testing.assert_array_equal(got["local_after"][mine - 256 * m],
                                      got["local_before"][mine - 256 * m])
