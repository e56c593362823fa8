"""The port's fleet training path against the JAX package's mesh step:
the ports of ``tests/test_distributed.py``'s training, tensor-parallel,
fleet-API, review-regression and SyncBatchNorm classes.

Each world size (1, 2 and 4 gloo ranks on the CPU) is one spawned world
(``torch_dist_workers.training_world``) that runs every case once, from
the same seeded numpy data and initial parameters as the JAX runs here
(a 4-device mesh of the 8 host devices).  Tolerances:

* data parallelism and ZeRO (= plain dp) after 2 epochs of Momentum:
  evaluate loss rtol 1e-4 (``test_distributed``'s), parameters atol 1e-5
  (a mean over shards sums in another order than a mean over the batch);
* tensor parallelism: the column/row pair and the vocabulary embedding,
  forward and gradients against the dense JAX functions at 1e-5; the
  TP MLP's 4 Adam steps: losses rtol 1e-5, parameters atol 1e-5;
* ``gpt_tiny`` at ``sharding`` 2 x ``model`` 2 against JAX's
  4-device mesh from the same JAX parameters, 2 AdamW steps: losses
  rtol 1e-5, gathered parameters atol 1e-4 — except the key third of
  every ``qkv.bias``, whose gradient is zero in exact arithmetic and
  which Adam moves by up to ``lr`` a step on rounding noise in both
  packages (``test_torch_training.py``): it is held within ``2·lr`` of
  its start;
* SyncBatchNorm: every rank's rows against the global batch's
  statistics (1e-5), its input gradient against ``jax.grad`` of the
  full-batch norm, the running mean against the global mean.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu.distributed as jdist
from paddle_tpu import io as jio, metric as jmetric, nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.mesh import build_mesh as jbuild
from paddle_tpu.distributed.mesh import set_mesh as jset
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.distributed import spawn

import torch_dist_workers as W

LR_GPT = 1e-3


def _data(n=256, d=16, classes=4):
    rng = np.random.RandomState(7)
    Wt = rng.randn(d, classes).astype(np.float32)
    X = rng.randn(n, d).astype(np.float32)
    return X, np.argmax(X @ Wt, 1).astype(np.int64)


def _mlp_params():
    rng = np.random.RandomState(3)
    return {"fc1.weight": (rng.randn(16, 32) * 0.3).astype(np.float32),
            "fc1.bias": (rng.randn(32) * 0.1).astype(np.float32),
            "fc2.weight": (rng.randn(32, 4) * 0.3).astype(np.float32),
            "fc2.bias": (rng.randn(4) * 0.1).astype(np.float32)}


def _gpt_init():
    jpt.seed(0)
    net = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    return {k: np.asarray(p.value) for k, p in net.named_parameters()}


def _gpt_batches():
    rng = np.random.RandomState(5)
    return [rng.randint(0, 128, (4, 16)).astype(np.int32) for _ in range(2)]


def _inputs():
    X, y = _data()
    rng = np.random.RandomState(11)
    bn_x = rng.randn(16, 3, 2, 2).astype(np.float32)
    bn_x += np.arange(16, dtype=np.float32)[:, None, None, None]
    return {"X": X, "y": y, "mlp": _mlp_params(),
            "x4": rng.randn(4, 16).astype(np.float32),
            "w4": rng.randn(4, 4).astype(np.float32),
            "emb": (rng.randn(64, 16) * 0.02).astype(np.float32),
            "gpt": _gpt_init(), "gpt_batches": _gpt_batches(),
            "bn_x": bn_x, "bn_w": rng.randn(16, 3, 2, 2).astype(np.float32)}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


_WORLDS = {}


def _world(n, inputs):
    """The ``n``-rank world's results, spawned once per module."""
    if n not in _WORLDS:
        _WORLDS[n] = spawn(W.training_world, (inputs,), nprocs=n,
                           backend="gloo", timeout=300).results
    return _WORLDS[n]


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}ranks")
def world(request, inputs):
    return request.param, _world(request.param, inputs)


@pytest.fixture(scope="module")
def world4(inputs):
    return _world(4, inputs)


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


class _JMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 32)
        self.act = jnn.ReLU()
        self.fc2 = jnn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _JTPMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        mp = jdist.meta_parallel
        self.fc1 = mp.ColumnParallelLinear(16, 32, gather_output=False)
        self.act = jnn.ReLU()
        self.fc2 = mp.RowParallelLinear(32, 4, input_is_parallel=True)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def _set(net, params):
    net.set_state_dict({k: jnp.asarray(v) for k, v in params.items()})
    return net


def _params(net):
    return {k: np.asarray(p.value) for k, p in net.named_parameters()}


def _jax_fit(strategy):
    X, y = _data()
    net = _set(_JMLP(), _mlp_params())
    opt = jopt.Momentum(learning_rate=0.05)
    jfleet.init(is_collective=True, strategy=strategy,
                devices=jax.devices()[:4])
    opt = jfleet.distributed_optimizer(opt)
    model = jpt.Model(net)
    model.prepare(optimizer=opt, loss=jnn.CrossEntropyLoss(),
                  metrics=[jmetric.Accuracy()])
    ds = jio.TensorDataset([X, y.reshape(-1, 1)])
    model.fit(ds, batch_size=64, epochs=2, verbose=0, shuffle=False)
    logs = model.evaluate(ds, batch_size=64, verbose=0)
    return logs, _params(net)


@pytest.fixture(scope="module")
def jax_dp():
    jset(jbuild())
    out = _jax_fit(jfleet.DistributedStrategy())
    jfleet._initialized = False
    jset(jbuild())
    return out


def _close_params(got, want, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


# -- every world size ------------------------------------------------------------
@pytest.mark.parametrize("case", ["dp", "zero"])
def test_fleet_fit_matches_jax_dp(world, jax_dp, case):
    n, results = world
    logs, params = jax_dp
    for r in range(n):
        got = _ok(results[r][case])
        np.testing.assert_allclose(got["loss"], logs["loss"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(float(got["acc"]), float(logs["acc"]),
                                   rtol=1e-5)
        _close_params(got["params"], params, 1e-5)


def test_zero_shards_optimizer_state(world):
    n, results = world
    for r in range(n):
        got = _ok(results[r]["zero"])
        assert got["mesh"]["sharding"] == n and got["mesh"]["data"] == 1
        for name, shape in got["param_shapes"].items():
            slot = got["slot_shapes"][name]
            # the first dim divisible by n holds 1/n (JAX's _dim_to_shard)
            d = next((i for i, s in enumerate(shape) if s % n == 0), None)
            want = list(shape)
            if d is not None:
                want[d] //= n
            assert slot == want, (name, slot, shape)


def test_fleet_api(world):
    n, results = world
    for r in range(n):
        assert _ok(results[r]["worker_info"]) == [n, r, int(r == 0)]
        kind, msg = _ok(results[r]["ps_rejected"])
        assert kind == "InvalidArgumentError" and "parameter-server" in msg
        kind, msg, none = _ok(results[r]["requires_init"])
        assert "fleet.init" in msg and none


def test_fleet_recompute_wraps_the_blocks_and_keeps_the_steps(world):
    """``strategy.recompute`` (JAX's ``apply_recompute`` in ``prepare``):
    gpt_tiny's 2 blocks wrapped, losses equal to the plan without it."""
    n, results = world
    for r in range(n):
        got = _ok(results[r]["recompute"])
        assert got["wrapped"] == [0, 2]
        np.testing.assert_allclose(got["recompute"], got["plain"], rtol=1e-6)


def test_distributed_batch_sampler_defaults_from_the_world(world):
    n, results = world
    X, _ = _data()
    for r in range(n):
        j = jio.DistributedBatchSampler(jio.TensorDataset([X[:23]]), 4,
                                        num_replicas=n, rank=r, shuffle=True)
        j.set_epoch(1)
        assert _ok(results[r]["sampler"]) == [n, r, list(j)]


# -- 4 ranks ---------------------------------------------------------------------
def _model_index(r):
    return r % 2  # dp 2 x mp 2: model is the inner axis


def test_tp_training_matches_jax(world4):
    X, y = _data()
    strat = jfleet.DistributedStrategy(
        tensor_parallel=True,
        tensor_parallel_configs={"tensor_parallel_degree": 2})
    jfleet.init(is_collective=True, strategy=strat, devices=jax.devices()[:4])
    net = _set(_JTPMLP(), _mlp_params())
    model = jpt.Model(net)
    model.prepare(optimizer=jfleet.distributed_optimizer(
        jopt.Adam(learning_rate=5e-3)), loss=jnn.CrossEntropyLoss())
    losses = [model.train_batch([X[i * 64:(i + 1) * 64]],
                                [y[i * 64:(i + 1) * 64, None]])[0]
              for i in range(4)]
    want = _params(net)
    for r in range(4):
        got = _ok(world4[r]["tp"])
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _close_params(got["params"], want, 1e-5)
        assert got["reprepared_same"]
        assert got["local_shapes"] == {"fc1.weight": [16, 16],
                                       "fc1.bias": [16],
                                       "fc2.weight": [16, 4],
                                       "fc2.bias": [4]}


def test_column_row_pair_matches_dense(world4, inputs):
    p = inputs["mlp"]

    def f(ps, x):
        return (x @ ps["fc1.weight"] + ps["fc1.bias"]) @ ps["fc2.weight"] \
            + ps["fc2.bias"]

    x, w = jnp.asarray(inputs["x4"]), jnp.asarray(inputs["w4"])
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    out = np.asarray(f(jp, x))
    gp, gx = jax.grad(lambda ps, xx: jnp.sum(f(ps, xx) * w),
                      argnums=(0, 1))(jp, x)
    for r in range(4):
        got = _ok(world4[r]["col_row"])
        m = _model_index(r)
        np.testing.assert_allclose(got["out"], out, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["dx"], np.asarray(gx), rtol=1e-5,
                                   atol=1e-5)
        shards = {"fc1.weight": np.asarray(gp["fc1.weight"])[:, m * 16:
                                                                (m + 1) * 16],
                  "fc1.bias": np.asarray(gp["fc1.bias"])[m * 16:(m + 1) * 16],
                  "fc2.weight": np.asarray(gp["fc2.weight"])[m * 16:
                                                             (m + 1) * 16],
                  "fc2.bias": np.asarray(gp["fc2.bias"])}
        for k, v in shards.items():
            np.testing.assert_allclose(got["grads"][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            # the defer_row_reduce dial moves the reduce, not the values
            np.testing.assert_allclose(got["deferred_grads"][k], v,
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["deferred_out"], out, rtol=1e-5,
                                   atol=1e-5)


def test_vocab_parallel_embedding(world4, inputs):
    table = inputs["emb"]
    ids = np.array([[1, 5], [63, 0], [32, 31]])
    counts = np.zeros(64, np.float32)
    np.add.at(counts, ids.ravel(), 1.0)
    for r in range(4):
        got = _ok(world4[r]["vocab"])
        m = _model_index(r)
        np.testing.assert_allclose(got["out"], table[ids], rtol=1e-6)
        assert got["rows"] == [32, 16]
        np.testing.assert_allclose(
            got["grad"], np.repeat(counts[m * 32:(m + 1) * 32, None], 16, 1))


def test_gpt_tiny_sharding_x_model_matches_jax(world4, inputs):
    jfleet.init(is_collective=True, strategy=jfleet.DistributedStrategy(
        sharding_degree=2, mp_degree=2), devices=jax.devices()[:4])
    net = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    _set(net, inputs["gpt"])
    model = jpt.Model(net)
    model.prepare(optimizer=jfleet.distributed_optimizer(jopt.AdamW(
        learning_rate=LR_GPT, weight_decay=0.01)), loss=net.loss)
    losses = [model.train_batch([ids], [ids])[0]
              for ids in inputs["gpt_batches"]]
    want = _params(net)
    init = inputs["gpt"]
    for r in range(4):
        got = _ok(world4[r]["gpt_hybrid"])
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, v in want.items():
            g = got["params"][k]
            if k.endswith("attn.qkv.bias"):
                d = v.shape[0] // 3
                key = slice(d, 2 * d)
                np.testing.assert_allclose(g[key], init[k][key], rtol=0,
                                           atol=2 * LR_GPT, err_msg=k)
                g, v = np.delete(g, np.s_[d:2 * d]), np.delete(v, np.s_[
                    d:2 * d])
            np.testing.assert_allclose(g, v, rtol=0, atol=1e-4, err_msg=k)
        # the TP weights hold out/2 columns (3 fused blocks of 16), the
        # table half the vocabulary, the ZeRO slots half of the TP shard
        assert got["qkv_local"] == [32, 48]
        assert got["wte_local"] == [64, 32]
        assert got["slot_qkv"] == [16, 48]


def test_review_regressions(world4):
    for r in range(4):
        got = _ok(world4[r]["regressions"])
        assert got["partial_dropped_warns"] == 1
        assert "divisible" in got["indivisible"]
        assert got["eval_keys"] == ["acc", "loss"]
        assert got["zero_batches_warns"] == 1
        assert got["predict_rows"] == 100
        assert got["spe"][0] == "InvalidArgumentError"
        assert "does not yet compose with fleet strategies" in got["spe"][1]
        assert got["dp_sharding_mesh"] == [2, 2]
        assert "exceed" in got["oversubscribed"]
        for what, (kind, msg) in got["unported"].items():
            assert kind == "UnimplementedError", what
            assert "distributed execution" in msg, what
        assert sorted(got["unported"]) == ["lamb_mp2", "lora_mp2"]
        assert got["built"]["localsgd"] == "Momentum"
        assert got["built"]["dgc"] == "DGCMomentum"
        assert got["built"]["fp16_allreduce"] == "Momentum"
        assert got["built"]["{'pp_degree': 2}"]["pipe"] == 2
        assert got["built"]["{'ep_degree': 2}"]["expert"] == 2


def test_predict_returns_all_samples_under_plan(world4):
    """``predict`` under the plan pads the last batch and slices it off:
    every rank returns the 100 rows JAX's plan returns, after the same
    ``fit`` (its partial batch dropped: one SGD step)."""
    X, y = _data()
    jfleet.init(is_collective=True, strategy=jfleet.DistributedStrategy(),
                devices=jax.devices()[:4])
    model = jpt.Model(_set(_JMLP(), _mlp_params()))
    model.prepare(optimizer=jfleet.distributed_optimizer(
        jopt.SGD(learning_rate=0.01)), loss=jnn.CrossEntropyLoss())
    with pytest.warns(RuntimeWarning, match="partial batch"):
        model.fit(jio.TensorDataset([X[:100], y[:100].reshape(-1, 1)]),
                  batch_size=64, epochs=1, verbose=0, shuffle=False)
    want = np.asarray(model.predict(jio.TensorDataset([X[:100]]),
                                    batch_size=64, stack_outputs=True))
    assert want.shape == (100, 4)
    for r in range(4):
        np.testing.assert_allclose(
            _ok(world4[r]["regressions"])["predict"], want, rtol=1e-5,
            atol=1e-5)


def _bn_oracle(x):
    m = x.mean(axis=(0, 2, 3))
    v = x.var(axis=(0, 2, 3))
    return (x - m[None, :, None, None]) / np.sqrt(
        v[None, :, None, None] + 1e-5)


def test_sync_batch_norm_uses_global_statistics(world4, inputs):
    x, w = inputs["bn_x"], inputs["bn_w"]
    want = _bn_oracle(x)

    def f(xx):
        m = xx.mean(axis=(0, 2, 3))
        v = ((xx - m[None, :, None, None]) ** 2).mean(axis=(0, 2, 3))
        y = (xx - m[None, :, None, None]) / jnp.sqrt(
            v[None, :, None, None] + 1e-5)
        return jnp.sum(y * w)

    dx = np.asarray(jax.grad(f)(jnp.asarray(x)))
    for r in range(4):
        got = _ok(world4[r]["sync_bn"])
        rows = slice(r * 4, (r + 1) * 4)
        np.testing.assert_allclose(got["y"], want[rows], rtol=1e-4,
                                   atol=1e-4)
        assert not np.allclose(got["local"], want[rows], atol=1e-2)
        np.testing.assert_allclose(got["dx"], dx[rows], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got["running_mean"],
                                   0.1 * x.mean(axis=(0, 2, 3)), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["plan_mean"],
                                   0.1 * x.mean(axis=(0, 2, 3)), rtol=1e-5,
                                   atol=1e-5)


def test_data_parallel_wrapper_averages_gradients(world4, inputs):
    X, y = _data()
    p = {k: jnp.asarray(v) for k, v in inputs["mlp"].items()}

    def loss(ps):
        h = jax.nn.relu(X[:64] @ ps["fc1.weight"] + ps["fc1.bias"])
        logits = h @ ps["fc2.weight"] + ps["fc2.bias"]
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(lp[jnp.arange(64), y[:64]])

    g = jax.grad(loss)(p)
    for r in range(4):
        got = _ok(world4[r]["data_parallel"])
        for k in p:
            np.testing.assert_allclose(got[k], np.asarray(g[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n", [2, 4], ids=lambda n: f"{n}ranks")
def test_each_rank_draws_its_own_dropout_masks(inputs, n):
    """ROADMAP §C's fault, fixed: under a dp 2 plan (2 ranks) and a dp 2 x
    mp 2 plan (4 ranks) at dropout 0.5 the masks differ between data
    ranks and between local heads, are equal across model ranks on the
    replicated activations (the embedding's and the MLP's), the keep
    fraction over the global batch is 0.5 within 4 binomial standard
    deviations, and seeding before or after ``fleet.init`` gives the same
    streams."""
    results = _world(n, inputs)
    got = [_ok(results[r]["dropout_masks"]) for r in range(n)]
    for g in got:
        for k in ("embedding", "probs", "mlp"):
            np.testing.assert_array_equal(g["before"][k], g["after"][k])
    by_data = {}
    for g in got:
        by_data.setdefault(g["data"], []).append(g)
    assert sorted(by_data) == [0, 1]
    for k in ("embedding", "mlp", "probs"):
        assert not np.array_equal(by_data[0][0]["after"][k],
                                  by_data[1][0]["after"][k]), k
    for group in by_data.values():
        for g in group[1:]:  # model ranks of one data coordinate
            for k in ("embedding", "mlp"):
                np.testing.assert_array_equal(g["after"][k],
                                              group[0]["after"][k])
            # their heads are other heads: other masks
            assert not np.array_equal(g["after"]["probs"],
                                      group[0]["after"]["probs"])
    for g in got:  # the local heads of one rank differ
        probs = g["after"]["probs"]
        assert not np.array_equal(probs[:, 0], probs[:, 1])
    keep = np.concatenate([by_data[d][0]["after"]["embedding"].ravel()
                           for d in (0, 1)]).astype(np.float64)
    bound = 4 * np.sqrt(0.25 / keep.size)
    assert abs(keep.mean() - 0.5) <= bound, (keep.mean(), bound)


@pytest.mark.parametrize("n", [2, 4], ids=lambda n: f"{n}ranks")
def test_fleet_init_keeps_the_cpu_generator_in_step(inputs, n):
    """New mesh coordinates reseed a rank's device streams, never the CPU
    generator of initialization and samplers: after a CPU draw between
    ``seed`` and ``fleet.init``, a ``RandomSampler`` gives the same order
    on every rank under a mesh that moves all ranks but rank 0 (sep = the
    world) and under one that moves them back (data = the world)."""
    results = _world(n, inputs)
    got = [_ok(results[r]["cpu_stream"]) for r in range(n)]
    for g in got[1:]:
        assert g == got[0], (g, got[0])
    assert got[0][0] != got[0][1]  # the sampler drew anew under the second
