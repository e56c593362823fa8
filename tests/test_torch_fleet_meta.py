"""The port's fleet meta-optimizer plans against the JAX package's:
fp16_allreduce, LocalSGD, adaptive LocalSGD, Geo-SGD and DGC
(``distributed/fleet/{fp16_allreduce,localsgd,geosgd,dgc}.py``,
``optimizer/dgc.py``), the sparse all-reduce (``all_gather_rows``) and
its composition with fp16_allreduce / DGC
(``tests/test_sparse_embedding.py``'s ``TestSparseCompressionComposition``).

One spawned world of 2 gloo ranks (``torch_dist_workers.meta_world``) =
the data axis of JAX's 2-device mesh.  Each plan runs the dryrun's
regression net (``Linear(8, 16)``, ReLU, ``Linear(16, 1)``, MSE) for 4
``train_batch`` steps from the JAX init; after every step each rank's
replica and slots are held to its slot of JAX's stacked ``[2, ...]``
state, and the visible parameters to JAX's.  Tolerances: rtol 1e-5 /
atol 1e-6 for the float32 plans (the same arithmetic in another
summation order);
fp16_allreduce 1e-3 of the gradient's fp16 rounding (both packages sum
float16 on the wire, gloo and XLA in their own order); DGC's top-k picks
the same entries (JAX's tie order, held on ties below), so its state is
held at the float32 tolerance too.  A local step's loss is this rank's (the port's local
step makes no collective); a sync step's is the replicas' mean, JAX's.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.mesh import build_mesh as jbuild
from paddle_tpu.distributed.mesh import set_mesh as jset
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.optimizer.dgc import DGCMomentum, topk_indices

import torch
import torch_dist_workers as W

N = 2
STEPS = 4
CASES = {
    "fp16": (dict(fp16_allreduce=True), "sgd", STEPS),
    "localsgd": (dict(localsgd=True, localsgd_configs={
        "k_steps": 2, "begin_step": 2}), "momentum", STEPS),
    "adaptive": (dict(adaptive_localsgd=True, adaptive_localsgd_configs={
        "init_k_steps": 2, "begin_step": 1}), "sgd", STEPS),
    "geo": (dict(a_sync=True, a_sync_configs={"k_steps": 2}), "sgd",
            STEPS),
    "dgc": (dict(dgc=True, dgc_configs={"rampup_begin_step": 1,
                                        "sparsity": [0.75]}),
            "momentum", STEPS),
    "dgc_ramp": (dict(dgc=True, dgc_configs={
        "rampup_begin_step": 1, "rampup_step": 2,
        "sparsity": [0.5, 0.9]}), "momentum", STEPS),
}
# the sparse compositions: (strategy, optimizer, steps, sparse flag)
SPARSE = {
    "sparse_fp16": (dict(fp16_allreduce=True), "sgd", 3, True),
    "dense_fp16": (dict(fp16_allreduce=True), "sgd", 3, False),
    "sparse_dgc_warmup": (dict(dgc=True, dgc_configs={
        "rampup_begin_step": 100}), "momentum", 3, True),
    "sparse_plain": ({}, "momentum", 3, True),
    "sparse_dgc_phase": (dict(dgc=True, dgc_configs={
        "rampup_begin_step": 0, "sparsity": [0.5]}), "momentum", 6, True),
}


def _jreg():
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 1))


class _JSparse(jnn.Layer):
    def __init__(self, sparse):
        super().__init__()
        self.emb = jnn.Embedding(200, 8, sparse=sparse)
        self.fc = jnn.Linear(8, 1)

    def forward(self, ids):
        return self.fc(self.emb(ids).mean(axis=1))


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _inputs():
    jpt.seed(0)
    reg = {k: np.asarray(p.value) for k, p in _jreg().named_parameters()}
    jpt.seed(0)
    sp = {k: np.asarray(p.value)
          for k, p in _JSparse(True).named_parameters()}
    rng = np.random.RandomState(3)
    srng = np.random.RandomState(0)
    return {"reg": reg, "sparse_init": sp,
            "x": rng.randn(4 * N, 8).astype(np.float32),
            "y": rng.randn(4 * N, 1).astype(np.float32),
            "ids": srng.randint(0, 50, (16, 3)).astype(np.int32),
            "ys": srng.randn(16, 1).astype(np.float32),
            "cases": {**CASES, **SPARSE}}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs):
    return spawn(W.meta_world, (inputs,), nprocs=N, backend="gloo",
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


def _jopt(kind):
    if kind == "sgd":
        return jopt.SGD(learning_rate=0.05)
    return jopt.Momentum(learning_rate=0.05, momentum=0.9)


def _jax_trace(inputs, kw, kind, steps, sparse=None):
    jfleet._initialized = False
    jfleet.init(is_collective=True, strategy=jfleet.DistributedStrategy(
        **kw), devices=jax.devices()[:N])
    if sparse is None:
        net, init = _jreg(), inputs["reg"]
        batch, lbl = inputs["x"], inputs["y"]
    else:
        net, init = _JSparse(sparse), inputs["sparse_init"]
        batch, lbl = inputs["ids"], inputs["ys"]
    net.set_state_dict({k: jnp.asarray(v) for k, v in init.items()})
    model = jpt.Model(net, inputs=["x"], labels=["y"])
    model.prepare(optimizer=jfleet.distributed_optimizer(_jopt(kind)),
                  loss=_mse)
    rows = []
    for _ in range(steps):
        loss, _ = model.train_batch([batch], [lbl])
        st = model._opt_state
        rec = {"loss": float(loss),
               "params": {k: np.asarray(p.value)
                          for k, p in net.named_parameters()}}
        if "local" in st:
            rec["local"] = {k: np.asarray(v)
                            for k, v in st["local"]["params"].items()}
            rec["inner"] = {k: {s: np.asarray(t) for s, t in v.items()}
                            for k, v in st["local"]["inner"].get(
                                "slots", {}).items()}
            if "snapshot" in st["local"]:
                rec["snapshot"] = {k: np.asarray(v) for k, v in
                                   st["local"]["snapshot"].items()}
        if "u" in st:
            for s in ("velocity", "u", "v"):
                rec[s] = {k: np.asarray(v) for k, v in st[s].items()}
        if hasattr(model._plan, "k_steps"):
            rec["k"] = model._plan.k_steps
        rows.append(rec)
    jfleet._initialized = False
    jset(jbuild())
    return rows


def _held(got, want, r, atol, stacked=()):
    rtol = 1e-5 if atol < 1e-4 else atol
    for key in ("params",) + tuple(stacked):
        if key not in want:
            continue
        for k, v in want[key].items():
            if key == "inner":
                for s, t in v.items():
                    np.testing.assert_allclose(got[key][k][s], t[r], rtol=rtol,
                                               atol=atol, err_msg=(k, s))
                continue
            w = v[r] if key != "params" and key != "velocity" else v
            np.testing.assert_allclose(got[key][k], w, rtol=rtol, atol=atol,
                                       err_msg=(key, k))


@pytest.mark.parametrize("case", list(CASES))
def test_plan_states_match_jax_step_by_step(world, inputs, case):
    kw, kind, steps = CASES[case]
    want = _jax_trace(inputs, kw, kind, steps)
    atol = 1e-3 if case == "fp16" else 1e-6
    stacked = ("local", "inner", "snapshot", "u", "v", "velocity")
    for r in range(N):
        got = _ok(world[r][case])
        assert len(got) == steps
        for t in range(steps):
            _held(got[t], want[t], r, atol, stacked)
            if "k" in want[t]:
                assert got[t]["k"] == want[t]["k"]
            synced = case in ("fp16", "dgc", "dgc_ramp", "adaptive") or \
                got[t]["calls"].get("all_reduce", 0) > 0
            if synced:
                np.testing.assert_allclose(got[t]["loss"], want[t]["loss"],
                                           rtol=1e-5)


def test_localsgd_local_step_makes_no_collective_then_averages(world):
    for r in range(N):
        got = _ok(world[r]["localsgd"])
        # begin_step 2: step 1 syncs (k 2: steps 1, 3), steps 2, 4 local
        assert got[1]["calls"] == {} and got[3]["calls"] == {}
        assert got[2]["calls"] == {"all_reduce": 1}
        for k, v in got[2]["local"].items():
            np.testing.assert_array_equal(v, got[2]["params"][k])
    a, b = _ok(world[0]["localsgd"]), _ok(world[1]["localsgd"])
    k = next(iter(a[1]["local"]))
    assert not np.allclose(a[1]["local"][k], b[1]["local"][k])


def test_adaptive_k_stays_in_bounds(world):
    for r in range(N):
        ks = [row["k"] for row in _ok(world[r]["adaptive"])]
        assert all(1 <= k <= 16 for k in ks), ks


def test_geo_replicas_keep_their_drift_after_a_sync(world):
    a, b = _ok(world[0]["geo"]), _ok(world[1]["geo"])
    k = next(iter(a[1]["local"]))
    # step 2 syncs: the replicas merged the mean delta, not reset
    assert not np.allclose(a[1]["local"][k], b[1]["local"][k])
    for row in (a[1], b[1]):
        for name, v in row["local"].items():
            np.testing.assert_array_equal(v, row["snapshot"][name])


def test_dgc_accumulators_are_per_rank_and_finite(world):
    a, b = _ok(world[0]["dgc"]), _ok(world[1]["dgc"])
    k = next(iter(a[-1]["v"]))
    assert not np.allclose(a[-1]["v"][k], b[-1]["v"][k])
    for row in a + b:
        assert np.isfinite(row["loss"])
    for k2 in a[-1]["params"]:
        np.testing.assert_array_equal(a[-1]["params"][k2],
                                      b[-1]["params"][k2])


def test_dgc_sparsity_schedule_as_jax():
    from paddle_tpu.optimizer.dgc import DGCMomentum as JDGC

    for kw in (dict(rampup_begin_step=1, rampup_step=2,
                    sparsity=[0.5, 0.9]),
               dict(rampup_begin_step=0, rampup_step=6,
                    sparsity=[0.75, 0.9, 0.99]),
               dict(rampup_begin_step=3)):
        t_opt, j_opt = DGCMomentum(0.1, **kw), JDGC(0.1, **kw)
        assert [t_opt.sparsity_at(t) for t in range(1, 12)] == \
            [j_opt.sparsity_at(t) for t in range(1, 12)]


def test_dgc_top_k_breaks_ties_as_lax_top_k():
    v = np.array([3.0, -1.0, 1.0, -3.0, 2.0, 1.0, -2.0, 3.0, 0.0, 1.0],
                 np.float32)
    for k in (1, 2, 3, 4, 6, 10):
        want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(v)), k)[1])
        got = topk_indices(torch.from_numpy(v), k).numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(Exception, match="only runs through Model.prepare"):
        DGCMomentum(0.1).step()


def test_all_gather_rows_joins_every_rank_in_rank_order(world):
    ids = [np.arange(3 + r) * (r + 1) for r in range(N)]
    vals = [np.arange((3 + r) * 2, dtype=np.float32).reshape(-1, 2) + r
            for r in range(N)]
    k = max(len(i) for i in ids)
    pad_ids = np.concatenate([np.concatenate([i, np.full(k - len(i), 10)])
                              for i in ids])
    dense = np.zeros((10, 2), np.float32)
    for i, v in zip(ids, vals):
        np.add.at(dense, i, 0.5 * v)
    for r in range(N):
        got = _ok(world[r]["gather_rows"])
        np.testing.assert_array_equal(got["ids"], pad_ids)
        np.testing.assert_allclose(got["merged"], dense, rtol=1e-6)
        wire = np.concatenate([np.concatenate(
            [(v / 3).astype(np.float16).astype(np.float32),
             np.zeros((k - len(v), 2), np.float32)]) for v in vals])
        np.testing.assert_array_equal(got["wire"], wire)


def test_strategies_build_their_plans_and_refuse_as_jax(world):
    for r in range(N):
        got = _ok(world[r]["builds"])
        assert got["localsgd"] == ["Momentum", "LocalSGDPlan"]
        assert got["adaptive_localsgd"] == ["Momentum",
                                            "AdaptiveLocalSGDPlan"]
        assert got["a_sync"] == ["Momentum", "GeoSgdPlan"]
        assert got["dgc"] == ["DGCMomentum", "DGCPlan"]
        assert got["fp16_allreduce"] == ["Momentum", "Fp16AllReducePlan"]
        assert got["['dgc', 'lamb']"][0] == "InvalidArgumentError"
        assert got["['a_sync']"][0] == "UnimplementedError"
        assert "k_steps=0" in got["['a_sync']"][1]
        assert "ONE of" in got["['adaptive_localsgd', 'localsgd']"][1]
        assert "gradient_merge" in got["['gradient_merge', 'localsgd']"][1]
        assert "Momentum optimizer" in got["dgc_adam"][1]


@pytest.mark.parametrize("case", list(SPARSE))
def test_sparse_compositions_match_jax(world, inputs, case):
    kw, kind, steps, sparse = SPARSE[case]
    want = _jax_trace(inputs, kw, kind, steps, sparse=sparse)
    tol = dict(rtol=2e-3, atol=2e-3) if "fp16" in case else \
        dict(rtol=1e-5, atol=1e-6)
    touched = np.unique(inputs["ids"])
    untouched = np.setdiff1d(np.arange(200), touched)
    w0 = inputs["sparse_init"]["emb.weight"]
    for r in range(N):
        got = _ok(world[r][case])
        np.testing.assert_allclose([g["loss"] for g in got],
                                   [w["loss"] for w in want], **tol)
        for k, v in want[-1]["params"].items():
            np.testing.assert_allclose(got[-1]["params"][k], v, **tol,
                                       err_msg=k)
        if sparse:
            np.testing.assert_array_equal(
                got[-1]["params"]["emb.weight"][untouched], w0[untouched])


def test_sparse_fp16_matches_dense_and_dgc_warmup_matches_plain(world):
    for r in range(N):
        s, d = _ok(world[r]["sparse_fp16"]), _ok(world[r]["dense_fp16"])
        np.testing.assert_allclose([x["loss"] for x in s],
                                   [x["loss"] for x in d], rtol=2e-3,
                                   atol=2e-3)
        g, p = _ok(world[r]["sparse_dgc_warmup"]), _ok(
            world[r]["sparse_plain"])
        np.testing.assert_allclose([x["loss"] for x in g],
                                   [x["loss"] for x in p], rtol=1e-5,
                                   atol=1e-6)
        ph = _ok(world[r]["sparse_dgc_phase"])
        assert ph[-1]["loss"] < ph[0]["loss"]
