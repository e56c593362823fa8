"""The port's collectives, mesh and environment against the JAX package's.

The JAX collectives take a stacked array whose leading dimension is the
mesh axis; the port runs one process per rank.  One 4-rank gloo world
(``paddle_tpu_torch.distributed.spawn``, the rank programs in
``torch_dist_workers.py``) runs every case once; rank ``i`` gets slot
``i`` of the same seeded numpy input and must return slot ``i`` of what
JAX returns on a 4-device mesh of the 8 host devices ``conftest.py``
sets up (exact for float32 sums of 4 terms at rtol 1e-6).  The mesh,
``validate_env`` and the overlap dials are compared in this process.
Two more worlds fail on purpose: a rank that raises and a rank that
hangs must make ``spawn`` raise within its deadline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed.mesh import build_mesh as jbuild
from paddle_tpu.distributed.mesh import set_mesh as jset
from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.framework.errors import ExecutionTimeoutError

import torch_dist_workers as W

N = 4
RTOL = 1e-6


def _inputs():
    rng = np.random.RandomState(0)
    return {"a": rng.randn(N, 3, 2).astype(np.float32),
            "b": rng.randn(N, 3, 2).astype(np.float32),
            "c": rng.randn(N, 8, 4).astype(np.float32),
            "m": rng.randn(N, N, 3).astype(np.float32),
            "pair": rng.randn(2, 5).astype(np.float32)}


@pytest.fixture(scope="module")
def world():
    ctx = spawn(W.collectives_world, (_inputs(),), nprocs=N,
                backend="gloo", timeout=240)
    return ctx.results


@pytest.fixture
def jmesh():
    mesh = jset(jbuild(devices=jax.devices()[:N]))
    yield mesh
    jset(jbuild())


def _smap(fn, mesh, x):
    return np.asarray(jcoll.shard_map(fn, mesh, P("data"), P("data"))(
        jnp.asarray(x)))


def _jax_slots(case, mesh):
    """JAX's stacked result of ``case`` (leading dim = rank)."""
    x = _inputs()
    a = jnp.asarray(x["a"])
    if case == "all_reduce_sum":
        return np.asarray(jdist.all_reduce(a))
    if case in ("all_reduce_max", "all_reduce_min", "all_reduce_prod"):
        return np.asarray(jdist.all_reduce(a, op=case.split("_")[-1]))
    if case in ("all_gather", "all_gather_into_list"):
        g = np.stack([np.asarray(t) for t in jdist.all_gather(a)])
        return np.stack([g] * N)
    if case == "reduce":
        return np.asarray(jdist.reduce(a, dst=1))
    if case == "broadcast":
        return np.asarray(jdist.broadcast(a, src=2))
    if case == "scatter":
        return np.asarray(jdist.scatter(a, tensor_list=list(x["a"])))
    if case == "alltoall":
        return np.stack([np.asarray(t) for t in jdist.alltoall(
            jnp.asarray(x["m"]))])
    if case == "barrier":
        jdist.barrier()
        return np.zeros(N)
    if case in ("psum", "pmean", "pmax", "pmin"):
        f = getattr(lax, case)
        return _smap(lambda t: f(t, "data"), mesh, x["a"])
    if case == "ppermute_ring":
        return _smap(lambda t: lax.ppermute(
            t, "data", [(j, (j + 1) % N) for j in range(N)]), mesh, x["a"])
    if case == "ppermute_partial":
        return _smap(lambda t: lax.ppermute(t, "data", [(0, 2), (2, 1)]),
                     mesh, x["a"])
    if case in ("all_to_all_0_1", "all_to_all_1_0"):
        s, c = (0, 1) if case.endswith("0_1") else (1, 0)
        flat = x["c"].reshape(N * 8, 4)
        out = _smap(lambda t: jcoll.all_to_all_single(
            t, "data", split_axis=s, concat_axis=c), mesh, flat)
        return out.reshape(N, -1, out.shape[-1])
    if case == "bf16_all_reduce":
        out = jdist.all_reduce(a.astype(jnp.bfloat16))
        return np.asarray(out.astype(jnp.float32))
    if case == "start_finish":
        return _smap(lambda t: jcoll.all_reduce_finish(
            jcoll.all_reduce_start(t, "data")), mesh, x["a"])
    if case == "grad_psum":
        # the gradient of the ranks' summed losses sum_r <psum(a), b_r>
        return np.stack([x["b"].sum(0)] * N)
    if case == "grad_all_to_all":
        flat = jnp.asarray(x["c"].reshape(N * 8, 4))

        def loss(t):
            out = jcoll.shard_map(lambda u: jcoll.all_to_all_single(
                u, "data", split_axis=0, concat_axis=1), mesh, P("data"),
                P("data"))(t).reshape(N, 2, 16)
            w = jnp.arange(32, dtype=jnp.float32).reshape(2, 16)
            return jnp.sum(out * w[None])

        return np.asarray(jax.grad(loss)(flat)).reshape(N, 8, 4)
    raise KeyError(case)


SLOT_CASES = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
              "all_reduce_prod", "all_gather", "all_gather_into_list",
              "reduce", "broadcast", "scatter", "alltoall", "barrier",
              "psum", "pmean", "pmax", "pmin", "ppermute_ring",
              "ppermute_partial", "all_to_all_0_1", "all_to_all_1_0",
              "bf16_all_reduce", "start_finish", "grad_psum",
              "grad_all_to_all"]


def _ok(res):
    assert not (isinstance(res, dict) and "error" in res), res.get("error")
    return res


@pytest.mark.parametrize("case", SLOT_CASES)
def test_each_rank_holds_its_jax_slot(world, jmesh, case):
    want = _jax_slots(case, jmesh)
    for r in range(N):
        got = _ok(world[r][case])
        np.testing.assert_allclose(np.asarray(got, np.float32), want[r],
                                   rtol=RTOL, atol=1e-6,
                                   err_msg=f"{case} rank {r}")


@pytest.mark.parametrize("axis", ["model", "data"])
def test_group_axis_on_hybrid_mesh(world, axis):
    x = _inputs()["pair"]
    jset(jbuild(dp=2, mp=2, devices=jax.devices()[:N]))
    try:
        want = np.asarray(jdist.all_reduce(jnp.asarray(x), group=axis))
    finally:
        jset(jbuild())
    layout = tmesh.build_mesh(dp=2, mp=2, devices=list(range(N)))
    for r in range(N):
        slot = layout.coords(r)[axis]
        np.testing.assert_allclose(_ok(world[r][f"group_{axis}"]),
                                   want[slot], rtol=RTOL)


def test_env_and_stats(world):
    for r in range(N):
        assert _ok(world[r]["env"]) == [r, N, r, N, 1]
        # CPU tensors on gloo: counted, never staged
        assert _ok(world[r]["stats"]) == {"all_gather": [1, 0],
                                          "all_reduce": [1, 0]}


@pytest.mark.parametrize("kw", [dict(), dict(mp=2), dict(dp=2, mp=2, sharding=2),
                                dict(sep=2, mp=2), dict(pp=2, sep=2),
                                dict(dp=1, sharding=4, mp=2)])
def test_build_mesh_layout_matches_jax(kw):
    devs = jax.devices()[:8]
    jm = jbuild(devices=devs, **kw)
    tm = tmesh.build_mesh(devices=list(range(8)), **kw)
    assert dict(tm.shape) == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names) == tmesh.AXIS_ORDER
    np.testing.assert_array_equal(
        tm.devices, np.vectorize(lambda d: d.id)(np.asarray(jm.devices)))
    from paddle_tpu.distributed.mesh import data_axes as jdata_axes

    assert tmesh.data_axes(tm) == jdata_axes(jm)
    for a in tm.axis_names:
        assert tmesh.mesh_axis_size(a, tm) == jm.shape[a]


@pytest.mark.parametrize("kw", [dict(mp=3), dict(dp=3, mp=2), dict(mp=0)])
def test_build_mesh_errors_match_jax(kw):
    with pytest.raises(Exception) as je:
        jbuild(devices=jax.devices()[:8], **kw)
    with pytest.raises(Exception) as te:
        tmesh.build_mesh(devices=list(range(8)), **kw)
    assert str(te.value) == str(je.value)


ENV_CASES = [
    {"PADDLE_TRAINERS_NUM": "2", "PADDLE_TRAINER_ID": "2",
     "COORDINATOR_ADDRESS": "h:1"},
    {"PADDLE_TRAINERS_NUM": "x"},
    {"PADDLE_TRAINERS_NUM": "0"},
    {"PADDLE_TRAINERS_NUM": "3", "PADDLE_TRAINER_ENDPOINTS": "a:1,b:2"},
    {"PADDLE_TRAINER_ENDPOINTS": "a:1,a:1"},
    {"COORDINATOR_ADDRESS": "nohost"},
    {"PADDLE_TPU_GANG_TRANSPORT": "bogus"},
    {"PADDLE_TRAINERS_NUM": "2"},
    {"PADDLE_TRAINERS_NUM": "2", "PADDLE_TPU_GANG_TRANSPORT": "file"},
    {"PADDLE_TRAINERS_NUM": "2", "PADDLE_TRAINER_ENDPOINTS": "a:1,b:2",
     "PADDLE_TRAINER_ID": "1"},
]
_ENV_KEYS = ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "COORDINATOR_ADDRESS",
             "PADDLE_TRAINER_ENDPOINTS", "PADDLE_TPU_GANG_TRANSPORT",
             "PADDLE_TPU_GANG_DIR")


@pytest.mark.parametrize("env", ENV_CASES)
def test_validate_env_matches_jax(monkeypatch, env):
    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def run(mod):
        try:
            return ("ok", mod.validate_env())
        except Exception as e:  # noqa: BLE001
            return (type(e).__name__, str(e))

    assert run(tenv) == run(jenv)


def test_overlap_schedule_api_matches_jax():
    for mod in (jcoll, tcoll):
        assert mod.get_overlap_schedule() == {"defer_row_reduce": 0,
                                              "mlp_collective_split": 0}
        prev = mod.set_overlap_schedule(defer_row_reduce=1)
        assert prev["defer_row_reduce"] == 0
        with mod.overlap_schedule(mlp_collective_split=1) as cur:
            assert cur == {"defer_row_reduce": 1, "mlp_collective_split": 1}
        assert mod.get_overlap_schedule()["mlp_collective_split"] == 0
        mod.set_overlap_schedule(prev)
        with pytest.raises(Exception, match="unknown overlap dial"):
            mod.set_overlap_schedule(bogus=1)


@pytest.mark.parametrize("mode", ["raise", "hang"])
def test_spawn_never_hangs(mode, monkeypatch):
    # a dead rank stops the world at once; a stuck one at the deadline
    # (the group's own timeout is longer, so spawn's deadline acts)
    monkeypatch.setenv("PADDLE_TPU_INIT_TIMEOUT_S", "120")
    import time

    t0 = time.monotonic()
    err = RuntimeError if mode == "raise" else ExecutionTimeoutError
    with pytest.raises(err) as e:
        spawn(W.hang_world, (mode,), nprocs=2, backend="gloo",
              timeout=20 if mode == "hang" else 60)
    assert time.monotonic() - t0 < 60
    if mode == "raise":
        assert "rank 1 fails on purpose" in str(e.value)


def test_launch_starts_ranks_and_rejects_supervisor_flags(tmp_path, capsys):
    """``python -m paddle_tpu_torch.distributed.launch`` (JAX's
    ``test_launch_module_exists``): N ranks of a script through spawn;
    the supervisor's flags (item 7) and a missing script are refused with
    the usage, as the JAX launcher refuses bad flags."""
    import importlib

    launch = importlib.import_module("paddle_tpu_torch.distributed.launch")
    script = tmp_path / "train.py"
    script.write_text(
        "import sys\n"
        "import paddle_tpu_torch.distributed as dist\n"
        "from paddle_tpu_torch.distributed import mesh\n"
        "dist.barrier(group=mesh.build_mesh().group('data'))\n"
        "open(sys.argv[1] + '/' + str(dist.get_rank()), 'w').write(\n"
        "    str(dist.get_world_size()))\n")
    assert launch.launch(["--nproc_per_node", "2", "--backend=gloo",
                          "--timeout", "120", str(script),
                          str(tmp_path)]) == 0
    assert [(tmp_path / str(r)).read_text() for r in range(2)] == ["2", "2"]
    assert launch.launch(["--max-restarts=2", str(script)]) == 2
    assert "control plane and operations" in capsys.readouterr().out
    assert launch.launch([]) == 1
