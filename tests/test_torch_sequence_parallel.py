"""Ring attention and Ulysses of the port against the JAX package's.

One spawned gloo world of 2 ranks (``sep`` 2, rank programs in
``torch_dist_workers.sequence_world``) runs every case once.  The JAX side runs ``ring_attention_sharded`` /
``ulysses_attention_sharded`` on a ``sep`` mesh of as many host devices
(its Pallas kernels in interpret mode); the port's flash entries take
their plain versions on the CPU.  Forward outputs and the gradients of
``sum(out * do)`` at rtol / atol 1e-5 (float32).  ``gpt_tiny`` with
``sequence_parallel="ring"`` / ``"ulysses"`` (and the fleet toggle)
against JAX's mesh step from the same JAX parameters: ``predict_batch``
logits at 1e-5, two Adam steps' losses rtol 1e-5 and parameters atol
1e-4 — the key third of every ``qkv.bias`` within ``2·lr`` of its start,
as in ``test_torch_distributed_training.py``.  The ring's schedule (which
chunks a rank attends) is JAX's: the kernel launch count of a rank.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu.distributed as jdist
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.mesh import build_mesh as jbuild
from paddle_tpu.distributed.mesh import set_mesh as jset
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.distributed import spawn

import torch_dist_workers as W

LR = 1e-3
N = 2  # the ring: sep 2


def _inputs():
    rng = np.random.RandomState(0)
    shape = (2, 4, 16, 8)
    out = {n: rng.randn(*shape).astype(np.float32) for n in "qkv"}
    out["do"] = rng.randn(*shape).astype(np.float32)
    jpt.seed(1)
    net = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    out["gpt"] = {k: np.asarray(p.value) for k, p in net.named_parameters()}
    out["gpt_batches"] = [rng.randint(0, 128, (4, 16)).astype(np.int32)
                          for _ in range(2)]
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs):
    return spawn(W.sequence_world, (inputs,), nprocs=N, backend="gloo",
                 timeout=300).results


@pytest.fixture(autouse=True)
def _jax_mesh():
    yield
    jset(jbuild())
    jfleet._initialized = False
    jfleet._strategy = None


def _ok(res):
    assert not (isinstance(res, dict) and "error" in res), res.get("error")
    return res


CASES = ["ring_causal", "ring_full", "ulysses_causal", "ulysses_full"]


@pytest.fixture(scope="module")
def jax_attention(inputs):
    """Each case's JAX output and gradients, one ``jax.jit`` a case (op
    by op the interpreted Pallas kernels take minutes)."""
    jset(jbuild(sep=N, dp=1, devices=jax.devices()[:N]))
    q, k, v, do = (jnp.asarray(inputs[c]) for c in ("q", "k", "v", "do"))
    out = {}
    try:
        for case in CASES:
            fn = (jdist.ring_attention_sharded if case.startswith("ring")
                  else jdist.ulysses_attention_sharded)
            causal = case.endswith("causal")

            @jax.jit
            def run(a, b, c, g, fn=fn, causal=causal):
                o, vjp = jax.vjp(lambda x, y, z: fn(x, y, z, causal=causal),
                                 a, b, c)
                return (o,) + vjp(g)

            out[case] = [np.asarray(t) for t in run(q, k, v, do)]
    finally:
        jset(jbuild())
    return out


@pytest.mark.parametrize("case", CASES)
def test_attention_and_gradients_match_jax(world, jax_attention, case):
    results = world
    for r in range(N):
        got = _ok(results[r][case])
        for name, want in zip(("out", "dq", "dk", "dv"),
                              jax_attention[case]):
            np.testing.assert_allclose(got[name], want, rtol=1e-5,
                                       atol=1e-5,
                                       err_msg=f"{case} {name} rank {r}")


def test_ring_local_chunks(world, jax_attention):
    """The in-``shard_map`` form: rank i's chunks in, rank i's out."""
    want = jax_attention["ring_causal"][0]
    S = want.shape[2] // N
    for r in range(N):
        np.testing.assert_allclose(_ok(world[r]["ring_local"]),
                                   want[:, :, r * S:(r + 1) * S], rtol=1e-5,
                                   atol=1e-5)


def test_ring_schedule_is_jaxs():
    """JAX's causal schedule: a rank attends its own chunk (masked) and,
    rotating, every chunk of a lower rank (unmasked); a higher rank's is
    skipped.  Four ranks: 1, 2, 3, 4 chunks."""
    from paddle_tpu_torch.distributed.sequence_parallel import ring_schedule

    for i in range(4):
        sched = ring_schedule(4, i, True)
        assert [s for s, _, _ in sched] == list(range(i + 1))
        assert [src for _, src, _ in sched] == [i] + [
            (i - s) % 4 for s in range(1, i + 1)]
        assert [m for _, _, m in sched] == [True] + [False] * i
        assert len(ring_schedule(4, i, False)) == 4


def _key_bias_close(name, got, want, init):
    if name.endswith("attn.qkv.bias"):
        d = want.shape[0] // 3
        np.testing.assert_allclose(got[d:2 * d], init[d:2 * d], rtol=0,
                                   atol=2 * LR, err_msg=name)
        got, want = (np.delete(x, np.s_[d:2 * d]) for x in (got, want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)


def _jax_gpt(inputs, n, method, via_strategy=False):
    kw = dict(sep_degree=n)
    if via_strategy:
        kw.update(sequence_parallel=True,
                  sequence_parallel_configs={"method": method})
    jfleet.init(is_collective=True, strategy=jfleet.DistributedStrategy(**kw),
                devices=jax.devices()[:n])
    cfg = jgpt.gpt_tiny(sequence_parallel=None if via_strategy else method)
    net = jgpt.GPTForCausalLM(cfg)
    net.set_state_dict({k: jnp.asarray(v) for k, v in inputs["gpt"].items()})
    model = jpt.Model(net)
    model.prepare(optimizer=jfleet.distributed_optimizer(
        jopt.Adam(learning_rate=LR)), loss=net.loss)
    logits = np.asarray(model.predict_batch([inputs["gpt_batches"][0]]))
    losses = [model.train_batch([ids], [ids])[0]
              for ids in inputs["gpt_batches"]]
    return logits, losses, {k: np.asarray(p.value)
                            for k, p in net.named_parameters()}


@pytest.mark.parametrize("method", ["ring", "ulysses"])
def test_gpt_sequence_parallel_matches_jax(world, inputs, method):
    logits, losses, params = _jax_gpt(inputs, N, method)
    for r in range(N):
        got = _ok(world[r][f"gpt_{method}"])
        np.testing.assert_allclose(got["logits"], logits, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, v in params.items():
            _key_bias_close(k, got["params"][k], v, inputs["gpt"][k])


def test_fleet_sequence_parallel_toggle(world, inputs):
    _, losses, _ = _jax_gpt(inputs, N, "ulysses", via_strategy=True)
    for r in range(N):
        got = _ok(world[r]["gpt_strategy"])
        assert got["knob"] == "ulysses"
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
