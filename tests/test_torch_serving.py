"""The port's paged-KV ``GenerationEngine`` (paddle_tpu_torch/serving).

The cases of tests/test_paged_kv.py on the port's engine, on the CPU at
tiny size: tokens identical to the port's own uncached greedy under
staggered admission, copy-on-write prefix sharing, speculative verify
with ring wrap (held against greedy with the same sliding window), pool
exhaustion preemption and transient-failure restarts — with every page
returned and none leaked.  Then the slice as a whole: a JAX
``GenerationEngine(paged=True)`` and the port's engine, same bridged
weights and prompts, produce the same tokens (any disagreement must be a
near-tie: JAX top-1 margin below 1e-4).
"""
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import (ExecutionTimeoutError,
                                               InvalidArgumentError,
                                               UnavailableError)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.resilience.faults import FaultPlan
from paddle_tpu_torch.serving import GenerationEngine, MicroBatcher

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_position=64)
MARGIN_TIE = 1e-4


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(2)
    pt.seed(4321)
    jm = JaxGPT(jax_gpt_tiny(**TINY))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(**TINY), device="cpu")
    load_jax_params(tm, {k: np.asarray(p.value)
                         for k, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


def _ref_greedy(model, prompt, n, window=None):
    """Uncached greedy over the port's dense ``forward``; ``window`` masks
    keys at or before ``query - window`` (the paged ring's sliding window
    once positions pass cache_len)."""
    ids, outs = [int(t) for t in prompt], []
    with torch.no_grad():
        for _ in range(n):
            x = torch.tensor([ids])
            mask = None
            if window is not None:
                S = len(ids)
                qp = torch.arange(S)[:, None]
                kp = torch.arange(S)[None, :]
                mask = torch.where(kp > qp - window, 0.0, -1e30)
            nxt = int(model(x, mask)[0, -1].argmax())
            outs.append(nxt)
            ids.append(nxt)
    return outs


def _assert_clean(eng, pages):
    st = eng.stats()
    assert st["kv_pages_leaked"] == 0
    assert st["kv_pages_free"] == pages  # all returned
    return st


def test_token_identity_staggered_admission(models):
    _, tm = models
    prompts = [(np.arange(10) * 5 + 2) % 97, np.arange(3) % 97,
               (np.arange(6) * 3) % 97, (np.arange(4) * 7 + 1) % 97,
               (np.arange(5) * 11 + 3) % 97]
    budgets = [14, 3, 4, 5, 3]
    refs = [_ref_greedy(tm, p, b) for p, b in zip(prompts, budgets)]
    with GenerationEngine(tm, prompt_buckets=[8, 16], batch_size=2,
                          paged=True, kv_page_size=8, speculative_k=3,
                          name="pt-stagger") as eng:
        eng.warmup()
        futs = [eng.submit(prompts[0], budgets[0]),
                eng.submit(prompts[1], budgets[1])]
        for p, b in zip(prompts[2:], budgets[2:]):
            time.sleep(0.02)
            futs.append(eng.submit(p, b))
        for f, ref in zip(futs, refs):
            assert f.result(120).tolist() == ref
        eng.close()
        st = _assert_clean(eng, eng._pool.num_pages)
        assert st["completed"] == 5 and st["errors"] == 0


def test_cow_prefix_sharing_isolation(models):
    _, tm = models
    sys_p = (np.arange(11) * 7 + 3) % 97
    prompts = [np.concatenate([sys_p, e]).astype(np.int32)
               for e in ([5, 9, 2], [5, 9, 2, 44], [61], [30, 8])]
    budgets = [6, 5, 8, 7]
    refs = [_ref_greedy(tm, p, b) for p, b in zip(prompts, budgets)]
    with GenerationEngine(tm, prompt_buckets=[16], batch_size=2,
                          cache_len=64, paged=True, kv_page_size=8,
                          speculative_k=2, name="pt-cow") as eng:
        eng.warmup()
        outs = [eng.submit(p, b, prefix_key="sys", prefix_len=len(sys_p))
                for p, b in zip(prompts, budgets)]
        for o, ref in zip(outs, refs):
            assert o.result(120).tolist() == ref
        eng.close()
        st = eng.stats()
        assert st["cow_copies"] > 0 and st["prefix_hits"] > 0
        assert st["kv_pages_leaked"] == 0


def test_speculative_bit_identity_and_ring_wrap(models):
    # repetitive continuations make the n-gram proposer hit; accepted AND
    # rejected drafts must leave tokens identical to greedy — including
    # past position C=32 where drafting disables and the window slides
    _, tm = models
    p = (np.arange(6) * 9 + 4) % 97
    ref = _ref_greedy(tm, p, 45, window=32)
    with GenerationEngine(tm, prompt_buckets=[8], batch_size=2,
                          cache_len=32, paged=True, kv_page_size=8,
                          speculative_k=3, name="pt-spec") as eng:
        eng.warmup()
        assert eng.generate(p, 45, timeout=120).tolist() == ref
        st = eng.stats()
        assert st["spec_drafted"] > 0
        assert st["spec_drafted"] >= st["spec_accepted"]
        assert st["decode_steps"] < 45  # speculation paid off


def test_pool_exhaustion_preempts_and_recovers(models):
    _, tm = models
    pa = (np.arange(4) * 13 + 1) % 97
    pb = (np.arange(4) * 5 + 2) % 97
    refs = [_ref_greedy(tm, pa, 26), _ref_greedy(tm, pb, 26)]
    with GenerationEngine(tm, prompt_buckets=[8], batch_size=2,
                          cache_len=32, paged=True, kv_page_size=4,
                          kv_pages=9, speculative_k=0,
                          circuit_breaker=False,
                          name="pt-preempt") as eng:
        eng.warmup()
        fa, fb = eng.submit(pa, 26), eng.submit(pb, 26)
        assert fa.result(120).tolist() == refs[0]
        assert fb.result(120).tolist() == refs[1]
        eng.close()
        st = _assert_clean(eng, 9)
        assert st["preempted"] >= 1


def test_transient_failure_restarts_rebuild_pool(models):
    _, tm = models
    p = (np.arange(5) * 9 + 4) % 97
    ref = _ref_greedy(tm, p, 6)
    with GenerationEngine(tm, prompt_buckets=[8], batch_size=2,
                          paged=True, kv_page_size=8, speculative_k=2,
                          circuit_breaker=False,
                          name="pt-restart") as eng:
        eng.warmup()
        assert eng.generate(p, 6, timeout=120).tolist() == ref
        plan = FaultPlan.parse("site=serving.decode,nth=1")
        with plan:
            assert eng.generate(p, 6, timeout=120).tolist() == ref
        assert plan.stats()["serving.decode"]["fired"] == 1
        eng.close()
        st = eng.stats()
        assert st["restarts"] >= 1 and st["kv_pages_leaked"] == 0


def test_fatal_failure_fails_the_request(models):
    _, tm = models
    with GenerationEngine(tm, prompt_buckets=[8], batch_size=1,
                          paged=True, kv_page_size=8, speculative_k=0,
                          name="pt-fatal") as eng:
        with FaultPlan.parse(
                "site=serving.decode,nth=1,error=InvalidArgumentError"):
            fut = eng.submit(np.arange(3) % 97, 4)
            with pytest.raises(InvalidArgumentError, match="injected"):
                fut.result(60)
        assert eng.stats()["errors"] == 1


def test_mode_validation_names_the_roadmap(models):
    _, tm = models
    # the dense ring (FLAGS_paged_kv's default), the legacy scheduler and
    # the hand-off roles are ported: they build (and close) cleanly
    for kw in (dict(), dict(paged=False), dict(continuous=False),
               dict(paged=True, role="prefill"),
               dict(paged=True, quantized="int8", role="decode")):
        GenerationEngine(tm, prompt_buckets=[8], **kw).close()
    # the JAX rules: paged needs continuous, roles need paged
    for kw in (dict(paged=True, continuous=False), dict(role="decode"),
               dict(paged=True, role="both")):
        with pytest.raises(InvalidArgumentError):
            GenerationEngine(tm, prompt_buckets=[8], **kw)
    # tenancy is ported (the LoRA and tenancy slice): a scheduler builds on
    # a paged engine, and the JAX rule holds that it needs paged KV
    from paddle_tpu_torch.serving import TenantScheduler

    GenerationEngine(tm, prompt_buckets=[8], paged=True,
                     tenancy=TenantScheduler(["a"])).close()
    with pytest.raises(InvalidArgumentError, match="paged"):
        GenerationEngine(tm, prompt_buckets=[8], paged=False,
                         tenancy=TenantScheduler(["a"]))
    # quantized= is ported: only an unknown mode is rejected
    with pytest.raises(InvalidArgumentError, match="int4"):
        GenerationEngine(tm, prompt_buckets=[8], paged=True,
                         quantized="int4")
    with pytest.raises(InvalidArgumentError):
        GenerationEngine(tm, prompt_buckets=[128], paged=True)
    with GenerationEngine(tm, prompt_buckets=[8], paged=True,
                          kv_page_size=8, name="pt-val") as eng:
        with pytest.raises(InvalidArgumentError):
            eng.submit(np.arange(9) % 97, 2)  # bucket miss
        with pytest.raises(InvalidArgumentError):
            eng.submit(np.arange(3) % 97, 0)
        assert eng.stats()["bucket_misses"] == 1


def test_close_without_drain_fails_queued(models):
    _, tm = models
    eng = GenerationEngine(tm, prompt_buckets=[8], batch_size=1,
                           paged=True, kv_page_size=8, speculative_k=0,
                           name="pt-nodrain")
    futs = [eng.submit(np.arange(3) % 97, 40) for _ in range(3)]
    eng.close(drain=False, timeout=30)
    assert not eng._thread.is_alive()
    errs = [f.exception(timeout=5) for f in futs]
    assert any(isinstance(e, UnavailableError) for e in errs)
    assert all(e is None or isinstance(e, UnavailableError) for e in errs)


def test_micro_batcher_sheds_and_expires():
    mb = MicroBatcher(lambda inputs: 0, max_queue_depth=2, name="pt-mb")
    f1 = mb.submit((np.arange(3),), deadline_ms=1.0)
    mb.submit((np.arange(3),))
    with pytest.raises(UnavailableError):
        mb.submit((np.arange(3),))
    time.sleep(0.01)
    got = mb.poll(4)
    assert len(got) == 1  # the expired one was failed, not returned
    assert isinstance(f1.exception(timeout=1), ExecutionTimeoutError)
    snap = mb.metrics.snapshot()
    assert snap["shed"] == 1 and snap["expired"] == 1
    mb.consumer_done()
    mb.close()
    with pytest.raises(UnavailableError):
        mb.submit((np.arange(3),))


def _jax_margin(jm, ids):
    logits = np.asarray(jm(jnp.asarray([ids], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def test_slice_tokens_match_the_jax_engine(models):
    jm, tm = models
    rng = np.random.RandomState(11)
    sys_p = rng.randint(0, 97, size=9)
    reqs = [(rng.randint(0, 97, size=int(rng.randint(3, 16))),
             int(rng.randint(4, 12)), {}) for _ in range(4)]
    reqs += [(np.concatenate([sys_p, rng.randint(0, 97, size=3)]), 8,
              dict(prefix_key="sys", prefix_len=9)) for _ in range(2)]
    kw = dict(prompt_buckets=[8, 16], batch_size=2, paged=True,
              kv_page_size=8, speculative_k=3)
    with JaxGenerationEngine(jm, name="pt-slice-jax", **kw) as je:
        want = [je.submit(p, n, **k) for p, n, k in reqs]
        want = [f.result(300).tolist() for f in want]
    with GenerationEngine(tm, name="pt-slice", **kw) as te:
        te.warmup()
        got = [te.submit(p, n, **k) for p, n, k in reqs]
        got = [f.result(300).tolist() for f in got]
    compared = 0
    for (p, _, _), w, g in zip(reqs, want, got):
        for j, (a, b) in enumerate(zip(w, g)):
            if a != b:
                margin = _jax_margin(jm, [int(t) for t in p] + w[:j])
                assert margin < MARGIN_TIE, (
                    f"clear-margin flip: jax {a} port {b} margin {margin}")
                break
            compared += 1
        else:
            assert len(w) == len(g)
    assert compared >= 20
