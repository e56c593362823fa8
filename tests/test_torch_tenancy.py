"""Multi-tenant serving in the port (paddle_tpu_torch/serving/tenancy.py and
the engine's adapter / tenant paths) held against the JAX package on the
CPU at a tiny size.

The scheduler: the port's ``TenantScheduler`` and the JAX one, fed the
same calls under one fake clock, give identical orders and snapshots
(tests/test_tenancy.py's ``TestTenantScheduler`` cases, with
``slo_objectives`` raising ``UnimplementedError`` in the port).  The
engines: mixed tenants on one paged engine bit-identical to serial
per-tenant runs, budget preemption regenerating the uncontended tokens
with no page leaked, ``tenancy`` needing paged KV, the dense-ring and
legacy engines with adapters giving the paged engine's tokens, a quantized
LoRA engine against the JAX quantized engine one request at a time (the
JAX ``forward_paged`` through its Pallas kernel, as
tests/test_torch_quantized_serving.py runs it), and a hand-off carrying an
adapter giving the co-located tokens.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.models.gpt as jgpt
import paddle_tpu.serving.tenancy as jtenancy
from paddle_tpu import lora as jlora
from paddle_tpu import slim as jslim
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu.serving import TenantScheduler as JaxTenantScheduler
from paddle_tpu.serving import TenantSpec as JaxTenantSpec
import paddle_tpu_torch.serving.tenancy as ttenancy
from paddle_tpu_torch import lora
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (GenerationEngine, KVHandoff,
                                      TenantScheduler, TenantSpec)

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_position=64, dropout=0.0, lora_capacity=2, lora_rank=4)
PAGED = dict(prompt_buckets=[8], batch_size=2, cache_len=48, paged=True,
             kv_page_size=8)
PROMPTS = [(np.arange(5) * 11 + 3) % 97, np.arange(4) % 97,
           (np.arange(6) * 3 + 1) % 97]
TENANTS = (("acme", 0), ("globex", 1), ("base", -1))


# -- the scheduler --------------------------------------------------------------

@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock under both packages' schedulers."""
    now = [1000.0]
    fake = SimpleNamespace(monotonic=lambda: now[0])
    monkeypatch.setattr(jtenancy, "time", fake)
    monkeypatch.setattr(ttenancy, "time", fake)
    return now


def _both(specs):
    return (JaxTenantScheduler([JaxTenantSpec(*s) for s in specs]),
            TenantScheduler([TenantSpec(*s) for s in specs]))


def _schedule(sched, items):
    return sched.schedule(list(items), tenant_of=lambda it: it[0],
                          cost_of=lambda it: it[2])


def test_stride_order_is_weighted_and_deterministic(clock):
    js, ts = _both([("a", 2.0), ("b", 1.0)])
    items = [("a", i, 1) for i in range(3)] + [("b", i, 1) for i in range(3)]
    for sched in (js, ts):
        adm, deferred = _schedule(sched, items)
        assert deferred == []
        assert [t for t, _, _ in adm] == ["a", "b", "a", "a", "b", "b"]
        assert [i for t, i, _ in adm if t == "a"] == [0, 1, 2]
    assert js.snapshot() == ts.snapshot()


def test_untagged_items_go_first_fcfs(clock):
    js, ts = _both([("a",)])
    items = [("a", 0, 1), (None, 0, 1), ("ghost", 1, 1)]
    for sched in (js, ts):
        assert _schedule(sched, items) == (
            [(None, 0, 1), ("ghost", 1, 1), ("a", 0, 1)], [])


def test_budget_throttles_and_refills(clock):
    js, ts = _both([("flood", 1.0, 2), ("ok",),
                    ("metered", 1.0, 10, 5.0)])
    for sched in (js, ts):
        assert not sched.is_throttled("flood")
        sched.charge("flood", 2)
        assert sched.is_throttled("flood")
        assert sched.over_budget() == ["flood"]
        adm, deferred = _schedule(sched, [("flood", 0, 1), ("ok", 0, 1),
                                          ("flood", 1, 1)])
        assert adm == [("ok", 0, 1)]
        assert deferred == [("flood", 0, 1), ("flood", 1, 1)]
        sched.charge("metered", 12)
        assert sched.is_throttled("metered")
    clock[0] += 1.0  # 5 tokens of refill: metered is back in budget
    for sched in (js, ts):
        assert not sched.is_throttled("metered")
        assert sched.is_throttled("flood")  # a hard one-shot cap
        snap = sched.snapshot()
        assert snap["flood"]["over_budget"] and snap["flood"]["tokens"] == 2
        assert snap["metered"]["budget_level"] == 3.0
    assert js.snapshot() == ts.snapshot()


def test_random_call_sequences_agree_with_jax(clock):
    """Seeded sequences of register / schedule / charge / note_* calls
    under the fake clock: identical orders, throttling and snapshots."""
    rng = np.random.RandomState(0)
    names = ["t0", "t1", "t2", "t3"]
    for trial in range(20):
        specs = [(n, float(rng.choice([0.5, 1.0, 2.0, 3.0])),
                  None if rng.rand() < 0.4 else int(rng.randint(5, 40)),
                  None if rng.rand() < 0.5 else float(rng.randint(1, 20)),
                  int(rng.randint(-1, 4)))
                 for n in names[:2 + trial % 3]]
        js, ts = _both(specs)
        for step in range(30):
            op = rng.randint(6)
            tn = (names + [None, "ghost"])[rng.randint(6)]
            if op == 0:
                items = [((names + [None])[rng.randint(5)], k,
                          int(rng.randint(1, 9)))
                         for k in range(int(rng.randint(0, 9)))]
                assert _schedule(js, items) == _schedule(ts, items)
            elif op == 1 and tn is not None:
                n = int(rng.randint(1, 12))
                js.charge(tn, n)
                ts.charge(tn, n)
            elif op == 2:
                for s in (js, ts):
                    s.note_admitted(tn)
                    s.note_starved(tn)
                    s.note_preempted(tn, 2)
            elif op == 3:
                assert js.is_throttled(tn) == ts.is_throttled(tn)
                assert js.over_budget() == ts.over_budget()
            elif op == 4:
                new = (f"n{trial}_{step}", float(rng.randint(1, 4)))
                js.register(JaxTenantSpec(*new))
                ts.register(TenantSpec(*new))
            else:
                clock[0] += float(rng.uniform(0.0, 0.5))
            assert js.snapshot() == ts.snapshot()
        for n in names[:2 + trial % 3]:
            assert js.adapter_id(n) == ts.adapter_id(n)
            assert tuple(js.spec(n)) == tuple(ts.spec(n))


def test_validation_and_slo_objectives():
    for bad in (dict(weight=0.0), dict(token_budget=0)):
        with pytest.raises(InvalidArgumentError):
            TenantScheduler([TenantSpec("x", **bad)])
    with pytest.raises(InvalidArgumentError):
        TenantScheduler([TenantSpec("")])
    ten = TenantScheduler(["plain"])  # a bare name registers a default spec
    assert ten.spec("plain") == TenantSpec("plain")
    with pytest.raises(InvalidArgumentError):
        ten.spec("nobody")
    ten.charge("nobody", 3)  # unknown tenants are ignored, as in JAX
    assert not ten.is_throttled("nobody") and not ten.is_throttled(None)
    gold = TenantScheduler([TenantSpec("gold", slo_ms=250.0),
                            TenantSpec("free")])
    with pytest.raises(UnimplementedError, match="item 7"):
        gold.slo_objectives("eng#1")


# -- the engines ----------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(2)
    pt.seed(4321)
    jm = JaxGPT(JaxGPTConfig(**TINY))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_jax_params(tm, {k: np.asarray(p.value)
                         for k, p in jm.named_parameters()},
                    {k: np.asarray(b.value) for k, b in jm.named_buffers()})
    tm.eval()
    jads = [jlora.random_adapter(jm, f"t{i}", rank=4, seed=20 + i,
                                 alpha=32.0, std=0.2) for i in range(2)]
    tads = [lora.random_adapter(tm, f"t{i}", rank=4, seed=20 + i,
                                alpha=32.0, std=0.2) for i in range(2)]
    return jm, tm, jads, tads


def _engine(tm, tads, name, **kw):
    eng = GenerationEngine(tm, name=name, **kw)
    for slot, a in enumerate(tads):
        eng.install_adapter(slot, a)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def serial(models):
    """Per-tenant serial runs on a paged engine: one request at a time."""
    _, tm, _, tads = models
    with _engine(tm, tads, "pt-ten-serial", **PAGED) as ser:
        return {tn: [ser.generate(p, 6, timeout=120,
                                  adapter_id=aid).tolist()
                     for p in PROMPTS] for tn, aid in TENANTS}


def test_mixed_tenants_bit_identical_to_serial(models, serial):
    _, tm, _, tads = models
    ten = TenantScheduler([TenantSpec("acme", weight=2.0, adapter_id=0),
                           TenantSpec("globex", adapter_id=1),
                           TenantSpec("base", adapter_id=-1)])
    with _engine(tm, tads, "pt-ten-mixed", tenancy=ten, **PAGED) as eng:
        futs = [(tn, i, eng.submit(p, 6, tenant=tn))
                for i, p in enumerate(PROMPTS) for tn, _ in TENANTS]
        for tn, i, f in futs:
            assert f.result(120).tolist() == serial[tn][i], (tn, i)
        st = eng.stats()
    assert st["completed"] == 9 and st["kv_pages_leaked"] == 0
    assert st["tenant_preempted"] == 0
    snap = ten.snapshot()
    assert snap["acme"]["admitted"] == 3 and snap["acme"]["tokens"] == 18
    assert serial["acme"] != serial["base"]
    assert serial["acme"] != serial["globex"]


def test_mixed_tenants_match_the_jax_engine(models, serial):
    jm, _, jads, _ = models
    ten = JaxTenantScheduler([
        JaxTenantSpec("acme", weight=2.0, adapter_id=0),
        JaxTenantSpec("globex", adapter_id=1),
        JaxTenantSpec("base", adapter_id=-1)])
    with JaxGenerationEngine(jm, name="jx-ten", tenancy=ten, **PAGED) as je:
        for slot, a in enumerate(jads):
            je.install_adapter(slot, a)
        futs = [(tn, i, je.submit(p, 6, tenant=tn))
                for i, p in enumerate(PROMPTS) for tn, _ in TENANTS]
        for tn, i, f in futs:
            assert f.result(120).tolist() == serial[tn][i], (tn, i)


def test_budget_preemption_regenerates_bit_identically(models):
    _, tm, _, tads = models
    ten = TenantScheduler([
        TenantSpec("metered", token_budget=50, refill_per_s=500.0)])
    p = (np.arange(6) * 9 + 4) % 97
    with _engine(tm, tads, "pt-ten-preempt", tenancy=ten, **PAGED) as eng:
        ref = eng.generate(p, 20, timeout=120).tolist()  # untagged
        base_steps = eng.stats()["decode_steps"]
        fut = eng.submit(p, 20, tenant="metered")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:  # wait until mid-decode
            if eng.stats()["decode_steps"] > base_steps:
                break
            time.sleep(0.002)
        ten.charge("metered", 200)  # empty the bucket -> preempt
        assert fut.result(120).tolist() == ref
        st = eng.stats()
    assert st["tenant_preempted"] >= 1 and st["preempted"] >= 1
    assert ten.snapshot()["metered"]["preempted"] >= 1
    assert st["kv_pages_leaked"] == 0


def test_throttled_tenant_waits_and_others_run(models, serial):
    """An over-budget tenant's requests defer (counted as throttling, not
    starvation) while an in-budget tenant's run; a fresh budget (the
    tenant registered again) releases them."""
    _, tm, _, tads = models
    ten = TenantScheduler([TenantSpec("flood", token_budget=100,
                                      adapter_id=0),
                           TenantSpec("acme", adapter_id=0)])
    with _engine(tm, tads, "pt-ten-throttle", tenancy=ten, **PAGED) as eng:
        ten.charge("flood", 150)
        flood = [eng.submit(p, 6, tenant="flood") for p in PROMPTS]
        ok = [eng.submit(p, 6, tenant="acme") for p in PROMPTS]
        assert [f.result(120).tolist() for f in ok] == serial["acme"]
        deadline = time.monotonic() + 30
        while (eng.stats()["tenant_throttled_steps"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert not any(f.done() for f in flood)
        ten.register(TenantSpec("flood", token_budget=100, adapter_id=0))
        assert [f.result(120).tolist() for f in flood] == serial["acme"]
        st = eng.stats()
    assert st["tenant_throttled_steps"] >= 1 and st["completed"] == 6
    assert st["starved_steps"] == 0 and st["kv_pages_leaked"] == 0


def test_tenancy_requires_paged_and_tenant_resolves_adapter(models):
    _, tm, _, tads = models
    ten = TenantScheduler([TenantSpec("a", adapter_id=1)])
    for kw in (dict(continuous=True, paged=False), dict(continuous=False)):
        with pytest.raises(InvalidArgumentError, match="paged"):
            GenerationEngine(tm, prompt_buckets=[8], batch_size=2,
                             tenancy=ten, name="pt-ten-dense", **kw)
    with GenerationEngine(tm, name="pt-ten-meta", tenancy=ten,
                          **PAGED) as eng:
        eng.submit(PROMPTS[0], 1, tenant="a").result(120)
        eng.submit(PROMPTS[0], 1, tenant="a", adapter_id=-1).result(120)
        with pytest.raises(InvalidArgumentError):
            eng.submit(PROMPTS[0], 1, tenant="nobody")
        st = eng.stats()
    for k in ("tenant_preempted", "tenant_throttled_steps",
              "tenant_starved_steps_after_warm", "adapter_installs"):
        assert k in st, k


@pytest.mark.parametrize("kw", [dict(continuous=True, paged=False),
                                dict(continuous=False)],
                         ids=["dense ring", "legacy"])
def test_dense_engines_with_adapters_match_serial(models, serial, kw):
    """The dense-ring and legacy engines serve adapters: mixed batches give
    the paged engine's serial tokens (every row depends on its own row
    only)."""
    _, tm, _, tads = models
    with _engine(tm, tads, "pt-ten-dense", prompt_buckets=[8], batch_size=2,
                 cache_len=48, max_queue_delay_ms=20.0, **kw) as eng:
        futs = [(tn, i, eng.submit(p, 6, adapter_id=aid, tenant=tn))
                for i, p in enumerate(PROMPTS) for tn, aid in TENANTS]
        for tn, i, f in futs:
            assert f.result(120).tolist() == serial[tn][i], (tn, i)
        assert eng.stats()["adapter_installs"] == 2


def test_handoff_with_adapter_gives_co_located_tokens(models, serial):
    _, tm, _, tads = models
    with _engine(tm, tads, "pt-ten-pre", role="prefill", **PAGED) as pre, \
            _engine(tm, tads, "pt-ten-dec", role="decode", **PAGED) as dec:
        for tn, aid in TENANTS:
            hands = [pre.submit(p, 6, handoff=True,
                                adapter_id=aid).result(120)
                     for p in PROMPTS]
            assert all(isinstance(h, KVHandoff) for h in hands)
            got = [dec.submit(p, 6, handoff=h, adapter_id=aid).result(120)
                   .tolist() for p, h in zip(PROMPTS, hands)]
            assert got == serial[tn], tn


@pytest.fixture
def jax_paged_kernel(monkeypatch):
    """Run the JAX ``forward_paged`` through its Pallas paged kernel
    (interpret mode on the CPU), as tests/test_torch_quantized_serving.py
    does: the gather fallback treats padding rows differently, and a
    quantized linear's per-tensor activation scale sees them."""
    monkeypatch.setattr(jgpt, "_paged_flash", lambda hd, page: True)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_lora_engine_matches_jax(models, mode, jax_paged_kernel):
    """Quantized + LoRA: the LoRA leg after the quantized linear, one
    request at a time, against the JAX quantized engine with the same
    adapters (the port model carries JAX's codes and scales)."""
    jm, _, jads, tads = models
    params, buffers = jslim.quantize_model_trees(jm, mode)
    qm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_jax_params(qm, {k: np.asarray(v) for k, v in params.items()},
                    {k: np.asarray(v) for k, v in buffers.items()})
    qm.eval()
    kw = dict(PAGED, prompt_buckets=[16], speculative_k=0, quantized=mode)
    with JaxGenerationEngine(jm, name=f"jx-qlora-{mode}", **kw) as je:
        for slot, a in enumerate(jads):
            je.install_adapter(slot, a)
        want = {tn: [je.generate(p, 6, timeout=300, adapter_id=aid).tolist()
                     for p in PROMPTS] for tn, aid in TENANTS}
    with _engine(qm, tads, f"pt-qlora-{mode}", **kw) as te:
        assert te.quant_active
        got = {tn: [te.generate(p, 6, timeout=300, adapter_id=aid).tolist()
                    for p in PROMPTS] for tn, aid in TENANTS}
    assert got == want
    assert want["acme"] != want["base"]
