"""The port's default serving engine: the dense ring KV cache and the
dense continuous / legacy schedulers (paddle_tpu_torch/serving).

On the CPU at ``gpt_tiny`` size (2 layers), weights bridged from the JAX
package (``load_jax_params``):

* ``forward_cached`` against the JAX ``forward_cached``: logits and ring
  contents (K, V, the position map) at rtol / atol 1e-5 through a ragged
  prefill, decode steps and a ring wrap past ``C``;
* ``write_slots`` / ``reset_slots`` against JAX's, and the rows they do
  not mask bit-identical; the engine's admission and eviction leave the
  other rows of a live ring bit-identical;
* the default engine (``GenerationEngine(model, prompt_buckets=...)``
  with default flags) against the JAX dense engine and uncached greedy —
  a disagreement must be a near-tie (JAX top-1 margin below 1e-4); the
  invariants of tests/test_continuous_batching.py (staggered admission,
  slot reuse, EOS, the flag fallback to legacy, legacy = continuous,
  transient restart), without its compile counts;
* int8 / fp8 dense engines against the JAX quantized dense engine;
* bench.py's engine keywords (``max_queue_delay_ms``);
* hot weight swaps: outputs follow the donor, a swap reaches only the
  engine it is made on, mismatches and mode mismatches are rejected,
  ``reload_weights`` after ``load``, artifacts of either package swap
  into the other's engine.
"""
import copy
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import slim as jslim
from paddle_tpu.framework import serialization as jserialization
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
import paddle_tpu_torch as ptt
from paddle_tpu_torch import slim
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.resilience.faults import FaultPlan
from paddle_tpu_torch.serving import GenerationEngine

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_position=64)
MARGIN_TIE = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_pair(seed):
    pt.seed(seed)
    jm = JaxGPT(jax_gpt_tiny(**TINY))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(**TINY), device="cpu")
    load_jax_params(tm, {k: np.asarray(p.value)
                         for k, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(2)
    return _jax_pair(4321)


def _ref_greedy(model, prompt, n, eos=None, window=None):
    """Uncached greedy over the port's dense ``forward``; ``window`` masks
    keys at or before ``query - window`` (the ring's sliding window)."""
    ids, outs = [int(t) for t in prompt], []
    with torch.no_grad():
        for _ in range(n):
            mask = None
            if window is not None:
                S = len(ids)
                qp = torch.arange(S)[:, None]
                kp = torch.arange(S)[None, :]
                mask = torch.where(kp > qp - window, 0.0, -1e30)
            nxt = int(model(torch.tensor([ids]), mask)[0, -1].argmax())
            outs.append(nxt)
            ids.append(nxt)
            if eos is not None and nxt == eos:
                break
    return outs


def _jax_margin(jm, ids):
    logits = np.asarray(jm(jnp.asarray([ids], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _agree(jm, reqs, want, got, min_compared):
    """Token lists equal, or diverging first at a near-tie of the JAX
    model ``jm`` (the quantized one for quantized engines)."""
    compared = 0
    for p, w, g in zip(reqs, want, got):
        for j, (a, b) in enumerate(zip(w, g)):
            if a != b:
                margin = _jax_margin(jm, [int(t) for t in p] + w[:j])
                assert margin < MARGIN_TIE, (
                    f"clear-margin flip: jax {a} port {b} margin {margin}")
                break
            compared += 1
        else:
            assert len(w) == len(g)
    assert compared >= min_compared


# -- the ring cache -----------------------------------------------------------
def _ring_equal(jcache, tcache, exact=False):
    np.testing.assert_array_equal(np.asarray(jcache["pos"]),
                                  tcache["pos"].numpy())
    for jl, tl in zip(jcache["layers"], tcache["layers"]):
        for key in ("k", "v"):
            if exact:
                np.testing.assert_array_equal(np.asarray(jl[key]),
                                              tl[key].numpy())
            else:
                np.testing.assert_allclose(tl[key].numpy(),
                                           np.asarray(jl[key]), **TOL)


def test_forward_cached_matches_jax_through_prefill_decode_and_wrap(models):
    jm, tm = models
    B, C, S = 3, 16, 8
    rng = np.random.RandomState(0)
    lens = np.array([8, 3, 5])
    ids = rng.randint(0, 97, size=(B, S)).astype(np.int32)
    pos = np.full((B, S), -1, np.int32)
    for b, L in enumerate(lens):
        pos[b, :L] = np.arange(L)
    jc = jm.gpt.init_cache(B, C)
    tc = tm.gpt.init_cache(B, C)
    assert tc["pos"].dtype == torch.int32 and tc["pos"].shape == (B, C)
    assert tc["layers"][0]["k"].shape == (B, 4, C, 8)
    jl, jc = jm.forward_cached(jnp.asarray(ids), jnp.asarray(pos), jc,
                               gather_last=jnp.asarray(lens))
    with torch.no_grad():
        tl, tc = tm.forward_cached(ids, pos, tc, gather_last=lens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _ring_equal(jc, tc)
    # decode past C: row 0 wraps the ring after 8 steps (sliding window),
    # row 2 sits out two steps as a free slot (position -1)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    p = lens.copy()
    for step in range(12):
        dpos = p.copy()
        if step in (3, 4):
            dpos[2] = -1
        jlog, jc = jm.forward_cached(jnp.asarray(tok[:, None]),
                                     jnp.asarray(dpos[:, None]), jc)
        with torch.no_grad():
            tlog, tc = tm.forward_cached(torch.from_numpy(tok[:, None]),
                                         dpos[:, None], tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _ring_equal(jc, tc)
        tok = np.asarray(jlog)[:, 0].argmax(-1).astype(np.int32)
        p = np.where(dpos >= 0, p + 1, p)
    assert p[0] > C  # the wrap happened
    # a free slot attends to nothing: a uniform row, not NaN
    assert np.isfinite(tlog.numpy()).all()


def test_forward_cached_refuses_more_tokens_than_slots(models):
    _, tm = models
    cache = tm.gpt.init_cache(1, 4)
    with pytest.raises(InvalidArgumentError):
        tm.forward_cached(np.zeros((1, 5), np.int32),
                          np.arange(5)[None], cache)


def _filled(jm, tm, B, C, seed):
    """Both packages' caches after one ragged prefill of the same data."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 97, size=(B, 6)).astype(np.int32)
    pos = np.tile(np.arange(6, dtype=np.int32), (B, 1))
    pos[1, 4:] = -1
    jc = jm.gpt.init_cache(B, C)
    _, jc = jm.forward_cached(jnp.asarray(ids), jnp.asarray(pos), jc)
    tc = tm.gpt.init_cache(B, C)
    with torch.no_grad():
        tm.forward_cached(ids, pos, tc)
    # the port's ring gets JAX's exact values, so merges compare bit-exact
    for jl, tl in zip(jc["layers"], tc["layers"]):
        for key in ("k", "v"):
            tl[key].copy_(torch.from_numpy(np.array(jl[key])))
    return jc, tc


def _rows(cache, rows):
    return [cache["pos"][rows].clone()] + [
        l[k][rows].clone() for l in cache["layers"] for k in ("k", "v")]


def test_write_and_reset_slots_match_jax_and_leave_other_rows(models):
    jm, tm = models
    B, C = 4, 8
    mask = np.array([False, True, False, True])
    dst_j, dst_t = _filled(jm, tm, B, C, 1)
    src_j, src_t = _filled(jm, tm, B, C, 2)
    keep = [0, 2]
    before = _rows(dst_t, keep)
    out = tm.gpt.write_slots(dst_t, src_t, mask)
    assert out is dst_t  # in place
    _ring_equal(jm.gpt.write_slots(dst_j, src_j, jnp.asarray(mask)), dst_t,
                exact=True)
    for a, b in zip(before, _rows(dst_t, keep)):
        assert torch.equal(a, b)
    with pytest.raises(InvalidArgumentError):
        tm.gpt.write_slots(dst_t, tm.gpt.init_cache(2, C), mask)
    # reset: the masked position rows -1, nothing else touched
    before = _rows(dst_t, keep)
    kv_before = [l[k].clone() for l in dst_t["layers"] for k in ("k", "v")]
    tm.gpt.reset_slots(dst_t, mask)
    jr = jm.gpt.reset_slots(dst_j, jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(jr["pos"]),
                                  dst_t["pos"].numpy())
    assert (dst_t["pos"][[1, 3]] == -1).all()
    for a, b in zip(before, _rows(dst_t, keep)):
        assert torch.equal(a, b)
    for a, l in zip(kv_before, [l[k] for l in dst_t["layers"]
                                for k in ("k", "v")]):
        assert torch.equal(a, l)  # K/V payloads stay, as in JAX


def test_admission_and_eviction_leave_live_rows_bit_identical(models):
    _, tm = models
    with GenerationEngine(tm, prompt_buckets=[8], batch_size=4,
                          cache_len=16, name="pt-dense-rows") as eng:
        eng.warmup()
        ring = eng._ring()
        tok = torch.zeros(4, dtype=torch.int32)
        ids = np.random.RandomState(3).randint(0, 97, (4, 8)).astype(
            np.int32)
        pos = np.tile(np.arange(8, dtype=np.int32), (4, 1))
        with torch.no_grad():
            tok, _ = eng._admit(ids, pos, np.full(4, 8, np.int32),
                                np.ones(4, bool), ring, tok)
            before = _rows(ring, [0, 2])
            tok_before = tok.clone()
            mask = np.array([False, True, False, True])
            pos2 = np.full((4, 8), -1, np.int32)
            pos2[1, :5] = np.arange(5)
            pos2[3, :2] = np.arange(2)
            tok, _ = eng._admit(ids[::-1].copy(), pos2,
                                np.array([1, 5, 1, 2], np.int32), mask,
                                ring, tok)
            for a, b in zip(before, _rows(ring, [0, 2])):
                assert torch.equal(a, b)
            assert torch.equal(tok[[0, 2]], tok_before[[0, 2]])
            assert (ring["pos"][1, 5:] == -1).all()  # the old occupant gone
            assert (ring["pos"][1, :5] == torch.arange(5)).all()
            tok, _ = eng._evict(tok, ring, mask)
            for a, b in zip(before, _rows(ring, [0, 2])):
                assert torch.equal(a, b)
            assert (ring["pos"][[1, 3]] == -1).all()
            assert (tok[[1, 3]] == 0).all()


# -- the default engine -------------------------------------------------------
def test_default_engine_tokens_match_jax_and_greedy(models):
    jm, tm = models
    rng = np.random.RandomState(11)
    reqs = [(rng.randint(0, 97, size=int(rng.randint(3, 16))),
             int(rng.randint(4, 12))) for _ in range(6)]
    refs = [_ref_greedy(tm, p, n) for p, n in reqs]
    kw = dict(prompt_buckets=[8, 16], batch_size=2)
    with JaxGenerationEngine(jm, name="pt-dense-jax", continuous=True,
                             paged=False, **kw) as je:
        want = [f.result(300).tolist()
                for f in [je.submit(p, n) for p, n in reqs]]
    # default flags: continuous batching over the dense ring
    with GenerationEngine(tm, name="pt-dense", **kw) as te:
        st = te.stats()
        assert st["continuous"] and not st["paged"]
        te.warmup()
        got = [f.result(300).tolist()
               for f in [te.submit(p, n) for p, n in reqs]]
        st = te.stats()
    assert got == refs
    assert st["completed"] == 6 and st["errors"] == 0
    assert st["admitted"] == 6 and st["decode_steps"] > 0
    _agree(jm, [p for p, _ in reqs], want, got, 30)


def test_token_identity_staggered_admission(models):
    # one long request pins a slot while shorts are admitted mid-decode
    # into the other slot as it recycles — every output must match
    # uncached greedy AND the legacy fixed-batch path
    _, tm = models
    prompts = [(np.arange(10) * 5 + 2) % 97, np.arange(3) % 97,
               (np.arange(6) * 3) % 97, (np.arange(4) * 7 + 1) % 97,
               (np.arange(5) * 11 + 3) % 97]
    budgets = [14, 3, 4, 5, 3]
    refs = [_ref_greedy(tm, p, b) for p, b in zip(prompts, budgets)]
    with GenerationEngine(tm, prompt_buckets=[8, 16], batch_size=2,
                          continuous=True, name="pt-cb-stagger") as eng:
        eng.warmup()
        futs = [eng.submit(prompts[0], budgets[0]),
                eng.submit(prompts[1], budgets[1])]
        for p, b in zip(prompts[2:], budgets[2:]):
            time.sleep(0.02)  # the long request is mid-decode by now
            futs.append(eng.submit(p, b))
        assert [f.result(120).tolist() for f in futs] == refs
    with GenerationEngine(tm, prompt_buckets=[8, 16], batch_size=2,
                          continuous=False, name="pt-cb-legacy") as leg:
        for p, b, ref in zip(prompts, budgets, refs):
            assert leg.generate(p, b, timeout=120).tolist() == ref


def test_slot_reuse_has_no_kv_contamination(models):
    # batch_size=1: every request reuses THE one slot
    _, tm = models
    prompts = [(np.arange(7) * 13 + 5) % 97, np.arange(2) % 97,
               (np.arange(8) * 3 + 1) % 97]
    with GenerationEngine(tm, prompt_buckets=[8], batch_size=1,
                          continuous=True, name="pt-cb-reuse") as eng:
        eng.warmup()
        for p in prompts:
            assert eng.generate(p, 5, timeout=120).tolist() == \
                _ref_greedy(tm, p, 5)
        st = eng.stats()
    assert st["admitted"] == 3 and st["evicted"] == 3
    assert st["decode_steps"] > 0
    assert "slot_occupancy" in st and "queue_age_ms" in st


def test_ring_wrap_slides_the_window(models):
    _, tm = models
    p = (np.arange(6) * 9 + 4) % 97
    ref = _ref_greedy(tm, p, 30, window=16)
    for continuous in (True, False):
        with GenerationEngine(tm, prompt_buckets=[8], batch_size=2,
                              cache_len=16, continuous=continuous,
                              name=f"pt-wrap-{continuous}") as eng:
            assert eng.generate(p, 30, timeout=120).tolist() == ref


def test_eos_stops_early(models):
    _, tm = models
    probe = _ref_greedy(tm, np.arange(4) % 97, 8)
    eos = probe[1]
    expect = probe[: probe.index(eos) + 1]
    assert len(expect) < 8
    for continuous in (True, False):
        with GenerationEngine(tm, prompt_buckets=[8], batch_size=2,
                              continuous=continuous, eos_token_id=eos,
                              name=f"pt-eos-{continuous}") as eng:
            gen = eng.generate(np.arange(4) % 97, max_new_tokens=8,
                               timeout=120)
            assert gen.tolist() == expect and gen[-1] == eos


def test_flag_fallback_to_legacy(models):
    _, tm = models
    set_flags({"continuous_batching": False})
    try:
        eng = GenerationEngine(tm, prompt_buckets=[8], batch_size=1,
                               name="pt-cb-flag")
        try:
            assert not eng.stats()["continuous"]
            assert eng._thread is None
            p = np.arange(3) % 97
            assert eng.generate(p, 3, timeout=120).tolist() == \
                _ref_greedy(tm, p, 3)
            assert eng.stats()["batches"] == 1
        finally:
            eng.close()
    finally:
        set_flags({"continuous_batching": True})


def test_legacy_tokens_equal_continuous_tokens(models):
    _, tm = models
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, 97, size=int(rng.randint(2, 16))),
             int(rng.randint(2, 10))) for _ in range(7)]
    outs = {}
    for continuous in (True, False):
        with GenerationEngine(tm, prompt_buckets=[8, 16], batch_size=3,
                              max_queue_delay_ms=2.0, continuous=continuous,
                              name=f"pt-eq-{continuous}") as eng:
            eng.warmup()
            outs[continuous] = [f.result(120).tolist() for f in
                                [eng.submit(p, n) for p, n in reqs]]
            st = eng.stats()
        assert st["completed"] == 7 and st["errors"] == 0
    assert outs[True] == outs[False]


def test_transient_failure_restarts_and_tokens_survive(models):
    _, tm = models
    with GenerationEngine(tm, prompt_buckets=[8], batch_size=2,
                          continuous=True, circuit_breaker=False,
                          name="pt-cb-restart") as eng:
        eng.warmup()
        p = (np.arange(5) * 9 + 4) % 97
        ref = _ref_greedy(tm, p, 6)
        assert eng.generate(p, 6, timeout=120).tolist() == ref
        plan = FaultPlan.parse(
            "site=serving.decode,nth=1,error=TransientDeviceError")
        with plan:
            # admission trips the fault; greedy decode is deterministic,
            # so the restarted request regenerates the same tokens
            assert eng.generate(p, 6, timeout=120).tolist() == ref
        assert plan.stats()["serving.decode"]["fired"] == 1
        assert eng.stats()["restarts"] >= 1


def test_legacy_runner_retries_transient_failures(models):
    _, tm = models
    p = (np.arange(5) * 9 + 4) % 97
    ref = _ref_greedy(tm, p, 4)
    with GenerationEngine(tm, prompt_buckets=[8], batch_size=2,
                          continuous=False, circuit_breaker=False,
                          name="pt-legacy-retry") as eng:
        plan = FaultPlan.parse(
            "site=serving.runner,nth=1,error=TransientDeviceError")
        with plan:
            assert eng.generate(p, 4, timeout=120).tolist() == ref
        assert plan.stats()["serving.runner"]["fired"] == 1
        assert eng.stats()["errors"] == 0


def test_engine_takes_bench_keywords(models):
    # bench.py:465-468 builds every engine with these keywords; the port
    # lacked max_queue_delay_ms and raised TypeError before anything ran
    _, tm = models
    for continuous, paged in ((False, False), (True, False), (True, True)):
        with GenerationEngine(
                tm, prompt_buckets=[16, 48], batch_size=8,
                max_queue_delay_ms=1.0, continuous=continuous, paged=paged,
                name=f"bench-gen-{continuous}-{paged}") as eng:
            eng.warmup()
            out = eng.generate(np.arange(5) % 97, 3, timeout=120)
            assert out.shape == (3,)
            assert eng._batcher._delay_s == pytest.approx(1e-3)


def test_dense_mode_refuses_moe_and_oversized_buckets(models):
    # an MoE model serves in the dense mode (tests/test_torch_moe_serving.py
    # holds it to JAX); an oversized bucket is refused
    moe = GPTForCausalLM(gpt_tiny(**TINY, moe_experts=2), device="cpu")
    with GenerationEngine(moe.eval(), prompt_buckets=[8]) as eng:
        eng.warmup()
        assert eng.generate(np.arange(1, 6), 3, timeout=60).tolist() == \
            _ref_greedy(moe, np.arange(1, 6), 3)
    assert eng.stats()["moe_routed_tokens"] > 0
    with pytest.raises(InvalidArgumentError):
        GenerationEngine(models[1], prompt_buckets=[128])  # > cache_len


# -- quantized dense engines --------------------------------------------------
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_dense_engine_matches_jax(models, mode):
    jm, _ = models
    params, buffers = jslim.quantize_model_trees(jm, mode)
    tm = GPTForCausalLM(gpt_tiny(**TINY), device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in params.items()},
                    {k: np.asarray(v) for k, v in buffers.items()})
    tm.eval()
    rng = np.random.RandomState(13)
    reqs = [(rng.randint(1, 97, size=int(rng.randint(3, 16))),
             int(rng.randint(4, 10))) for _ in range(4)]
    # one request at a time: per-tensor activation scales see every row
    # of a call, so both engines must run the same batches
    kw = dict(prompt_buckets=[16], batch_size=2, continuous=True,
              paged=False, quantized=mode)
    with JaxGenerationEngine(jm, name=f"pt-qd-jax-{mode}", **kw) as je:
        want = [je.generate(p, n, timeout=300).tolist() for p, n in reqs]
    with GenerationEngine(tm, name=f"pt-qd-{mode}", **kw) as te:
        te.warmup()
        assert te.quant_active and te.stats()["quantization"] == mode
        ring = te._ring()["layers"][0]["k"]
        assert ring.dtype == torch.float32  # the ring stays float
        got = [te.generate(p, n, timeout=300).tolist() for p, n in reqs]
    jq = jslim.quantize_weights(copy.deepcopy(jm), mode)
    _agree(jq, [p for p, _ in reqs], want, got, 12)


# -- hot weight swaps ---------------------------------------------------------
def _float_side_file(model, path):
    params = {n: p for n, p in model.named_parameters()}
    ptt.save({"params": params, "buffers": {}}, path)
    return path


def test_float_swap_follows_the_donor_and_rejects_mismatches(models,
                                                             tmp_path):
    _, donor = _jax_pair(77)
    ptt.seed(5)
    served = GPTForCausalLM(gpt_tiny(**TINY), device="cpu").eval()
    p = np.arange(1, 9)
    want = _ref_greedy(donor, p, 6)
    path = _float_side_file(donor, str(tmp_path / "donor.pdiparams"))
    with GenerationEngine(served, prompt_buckets=[16], batch_size=2,
                          name="pt-swap-f") as eng:
        eng.warmup()
        before = eng.generate(p, 6, timeout=60).tolist()
        mine = {k: v.clone() for k, v in served.state_dict().items()}
        ptrs = [t.data_ptr() for t in eng._model.state_dict().values()]
        eng.swap_weights(path)
        after = eng.generate(p, 6, timeout=60).tolist()
        assert after == want and before != want
        # copied into the engine's own tensors in place; the caller's
        # model is untouched
        assert eng._model is not served
        assert ptrs == [t.data_ptr()
                        for t in eng._model.state_dict().values()]
        for k, v in served.state_dict().items():
            assert torch.equal(v, mine[k]), k
        assert eng.stats()["weight_swaps"] == 1
        # a wider model's file, a missing leaf, a wrong dtype, a quantized
        # artifact: each rejected, nothing touched
        wide = GPTForCausalLM(gpt_tiny(**dict(TINY, hidden_size=48)),
                              device="cpu")
        bad = [_float_side_file(wide, str(tmp_path / "wide.pdiparams"))]
        params = {n: t for n, t in donor.named_parameters()}
        params.pop("gpt.ln_f.bias")
        ptt.save({"params": params}, str(tmp_path / "missing.pdiparams"))
        bad.append(str(tmp_path / "missing.pdiparams"))
        params = {n: t.double() for n, t in donor.named_parameters()}
        ptt.save({"params": params}, str(tmp_path / "f64.pdiparams"))
        bad.append(str(tmp_path / "f64.pdiparams"))
        bad.append(slim.export_quantized(donor, str(tmp_path / "q8"),
                                         mode="int8"))
        ptt.save({"weights": {}}, str(tmp_path / "junk.pdiparams"))
        bad.append(str(tmp_path / "junk.pdiparams"))
        for b in bad:
            with pytest.raises(InvalidArgumentError):
                eng.swap_weights(b)
        assert eng.generate(p, 6, timeout=60).tolist() == want
        assert eng.stats()["weight_swaps"] == 1


def test_swap_reaches_only_its_engine(models, tmp_path):
    # two float engines over one model: swaps on one while the other
    # decodes leave the other's tokens and the caller's model as they were
    _, donor = _jax_pair(77)
    ptt.seed(5)
    served = GPTForCausalLM(gpt_tiny(**TINY), device="cpu").eval()
    mine = {k: v.clone() for k, v in served.state_dict().items()}
    p = np.arange(1, 9)
    want_a, want_b = _ref_greedy(donor, p, 6), _ref_greedy(served, p, 48)
    path = _float_side_file(donor, str(tmp_path / "donor.pdiparams"))
    kw = dict(prompt_buckets=[16], batch_size=2)
    with GenerationEngine(served, name="pt-swap-a", **kw) as a, \
            GenerationEngine(served, name="pt-swap-b", **kw) as b:
        fut = b.submit(p, 48)
        swaps = 0
        while not fut.done() or swaps < 2:
            a.swap_weights(path)
            swaps += 1
        assert fut.result(60).tolist() == want_b
        assert a.generate(p, 6, timeout=60).tolist() == want_a
        assert b.generate(p, 6, timeout=60).tolist() == want_b[:6]
        assert a.stats()["weight_swaps"] == swaps
        assert b.stats()["weight_swaps"] == 0
    for k, v in served.state_dict().items():
        assert torch.equal(v, mine[k]), k


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_swap_of_an_artifact(mode, tmp_path):
    ptt.seed(5)
    served = GPTForCausalLM(gpt_tiny(**TINY), device="cpu").eval()
    ptt.seed(6)
    donor = GPTForCausalLM(gpt_tiny(**TINY), device="cpu").eval()
    art = slim.export_quantized(donor, str(tmp_path / "donor"), mode=mode)
    assert art.endswith(".pdiparams")
    assert os.path.exists(art + ".manifest.json")
    other = slim.export_quantized(donor, str(tmp_path / "other"),
                                  mode={"int8": "fp8", "fp8": "int8"}[mode])
    p = np.arange(1, 9)
    # batch 1: a quantized linear's per-tensor activation scale sees every
    # row of a call, and a free row decodes whatever token its slot last
    # produced — which differs between an engine that served other
    # weights before and a fresh one
    kw = dict(prompt_buckets=[16], batch_size=1, quantized=mode)
    for continuous in (True, False):
        # the same scheduler on both sides: per-tensor activation scales
        # see the legacy batch's dummy rows, which decode real positions
        with GenerationEngine(donor, name="pt-qswap-ref",
                              continuous=continuous, **kw) as ref_eng:
            want = ref_eng.generate(p, 6, timeout=60).tolist()
        with GenerationEngine(served, name="pt-qswap", continuous=continuous,
                              **kw) as eng:
            before = eng.generate(p, 6, timeout=60).tolist()
            with pytest.raises(InvalidArgumentError, match="quantized"):
                eng.swap_weights(other)  # mode mismatch
            eng.swap_weights(art)
            assert eng.generate(p, 6, timeout=60).tolist() == want != before
            # the caller's float model is untouched by a quantized swap
            assert eng._model is not served
            assert served.gpt.blocks[0].attn.qkv.weight.dtype == \
                torch.float32


@pytest.mark.parametrize("quantized", [None, "int8"])
def test_reload_weights_after_load(quantized, tmp_path):
    ptt.seed(5)
    served = GPTForCausalLM(gpt_tiny(**TINY), device="cpu").eval()
    ptt.seed(6)
    donor = GPTForCausalLM(gpt_tiny(**TINY), device="cpu").eval()
    p = np.arange(1, 9)
    kw = dict(prompt_buckets=[16], batch_size=1, quantized=quantized)
    with GenerationEngine(donor, name="pt-reload-ref", **kw) as ref_eng:
        want = ref_eng.generate(p, 6, timeout=60).tolist()
    ptt.save(donor.state_dict(), str(tmp_path / "donor.pdparams"))
    with GenerationEngine(served, name="pt-reload", **kw) as eng:
        before = eng.generate(p, 6, timeout=60).tolist()
        served.set_state_dict(ptt.load(str(tmp_path / "donor.pdparams")))
        eng.reload_weights()
        assert eng.generate(p, 6, timeout=60).tolist() == want != before
        assert eng.stats()["weight_swaps"] == 1


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_artifacts_cross_between_the_packages(models, mode, tmp_path):
    # a JAX export_quantized artifact swaps into the port's engine; the
    # port's artifact holds the same tree (fp8 codes widened to float32,
    # exactly, as every file the port writes), and its int8 one swaps into
    # the JAX engine
    jm, _ = models
    jdonor, tdonor = _jax_pair(91)
    jart = jslim.export_quantized(jdonor, str(tmp_path / "jax"), mode=mode)
    tart = slim.export_quantized(tdonor, str(tmp_path / "port"), mode=mode)
    jtree, ttree = jserialization.load(jart), jserialization.load(tart)
    assert jtree["quantization"] == ttree["quantization"] == mode
    assert set(jtree["params"]) == set(ttree["params"])
    assert set(jtree["buffers"]) == set(ttree["buffers"])
    for part in ("params", "buffers"):
        for n, a in jtree[part].items():
            a, b = np.asarray(a), np.asarray(ttree[part][n])
            if a.dtype.name == "float8_e4m3fn":
                assert b.dtype == np.float32, n
                a = a.astype(np.float32)
            assert a.dtype == b.dtype, n
            np.testing.assert_array_equal(b, a)
    p = np.arange(1, 9)
    kw = dict(prompt_buckets=[16], batch_size=2, speculative_k=0,
              quantized=mode)
    if mode == "int8":
        with JaxGenerationEngine(jm, name="pt-x-jax", **kw) as je:
            je.swap_weights(tart)
            jout = je.generate(p, 6, timeout=120).tolist()
    else:
        with JaxGenerationEngine(jdonor, name="pt-x-jax", **kw) as je:
            jout = je.generate(p, 6, timeout=120).tolist()
    ptt.seed(5)
    served = GPTForCausalLM(gpt_tiny(**TINY), device="cpu").eval()
    with GenerationEngine(served, name="pt-x", **kw) as te:
        te.swap_weights(jart)  # fp8: ml_dtypes leaves, bit for bit
        tout = te.generate(p, 6, timeout=120).tolist()
    _agree(jslim.quantize_weights(copy.deepcopy(jdonor), mode), [p],
           [jout], [tout], 3)
