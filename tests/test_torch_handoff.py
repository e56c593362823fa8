"""Prefill/decode KV hand-off in the port (paddle_tpu_torch/serving).

On the CPU at ``gpt_tiny`` size, weights bridged from the JAX package:

* ``PagePool.adopt`` against the JAX pool's accounting, exactly (tables,
  position maps, refcounts, counters), rollback on exhaustion included;
* ``GPTModel.gather_pages`` / ``scatter_pages`` against JAX's on the same
  pool contents: float payloads equal, int8 / fp8 payloads and scales
  bit-equal (fp8 pages travel as their ``uint8`` bits), round trips
  bit-equal, and the write-drop page after an import with several
  ``-1`` destinations reads what JAX's reads;
* a ``role="prefill"`` engine's hand-offs adopted by a ``role="decode"``
  engine give the tokens of one co-located paged engine, bit for bit —
  float, int8 and fp8 pools — and equal the JAX hand-off's tokens (a
  disagreement must be a JAX near-tie);
* the role errors of ``GenerationEngine`` and ``submit``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu.serving.paging import PagePool as JaxPagePool
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving import GenerationEngine, KVHandoff, PagePool

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_position=64)
MARGIN_TIE = 1e-4
PAGED = dict(prompt_buckets=[8, 16], batch_size=2, paged=True,
             kv_page_size=8, speculative_k=2)
QDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
JQDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(2)
    pt.seed(2024)
    jm = JaxGPT(jax_gpt_tiny(**TINY))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(**TINY), device="cpu")
    load_jax_params(tm, {k: np.asarray(p.value)
                         for k, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


# -- accounting ---------------------------------------------------------------
def _state(p):
    return (p.table.tolist(), p.pos_map.tolist(), p.stats(), p.free_pages)


def test_adopt_matches_the_jax_pool_exactly():
    kw = dict(num_slots=3, num_pages=6, page_size=4, max_len=16)
    tp, jp = PagePool(**kw), JaxPagePool(**kw)
    prompt = np.arange(6, dtype=np.int32)
    for pool in (tp, jp):
        pool.admit(0, prompt)
        pool.register_prefix("sys", 0, prompt)
    for slot, length in ((1, 9), (2, 4)):
        assert tp.adopt(slot, length) == jp.adopt(slot, length)
        assert _state(tp) == _state(jp)
    assert tp.stats()["kv_adoptions"] == 2 == tp.adoptions
    for pool in (tp, jp):
        pool.release(1)
    assert _state(tp) == _state(jp)
    # exhaustion: both roll the slot back and raise
    for pool in (tp, jp):
        with pytest.raises(MemoryError, match="adoption"):
            pool.adopt(1, 16)  # 4 pages, 3 free
    assert _state(tp) == _state(jp)
    for pool in (tp, jp):
        pool.release(2)
        pool.release(0)
        pool.drop_all_prefixes()
    assert _state(tp) == _state(jp)
    assert tp.leaked_pages() == 0 and tp.free_pages == 6


# -- page payloads ------------------------------------------------------------
def _pools(jm, tm, qdtype=None, seed=0):
    """A JAX pool and a port pool holding the same seeded contents
    (quantized ones: the same codes and scales)."""
    jc = jm.gpt.init_paged_cache(6, 4, dtype=None if qdtype is None
                                 else JQDT[qdtype])
    tc = tm.gpt.init_paged_cache(6, 4, dtype=None if qdtype is None
                                 else QDT[qdtype])
    rng = np.random.RandomState(seed)
    new = []
    for jl, tl in zip(jc["layers"], tc["layers"]):
        nl = {}
        for key, jt in jl.items():
            if key.endswith("scale"):
                a = rng.rand(*jt.shape).astype(np.float32)
            elif qdtype == "int8":
                a = rng.randint(-127, 128, jt.shape).astype(np.int8)
            elif qdtype == "fp8":
                a = np.asarray(jnp.asarray(
                    rng.randn(*jt.shape) * 8, jnp.float32).astype(
                        jnp.float8_e4m3fn))
            else:
                a = rng.randn(*jt.shape).astype(np.float32)
            nl[key] = jnp.asarray(a)
            if qdtype == "fp8" and not key.endswith("scale"):
                tl[key].view(torch.uint8).copy_(
                    torch.from_numpy(_bits(a).copy()))
            else:
                tl[key].copy_(torch.from_numpy(np.array(a)))
        new.append(nl)
    return {"layers": new}, tc


def _payload_equal(jpay, tpay, quantized):
    if quantized:
        np.testing.assert_array_equal(_bits(tpay[0]), _bits(jpay[0]))
        np.testing.assert_array_equal(tpay[1], np.asarray(jpay[1]))
    else:
        np.testing.assert_array_equal(tpay, np.asarray(jpay))


@pytest.mark.parametrize("qdtype", [None, "int8", "fp8"])
def test_gather_scatter_pages_match_jax_bit_for_bit(models, qdtype):
    jm, tm = models
    jc, tc = _pools(jm, tm, qdtype)
    idx = np.array([3, -1, 0], np.int32)
    jpay = jm.gpt.gather_pages(jc, jnp.asarray(idx))
    tpay = tm.gpt.gather_pages(tc, idx)
    quantized = qdtype is not None
    assert isinstance(tpay, tuple) == quantized
    pages = tpay[0] if quantized else tpay
    assert pages.shape == (2, 2, 3, 4, 4, 8)  # [L, 2, K, H, page, hd]
    assert pages.dtype == {None: np.float32, "int8": np.int8,
                           "fp8": np.uint8}[qdtype]
    _payload_equal(jpay, tpay, quantized)
    # import into another pool, drop destinations included; an exported
    # payload's -1 entries all hold the donor's drop page
    jd, td = _pools(jm, tm, qdtype, seed=1)
    dst = np.array([5, -1, 1], np.int32)
    jd = jm.gpt.scatter_pages(jd, jpay, jnp.asarray(dst))
    assert tm.gpt.scatter_pages(td, tpay, dst) is td  # in place
    for jl, tl in zip(jd["layers"], td["layers"]):
        for key in jl:
            np.testing.assert_array_equal(_bits(tl[key]), _bits(jl[key]))
    # round trip: the pages read back are the pages sent
    back = tm.gpt.gather_pages(td, np.array([5, 1]))
    if quantized:
        np.testing.assert_array_equal(_bits(back[0]),
                                      _bits(pages[:, :, [0, 2]]))
        np.testing.assert_array_equal(back[1], tpay[1][:, :, [0, 2]])
    else:
        np.testing.assert_array_equal(back, pages[:, :, [0, 2]])
    # a -1 gather after the import reads what JAX's reads
    _payload_equal(jm.gpt.gather_pages(jd, jnp.asarray([-1])),
                   tm.gpt.gather_pages(td, [-1]), quantized)


def test_repeated_drop_destinations_keep_the_last_entry_as_jax(models):
    jm, tm = models
    jc, tc = _pools(jm, tm)
    rng = np.random.RandomState(7)
    pay = rng.randn(2, 2, 4, 4, 4, 8).astype(np.float32)  # 4 distinct pages
    dst = np.array([-1, 2, -1, -1], np.int32)
    jc = jm.gpt.scatter_pages(jc, jnp.asarray(pay), jnp.asarray(dst))
    tm.gpt.scatter_pages(tc, pay, dst)
    for jl, tl in zip(jc["layers"], tc["layers"]):
        for key in jl:
            np.testing.assert_array_equal(tl[key].numpy(),
                                          np.asarray(jl[key]))
    np.testing.assert_array_equal(tc["layers"][0]["k"][6].numpy(),
                                  pay[0, 0, 3])  # P = 6: the last -1 entry


def test_quantized_pool_needs_the_scales_pair(models):
    _, tm = models
    tc = tm.gpt.init_paged_cache(4, 4, dtype=torch.int8)
    with pytest.raises(InvalidArgumentError, match="scales"):
        tm.gpt.scatter_pages(tc, np.zeros((2, 2, 1, 4, 4, 8), np.int8), [0])


# -- engines ------------------------------------------------------------------
def _requests(seed=11, n=5):
    rng = np.random.RandomState(seed)
    reqs = [(rng.randint(0, 97, size=int(rng.randint(3, 16))),
             int(rng.randint(2, 12))) for _ in range(n)]
    reqs.append((rng.randint(0, 97, size=5), 1))  # done at the prefill
    return reqs


@pytest.mark.parametrize("quantized", [None, "int8", "fp8"])
def test_handoff_tokens_bit_identical_to_co_located(models, quantized):
    _, tm = models
    reqs = _requests()
    kw = dict(PAGED, quantized=quantized)
    with GenerationEngine(tm, name="pt-co", **kw) as co:
        co.warmup()
        want = [co.generate(p, n, timeout=120).tolist() for p, n in reqs]
    with GenerationEngine(tm, role="prefill", name="pt-pre", **kw) as pre, \
            GenerationEngine(tm, role="decode", name="pt-dec", **kw) as dec:
        pre.warmup()
        dec.warmup()
        if quantized:
            # one request at a time, as the co-located engine ran them: a
            # quantized linear's per-tensor activation scale sees every
            # row of a call
            hands = [pre.submit(p, n, handoff=True).result(120)
                     for p, n in reqs]
        else:
            hands = [pre.submit(p, n, handoff=True) for p, n in reqs]
            hands = [h.result(120) for h in hands]
        for h, (p, n) in zip(hands, reqs):
            assert isinstance(h, KVHandoff)
            assert h.prompt.tolist() == [int(t) for t in p]
            assert h.length == len(p) and h.done == (n <= 1)
            pages = h.kv[0] if quantized else h.kv
            assert pages.shape == (2, 2, 2, 4, 8, 8)  # Gh = 16 / 8 pages
            if quantized:
                assert h.kv[1].shape == (2, 2, 2, 4, 8)
        if quantized:
            got = [dec.submit(p, n, handoff=h).result(120).tolist()
                   for (p, n), h in zip(reqs, hands)]
        else:
            got = [dec.submit(p, n, handoff=h)
                   for (p, n), h in zip(reqs, hands)]
            got = [f.result(120).tolist() for f in got]
        pst, dst = pre.stats(), dec.stats()
    assert got == want
    assert pst["handoffs_out"] == len(reqs) and pst["decode_steps"] == 0
    assert dst["handoffs_in"] == len(reqs) and dst["kv_adoptions"] == \
        len(reqs)
    assert pst["kv_pages_leaked"] == dst["kv_pages_leaked"] == 0
    assert pst["kv_pages_free"] == dst["kv_pages_free"] == 16  # all back


def test_handoff_tokens_match_the_jax_handoff(models):
    jm, tm = models
    reqs = _requests(seed=5, n=4)
    kw = dict(PAGED)
    with JaxGenerationEngine(jm, role="prefill", name="pt-jpre", **kw) as \
            jpre, JaxGenerationEngine(jm, role="decode", name="pt-jdec",
                                      **kw) as jdec:
        hands = [jpre.submit(p, n, handoff=True).result(300)
                 for p, n in reqs]
        want = [jdec.submit(p, n, handoff=h).result(300).tolist()
                for (p, n), h in zip(reqs, hands)]
    with GenerationEngine(tm, role="prefill", name="pt-tpre", **kw) as pre, \
            GenerationEngine(tm, role="decode", name="pt-tdec", **kw) as dec:
        got = [dec.submit(p, n, handoff=pre.submit(
            p, n, handoff=True).result(120)).result(120).tolist()
            for p, n in reqs]
    compared = 0
    for (p, _), w, g in zip(reqs, want, got):
        for j, (a, b) in enumerate(zip(w, g)):
            if a != b:
                ids = [int(t) for t in p] + w[:j]
                logits = np.asarray(jm(jnp.asarray([ids], jnp.int32)))[0, -1]
                top2 = np.sort(logits)[-2:]
                assert top2[1] - top2[0] < MARGIN_TIE, (a, b)
                break
            compared += 1
        else:
            assert len(w) == len(g)
    assert compared >= 12


def test_role_rules(models):
    _, tm = models
    with pytest.raises(InvalidArgumentError, match="role"):
        GenerationEngine(tm, prompt_buckets=[8], paged=True, role="both")
    with pytest.raises(InvalidArgumentError, match="paged"):
        GenerationEngine(tm, prompt_buckets=[8], role="prefill")
    p = np.arange(4)
    with GenerationEngine(tm, role="prefill", name="pt-r1", **PAGED) as pre, \
            GenerationEngine(tm, role="decode", name="pt-r2",
                             **PAGED) as dec, \
            GenerationEngine(tm, name="pt-r3", **PAGED) as co, \
            GenerationEngine(tm, prompt_buckets=[8], name="pt-r4") as dense:
        h = pre.submit(p, 4, handoff=True).result(60)
        with pytest.raises(InvalidArgumentError, match="prefill"):
            dec.submit(p, 4, handoff=True)
        with pytest.raises(InvalidArgumentError, match="prefill"):
            co.submit(p, 4, handoff=True)
        with pytest.raises(InvalidArgumentError, match="decode"):
            pre.submit(p, 4, handoff=h)
        with pytest.raises(InvalidArgumentError, match="paged"):
            dense.submit(p, 4, handoff=True)
        with pytest.raises(InvalidArgumentError, match="KVHandoff"):
            dec.submit(p, 4, handoff="pages")
        with pytest.raises(InvalidArgumentError, match="cache_len"):
            dec.submit(p, 4, handoff=h._replace(length=10_000))
        # plain submits work on every role (health probes)
        for eng in (pre, dec):
            assert eng.generate(eng.synthetic_inputs(), 2,
                                timeout=60).shape == (2,)
