"""Quantized paged serving in the port (int8 / fp8-e4m3 weights and KV
pools), held against the JAX package on the CPU at a tiny size.

The same numpy inputs, made from a seed, go through both packages.  KV
quantization (``_quantize_kv``) must give EQUAL codes and scales.  The
weights come from ONE JAX ``quantize_model_trees`` output carried over by
``bridge.load_jax_params``, so both models compute from identical
quantized weights: a ``forward_paged`` prefill + decode step agrees in the
logits (atol 1e-4) and in the pool's codes; the port's quantized engine
serves the JAX quantized engine's tokens.  Then the invariants of
tests/test_quantized_serving.py that apply to the port: copy-on-write
moves the scale planes, a bad mode is rejected, a quantized weight
without its scale raises, and the caller's float model is bit-identical
after a quantized engine was built over it.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu.models.gpt as jgpt
from paddle_tpu import slim as jslim
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import _quantize_kv as jax_quantize_kv
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu_torch import slim
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               NotFoundError)
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         _quantize_kv)
from paddle_tpu_torch.serving import GenerationEngine

CACHE, PAGE = 32, 8
TINY = dict(vocab_size=53, hidden_size=32, num_layers=2, num_heads=4,
            max_position=CACHE, dropout=0.0)
MODES = ["int8", "fp8"]
QDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
JQDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
MARGIN_TIE = 1e-4


def _bits(t):
    """Raw storage of a quantized tensor/array as uint8 numpy."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _float_model():
    return GPTForCausalLM(GPTConfig(**TINY), device="cpu",
                          generator=torch.Generator().manual_seed(3)).eval()


@pytest.fixture(scope="module")
def jax_model():
    torch.set_num_threads(2)
    pt.seed(3)
    jm = JaxGPT(JaxGPTConfig(**TINY))
    jm.eval()
    return jm


@pytest.fixture(scope="module", params=MODES)
def pair(request, jax_model):
    """(mode, JAX model quantized in place, port model carrying the JAX
    ``quantize_model_trees`` codes and scales)."""
    mode = request.param
    params, buffers = jslim.quantize_model_trees(jax_model, mode)
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in params.items()},
                    {k: np.asarray(v) for k, v in buffers.items()})
    tm.eval()
    jq = copy.deepcopy(jax_model)
    jslim.quantize_weights(jq, mode)
    return mode, jq, tm, params, buffers


@pytest.mark.parametrize("mode", MODES)
def test_quantize_kv_equal_codes_and_scales(mode):
    rng = np.random.RandomState(0)
    t = (rng.randn(6, 4, 8) * 2.0).astype(np.float32)
    t[2, 1] = 0.0  # a dead (token, head): amax floors at 1e-9
    jq, js = jax_quantize_kv(jnp.asarray(t), JQDT[mode])
    tq, ts = _quantize_kv(torch.from_numpy(t), QDT[mode])
    assert tq.dtype == QDT[mode]
    assert tuple(ts.shape) == (6, 4) and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # round-trip bound, as tests/test_quantized_serving.py states it
    amax = np.abs(t).max(-1)
    tol = amax / 127 / 2 + 1e-6 if mode == "int8" else amax * 0.0625
    recon = tq.float().numpy() * ts.numpy()[..., None]
    assert (np.abs(recon - t).max(-1) <= tol).all()


@pytest.mark.parametrize("mode,seed", [("int8", 1), ("fp8", 34)])
def test_quantize_kv_follows_the_jax_arithmetic(mode, seed):
    # at these seeds the natural neighbours of ``t * (127 / amax)`` — the
    # other order ``t / amax * 127``, and ``127.0 / amax`` with a Python
    # scalar, which torch evaluates as ``amax.reciprocal() * 127`` — each
    # change a code: equal codes show the port computes what JAX computes
    t = (np.random.RandomState(seed).randn(2048, 4, 8) * 2).astype(np.float32)
    jq, js = jax_quantize_kv(jnp.asarray(t), JQDT[mode])
    tq, ts = _quantize_kv(torch.from_numpy(t), QDT[mode])
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tf = torch.from_numpy(t)
    amax = tf.abs().amax(-1, keepdim=True)
    top = 127.0 if mode == "int8" else 448.0

    def codes(v):
        v = torch.round(v) if mode == "int8" else v
        return _bits(torch.clamp(v, -top, top).to(QDT[mode]))

    assert (codes(tf / amax * top) != _bits(tq)).sum() >= 1
    assert (codes(tf * (top / amax)) != _bits(tq)).sum() >= 1


def test_fp8_overflow_clips_not_nan():
    q, _ = _quantize_kv(torch.full((1, 1, 4), 1e4), torch.float8_e4m3fn)
    assert torch.isfinite(q.float()).all()


def _raw(t):
    return _bits(t) if t.element_size() == 1 else t.numpy()


def test_bridge_carries_the_jax_quantized_tree(pair, jax_model):
    mode, _, tm, params, buffers = pair
    names = [n for n, _ in slim.quantization._serving_targets(tm)]
    assert len(names) == 8 and "gpt.blocks.0.attn.qkv" in names
    sd = tm.state_dict()
    for n in names:
        assert sd[f"{n}.weight"].dtype == QDT[mode]
        np.testing.assert_array_equal(_bits(sd[f"{n}.weight"]),
                                      _bits(params[f"{n}.weight"]))
        np.testing.assert_array_equal(
            sd[f"{n}.weight_scale"].numpy(),
            np.asarray(buffers[f"{n}.weight_scale"]))
    # quantized weights are buffers, not parameters with a gradient
    assert not any(n.endswith("qkv.weight")
                   for n, _ in tm.named_parameters())
    # the port's own quantizer gives the same codes from the same floats
    # (quantize_model_trees left the JAX model's parameters float)
    fm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_jax_params(fm, {k: np.asarray(p.value)
                         for k, p in jax_model.named_parameters()})
    slim.quantize_weights(fm, mode)
    own = fm.state_dict()
    assert list(own) == list(sd)
    for k, v in own.items():
        assert v.dtype == sd[k].dtype, k
        np.testing.assert_array_equal(_raw(v), _raw(sd[k]), err_msg=k)
    # a quantized array needs its scale, and a float array cannot fill a
    # quantized slot
    arrays = {k: np.asarray(v) for k, v in params.items()}
    with pytest.raises(InvalidArgumentError, match="weight_scale"):
        load_jax_params(GPTForCausalLM(GPTConfig(**TINY), device="cpu"),
                        arrays)
    with pytest.raises(InvalidArgumentError, match="quantized"):
        load_jax_params(fm, {k: np.asarray(p.value)
                             for k, p in jax_model.named_parameters()})


def _paged_steps():
    """Prefill (slot 0: 5 tokens, slot 1: 11, padded to 12), then a T=1
    decode step.  Slot 0 maps page 3, slot 1 pages 0 and 5; G = 4."""
    rng = np.random.RandomState(1)
    table = np.array([[3, -1, -1, -1], [0, 5, -1, -1]], np.int32)
    lens = [5, 11]
    ids = np.zeros((2, 12), np.int32)
    pos = np.full((2, 12), -1, np.int32)
    pos_map = np.full((2, CACHE), -1, np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.randint(0, 53, size=n)
        pos[b, :n] = np.arange(n)
        pos_map[b, :n] = np.arange(n)
    steps = [(ids, pos, pos_map.copy())]
    pos_map[0, 5], pos_map[1, 11] = 5, 11
    steps.append((rng.randint(0, 53, size=(2, 1)).astype(np.int32),
                  np.array([[5], [11]], np.int32), pos_map.copy()))
    return table, steps


@pytest.fixture
def jax_paged_kernel(monkeypatch):
    """Run the JAX ``forward_paged`` through its Pallas paged kernel (in
    interpret mode), as on a TPU.  The CPU gather fallback gives padding
    rows a uniform softmax where the kernel gives zeros, and the
    per-tensor activation scale of the next quantized linear sees those
    rows — with the fallback, quantized tokens depend on the padding."""
    monkeypatch.setattr(jgpt, "_paged_flash", lambda hd, page: True)


def test_forward_paged_step_matches_jax(pair, jax_paged_kernel):
    mode, jq, tm, _, _ = pair
    table, steps = _paged_steps()
    jcache = jq.gpt.init_paged_cache(8, PAGE, dtype=JQDT[mode])
    tcache = tm.gpt.init_paged_cache(8, PAGE, dtype=QDT[mode])
    assert tcache["layers"][0]["k"].dtype == QDT[mode]
    assert tuple(tcache["layers"][0]["k_scale"].shape) == (9, 4, PAGE)
    with torch.no_grad():
        for ids, pos, pos_map in steps:
            want, jcache = jq.forward_paged(
                jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(pos_map),
                jnp.asarray(table), jcache)
            got, tcache = tm.forward_paged(
                torch.from_numpy(ids), torch.from_numpy(pos),
                torch.from_numpy(pos_map), torch.from_numpy(table), tcache)
            valid = pos >= 0
            # atol 1e-4: identical integer products; float noise enters
            # through LayerNorm/GELU and the attention softmax only
            np.testing.assert_allclose(got.numpy()[valid],
                                       np.asarray(want)[valid], rtol=0,
                                       atol=1e-4)
            # the pool after the scatter: equal codes, scales to float
            # noise (the write-drop page P = 8 collects padding writes in
            # an unspecified order: skip it)
            for jl, tl in zip(jcache["layers"], tcache["layers"]):
                for key in ("k", "v"):
                    np.testing.assert_array_equal(_bits(tl[key])[:8],
                                                  _bits(jl[key])[:8])
                    np.testing.assert_allclose(
                        tl[f"{key}_scale"].numpy()[:8],
                        np.asarray(jl[f"{key}_scale"])[:8], rtol=1e-5,
                        atol=0)


def _margin(jq, ids):
    logits = np.asarray(jq(jnp.asarray([ids], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def test_engine_tokens_match_the_jax_quantized_engine(pair, jax_model,
                                                      jax_paged_kernel):
    mode, jq, tm, _, _ = pair
    rng = np.random.RandomState(11)
    reqs = [(rng.randint(1, 53, size=int(rng.randint(3, 16))),
             int(rng.randint(4, 10))) for _ in range(4)]
    # one request at a time and no drafting: per-tensor activation scales
    # see the whole batch, so both engines must run the same batches
    kw = dict(prompt_buckets=[16], batch_size=2, cache_len=CACHE,
              paged=True, kv_page_size=PAGE, speculative_k=0)
    with JaxGenerationEngine(jax_model, name=f"ptq-jax-{mode}",
                             quantized=mode, **kw) as je:
        want = [je.generate(p, n, timeout=300).tolist() for p, n in reqs]
    # the port engine re-quantizes nothing: tm already carries JAX's codes
    with GenerationEngine(tm, name=f"ptq-{mode}", quantized=mode,
                          **kw) as te:
        te.warmup()
        assert te.quant_active and te.stats()["quantization"] == mode
        got = [te.generate(p, n, timeout=300).tolist() for p, n in reqs]
        st = te.stats()
    assert st["completed"] == 4 and st["kv_pages_leaked"] == 0
    compared = 0
    for (p, _), w, g in zip(reqs, want, got):
        for j, (a, b) in enumerate(zip(w, g)):
            if a != b:
                margin = _margin(jq, [int(t) for t in p] + w[:j])
                assert margin < MARGIN_TIE, (
                    f"clear-margin flip: jax {a} port {b} margin {margin}")
                break
            compared += 1
        else:
            assert len(w) == len(g)
    assert compared >= 16


@pytest.mark.parametrize("mode", MODES)
def test_float_model_unchanged_and_engines_isolated(mode):
    fm = _float_model()
    before = {k: v.clone() for k, v in fm.state_dict().items()}
    prompt = np.arange(1, 9, dtype=np.int32)
    kw = dict(prompt_buckets=[16], batch_size=2, cache_len=CACHE, paged=True,
              kv_page_size=PAGE, speculative_k=0)
    with GenerationEngine(fm, quantized=mode, name=f"ptq-iso-{mode}",
                          **kw) as qe, \
            GenerationEngine(fm, name=f"ptq-iso-f-{mode}", **kw) as fe:
        assert qe.quant_active and not fe.quant_active
        assert qe._model is not fm and fe._model is not fm  # own copies
        pool = qe._new_cache()["layers"][0]
        assert pool["k"].dtype == QDT[mode]
        assert pool["k_scale"].dtype == torch.float32
        assert "k_scale" not in fe._new_cache()["layers"][0]
        assert fe.stats()["quantization"] == "none"
        q_out = qe.generate(prompt, 6, timeout=120)
        f_out = fe.generate(prompt, 6, timeout=120)
        assert q_out.shape == f_out.shape == (6,)
    after = fm.state_dict()
    assert list(after) == list(before)
    for k, v in after.items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k
    assert all(p.requires_grad for p in fm.parameters())


def test_copy_pages_covers_scale_planes():
    gpt = _float_model().gpt
    pool = gpt.init_paged_cache(4, PAGE, dtype=torch.int8)
    l0 = pool["layers"][0]
    l0["k"][0] = 7
    l0["k_scale"][0] = 0.5
    l0["v_scale"][0] = 0.25
    out = gpt.copy_pages(pool, np.array([0, -1], np.int32),
                         np.array([3, -1], np.int32))
    ol0 = out["layers"][0]
    assert torch.equal(ol0["k"][3], ol0["k"][0]) and int(ol0["k"][3, 0, 0, 0]) == 7
    assert torch.all(ol0["k_scale"][3] == 0.5)
    assert torch.all(ol0["v_scale"][3] == 0.25)
    assert torch.all(ol0["k_scale"][1] == 0)  # untouched pages stay


def test_pool_dtypes_and_bad_dtype():
    gpt = _float_model().gpt
    for dt, want in (("int8", torch.int8), (torch.float8_e4m3fn,
                                            torch.float8_e4m3fn),
                     (None, torch.float32), ("bfloat16", torch.bfloat16)):
        layer = gpt.init_paged_cache(2, PAGE, dtype=dt)["layers"][0]
        assert layer["k"].dtype == want
        assert ("k_scale" in layer) == (want.itemsize == 1)
    with pytest.raises(InvalidArgumentError):
        gpt.init_paged_cache(2, PAGE, dtype=torch.int16)


def test_bad_mode_rejected():
    fm = _float_model()
    with pytest.raises(InvalidArgumentError, match="int4"):
        GenerationEngine(fm, prompt_buckets=[16], batch_size=2,
                         cache_len=CACHE, paged=True, quantized="int4")
    with pytest.raises(InvalidArgumentError):
        slim.quantize_weights(fm, "int4")
    with pytest.raises(ValueError):
        GPTConfig(**TINY, quantization="int4")


def test_missing_weight_scale_raises():
    qm = slim.quantize_model(_float_model(), "int8")
    del qm.gpt.blocks[0].attn.qkv.weight_scale
    with pytest.raises(InvalidArgumentError, match="weight_scale"):
        qm(torch.arange(6)[None])


@pytest.mark.parametrize("mode", MODES)
def test_config_quantization_quantizes_at_build(mode):
    gen = torch.Generator().manual_seed(3)
    qm = GPTForCausalLM(GPTConfig(**TINY, quantization=mode), device="cpu",
                        generator=gen).eval()
    want = slim.quantize_weights(_float_model(), mode)
    assert slim.quantize_weights(want, mode) is want  # idempotent
    for (ka, a), (kb, b) in zip(qm.state_dict().items(),
                                want.state_dict().items()):
        assert ka == kb and a.dtype == b.dtype
        assert np.array_equal(_raw(a), _raw(b)), ka
    assert qm.state_dict()["gpt.blocks.1.mlp.fc2.weight"].dtype == QDT[mode]
    ids = torch.arange(10)[None] % 53
    with torch.no_grad():
        dq, df = qm(ids), _float_model()(ids)
    # the quantized logits are the float logits plus quantization noise
    tol = {"int8": 0.1, "fp8": 0.25}[mode]
    assert float((dq - df).abs().max()) < tol * float(df.abs().max())


def test_unported_parts_keep_raising():
    fm = _float_model()
    # swaps and the hand-off roles are ported: a missing artifact is a
    # plain not-found error, a quantized prefill engine builds
    with GenerationEngine(fm, prompt_buckets=[16], batch_size=2,
                          cache_len=CACHE, paged=True, quantized="int8",
                          name="ptq-unported") as eng:
        with pytest.raises(NotFoundError):
            eng.swap_weights("no-such-artifact.pdiparams")
    GenerationEngine(fm, prompt_buckets=[16], paged=True, quantized="int8",
                     role="prefill").close()
    # a quantized paged engine takes a scheduler; a quantized MoE engine
    # builds
    from paddle_tpu_torch.serving import TenantScheduler

    GenerationEngine(fm, prompt_buckets=[16], paged=True, quantized="int8",
                     tenancy=TenantScheduler(["a"])).close()
    with GenerationEngine(GPTForCausalLM(GPTConfig(**TINY, moe_experts=2),
                                         device="cpu").eval(),
                          prompt_buckets=[16], paged=True,
                          quantized="int8") as eng:
        assert eng.quant_active
