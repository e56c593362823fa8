"""A mixture-of-experts model in every serving engine of the port, held
against the JAX package (``paddle_tpu.serving.GenerationEngine``).

On the CPU at a tiny MoE GPT (2 layers, 4 experts, top-2, jitter 0), weights
bridged from the JAX package (``load_jax_params``):

* the default dense-ring engine and the legacy scheduler mirror
  ``tests/test_moe.py::TestExpertShardedDecode`` (capacity factor = E: no
  token is dropped, so batched routing is per token and the served tokens
  equal the uncached greedy and the JAX engine's), with the routing
  counters: ``moe_routed_tokens`` = layers x top_k x batch x decode steps,
  inert rows included;
* the warm-up rule: no engine of the port counts a warm-up step (nor a
  step of an engine never warmed), where the JAX tap folds all warm-up
  calls but the last;
* quantized MoE engines (int8 / fp8; the experts stay float) against the
  JAX quantized engines, dense and paged, one request at a time (a
  quantized linear's per-tensor activation scale sees every row of a
  call), a disagreement allowed only at a JAX near-tie (top-1 margin below
  1e-4);
* the prefill/decode hand-off and ``swap_weights`` of an MoE engine.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu import slim as jslim
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import GenerationEngine as JaxEngine
import paddle_tpu_torch as tpt
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import grouped_matmul
from paddle_tpu_torch.serving import GenerationEngine, KVHandoff

CFG = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4,
           max_position=64, dropout=0.0, moe_top_k=2, moe_jitter=0.0)
E, LAYERS, TOP_K = 4, 2, 2
PROMPTS = [np.random.RandomState(k).randint(1, 61, size=3 + k).astype(
    np.int32) for k in range(3)]
NEW = 6
MARGIN_TIE = 1e-4
PAGED = dict(paged=True, kv_page_size=8, speculative_k=0)


def _models(seed=9, cf=float(E)):
    jpt.seed(seed)
    kw = dict(CFG, moe_experts=E, moe_capacity_factor=cf)
    jmodel = jgpt.GPTForCausalLM(jgpt.GPTConfig(**kw))
    jmodel.eval()
    tmodel = tgpt.GPTForCausalLM(tgpt.GPTConfig(**kw), device="cpu")
    load_jax_params(tmodel, {k: np.asarray(p.value)
                             for k, p in jmodel.named_parameters()})
    return jmodel, tmodel.eval()


@pytest.fixture(scope="module")
def ample():
    torch.set_num_threads(2)
    return _models()


def _greedy(model, prompt, n):
    ids, out = list(map(int, prompt)), []
    with torch.no_grad():
        for _ in range(n):
            out.append(int(model(torch.tensor([ids]))[0, -1].argmax()))
            ids.append(out[-1])
    return out


def _margin(jm, ids):
    logits = np.asarray(jm(jnp.asarray([ids], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _agree(jm, want, got, min_compared):
    """Token lists equal, or diverging first at a near-tie of ``jm``."""
    compared = 0
    for p, w, g in zip(PROMPTS, want, got):
        for j, (a, b) in enumerate(zip(w, g)):
            if a != b:
                margin = _margin(jm, [int(t) for t in p] + w[:j])
                assert margin < MARGIN_TIE, (
                    f"clear-margin flip: jax {a} port {b} margin {margin}")
                break
            compared += 1
        else:
            assert len(w) == len(g)
    assert compared >= min_compared


@pytest.mark.parametrize("continuous", [True, False])
def test_dense_engines_serve_moe_tokens_and_counters(ample, continuous):
    """tests/test_moe.py:256-277 on the dense ring and the legacy
    scheduler: tokens = uncached greedy = the JAX engine's, the counters
    published, every routed row counted."""
    jmodel, tmodel = ample
    launches = grouped_matmul.launches
    B = 2
    with GenerationEngine(tmodel, prompt_buckets=[8], batch_size=B,
                          continuous=continuous,
                          name=f"moe-dense-{continuous}") as eng:
        eng.warmup()
        assert eng.stats()["moe_routed_tokens"] == 0  # warm-up uncounted
        outs = [eng.submit(p, NEW).result(120).tolist() for p in PROMPTS]
    st = eng.stats()  # after close: every in-flight step folded
    with JaxEngine(jmodel, prompt_buckets=[8], batch_size=B,
                   continuous=continuous,
                   name=f"moe-dense-jax-{continuous}") as jeng:
        jeng.warmup()
        jouts = [jeng.submit(p, NEW).result(300).tolist() for p in PROMPTS]
    for p, o, jo in zip(PROMPTS, outs, jouts):
        assert o == _greedy(tmodel, p, NEW) == jo
    assert st["decode_steps"] > 0
    assert st["moe_routed_tokens"] == LAYERS * TOP_K * B * st["decode_steps"]
    assert st["moe_dropped_tokens"] == 0 and st["moe_overflow_frac"] == 0.0
    assert st["moe_sampled_steps_after_warm"] == st["decode_steps"]
    assert st["moe_overflow_steps_after_warm"] == 0
    assert 0 <= st["moe_dead_experts"] < E
    assert grouped_matmul.launches == launches  # the CPU never launches


def test_overflow_is_counted_at_a_tight_capacity():
    """Capacity factor 0.5 over 4 experts at batch 2: C = ceil(2·2·0.5/4)
    = 1 slot an expert, so a decode step of 2 rows x 2 choices drops
    assignments whenever two rows pick one expert; every assignment is
    routed or dropped."""
    _, tmodel = _models(seed=11, cf=0.5)
    with GenerationEngine(tmodel, prompt_buckets=[8], batch_size=2,
                          name="moe-tight") as eng:
        eng.warmup()
        outs = [eng.submit(p, NEW) for p in PROMPTS]
        assert all(len(f.result(120)) == NEW for f in outs)
    st = eng.stats()
    assert (st["moe_routed_tokens"] + st["moe_dropped_tokens"]
            == LAYERS * TOP_K * 2 * st["decode_steps"])
    assert st["moe_dropped_tokens"] > 0
    assert st["moe_overflow_steps_after_warm"] > 0
    assert st["moe_overflow_frac"] >= 0.0


@pytest.mark.parametrize("paged", [False, True])
def test_warmup_steps_are_not_counted_where_the_jax_tap_counts_them(
        ample, paged):
    """The port follows the paged engine's rule in every mode: no warm-up
    step is counted.  The JAX tap folds the token totals of every tapped
    warm-up call but the last (two prompt buckets: two warm-up decodes in
    the dense mode; the paged warm-up runs its step several times)."""
    jmodel, tmodel = ample
    kw = dict(prompt_buckets=[4, 8], batch_size=2,
              **(PAGED if paged else {}))
    with GenerationEngine(tmodel, name=f"moe-warm-{paged}", **kw) as eng:
        eng.warmup()
        st = eng.stats()
    with JaxEngine(jmodel, name=f"moe-warm-jax-{paged}",
                   continuous=True, **kw) as jeng:
        jeng.warmup()
        jst = jeng.stats()
    assert st["moe_routed_tokens"] == 0
    assert st["moe_sampled_steps_after_warm"] == 0
    assert jst["moe_routed_tokens"] > 0
    assert jst["moe_sampled_steps_after_warm"] == 0
    # an engine never warmed counts none of its steps, as the paged one
    with GenerationEngine(tmodel, name=f"moe-cold-{paged}", **kw) as cold:
        assert len(cold.generate(PROMPTS[0], NEW, timeout=120)) == NEW
    assert cold.stats()["decode_steps"] > 0
    assert cold.stats()["moe_routed_tokens"] == 0


@pytest.fixture
def jax_paged_kernel(monkeypatch):
    """The JAX ``forward_paged`` through its Pallas paged kernel (interpret
    mode), as on a TPU: its CPU gather fallback treats padding rows
    differently, and per-tensor activation scales see them."""
    monkeypatch.setattr(jgpt, "_paged_flash", lambda hd, page: True)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_moe_engine_matches_the_jax_quantized_engine(
        ample, mode, paged, jax_paged_kernel):
    jmodel, _ = ample
    jm = copy.deepcopy(jmodel)
    params, buffers = jslim.quantize_model_trees(jm, mode)
    # only the attention's parallel linears are quantized: the experts
    # stay float in both packages
    assert str(params["gpt.blocks.0.attn.qkv.weight"].dtype) in (
        "int8", "float8_e4m3fn")
    assert params["gpt.blocks.0.mlp.expert_fc1"].dtype == jnp.float32
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**dict(
        CFG, moe_experts=E, moe_capacity_factor=float(E))), device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in params.items()},
                    {k: np.asarray(v) for k, v in buffers.items()})
    tm.eval()
    kw = dict(prompt_buckets=[8], batch_size=2, quantized=mode,
              **(PAGED if paged else dict(paged=False)))
    with JaxEngine(jm, name=f"qmoe-jax-{mode}-{paged}", continuous=True,
                   **kw) as je:
        want = [je.generate(p, NEW, timeout=300).tolist() for p in PROMPTS]
    with GenerationEngine(tm, name=f"qmoe-{mode}-{paged}", **kw) as te:
        te.warmup()
        assert te.quant_active and te.stats()["quantization"] == mode
        experts = te._model.gpt.blocks[0].mlp.expert_fc1
        assert experts.dtype == torch.float32
        got = [te.generate(p, NEW, timeout=300).tolist() for p in PROMPTS]
    st = te.stats()
    assert st["completed"] == len(PROMPTS)
    assert st["moe_routed_tokens"] > 0 and st["moe_dropped_tokens"] == 0
    jq = jslim.quantize_weights(copy.deepcopy(jmodel), mode)
    _agree(jq, want, got, 12)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_moe_gpt_config_builds_and_quantizes_attention_only(mode):
    tpt.seed(2)
    m = tgpt.GPTForCausalLM(tgpt.gpt_tiny(moe_experts=2, quantization=mode),
                            device="cpu").eval()
    qdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[mode]
    blk = m.gpt.blocks[0]
    assert blk.attn.qkv.weight.dtype == blk.attn.out.weight.dtype == qdt
    assert blk.mlp.expert_fc1.dtype == torch.float32
    with torch.no_grad():
        logits = m(torch.arange(8)[None])
    assert logits.shape == (1, 8, 128) and torch.isfinite(logits).all()


def test_moe_handoff_tokens_equal_a_co_located_engine(ample):
    _, tmodel = ample
    kw = dict(prompt_buckets=[8], batch_size=2, **PAGED)
    with GenerationEngine(tmodel, name="moe-colo", **kw) as colo:
        want = [colo.generate(p, NEW, timeout=120).tolist()
                for p in PROMPTS]
    with GenerationEngine(tmodel, role="prefill", name="moe-pre",
                          **kw) as pre, \
            GenerationEngine(tmodel, role="decode", name="moe-dec",
                             **kw) as dec:
        dec.warmup()  # steps count once the engine is warm
        hands = [pre.submit(p, NEW, handoff=True).result(120)
                 for p in PROMPTS]
        assert all(isinstance(h, KVHandoff) for h in hands)
        got = [dec.submit(p, NEW, handoff=h).result(120).tolist()
               for p, h in zip(PROMPTS, hands)]
    assert got == want
    assert dec.stats()["moe_routed_tokens"] > 0


def test_moe_swap_weights_follows_the_donor(ample, tmp_path):
    _, served = ample
    _, donor = _models(seed=21)
    path = str(tmp_path / "donor.pdiparams")
    tpt.save({"params": dict(donor.named_parameters()), "buffers": {}},
             path)
    p = PROMPTS[2]
    with GenerationEngine(served, prompt_buckets=[8], batch_size=2,
                          name="moe-swap") as eng:
        eng.warmup()
        before = eng.generate(p, NEW, timeout=120).tolist()
        eng.swap_weights(path)
        after = eng.generate(p, NEW, timeout=120).tolist()
        st = eng.stats()
    assert before == _greedy(served, p, NEW)
    assert after == _greedy(donor, p, NEW) != before
    assert st["weight_swaps"] == 1 and st["moe_routed_tokens"] > 0
