"""Port of GPT (paddle_tpu_torch/models/gpt.py) held against the JAX model.

Weights are bridged from a JAX ``GPTForCausalLM`` by dotted name
(``load_jax_params``); the dense ``forward`` and the paged-KV
``forward_paged`` (prefill, then a decode step and a 2-wide verify step)
must agree on the CPU in fp32 — logits and the updated pool pages.
Tolerance rtol 2e-4 / atol 1e-5: XLA's CPU transcendentals (exp, erf,
rsqrt) are approximations (see the verify skill's gotchas).  Only valid
query rows (position >= 0) are compared: for padding rows the JAX CPU
gather path emits a uniform softmax while the kernel semantics give 0,
and those rows feed nothing.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_small as jax_gpt_small
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         gpt_small, gpt_tiny)

RTOL, ATOL = 2e-4, 1e-5
TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_position=64)


@pytest.fixture(scope="module")
def pair():
    pt.seed(7)
    jm = JaxGPT(jax_gpt_tiny(**TINY))
    jm.eval()
    arrays = {k: np.asarray(p.value) for k, p in jm.named_parameters()}
    tm = GPTForCausalLM(gpt_tiny(**TINY), device="cpu")
    load_jax_params(tm, arrays)
    tm.eval()
    return jm, tm, arrays


def test_parameter_names_and_shapes_match_1_to_1(pair):
    jm, tm, arrays = pair
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == {k: tuple(a.shape) for k, a in arrays.items()}
    assert "gpt.blocks.0.attn.qkv.weight" in got
    assert got["gpt.blocks.0.attn.qkv.weight"] == (32, 96)  # [in, out]


def test_forward_logits_match_jax(pair):
    jm, tm, _ = pair
    ids = np.random.RandomState(0).randint(0, 97, size=(2, 12))
    want = np.asarray(jm(jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 12, 97)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _paged_steps():
    """Prefill (slot 0: 5 tokens, slot 1: 11, padded to 12), a T=1 decode
    step, then a T=2 verify step where only slot 0 carries a draft.
    Slot 0 maps page 3, slot 1 pages 0 and 5; page size 8, G = 4."""
    rng = np.random.RandomState(1)
    table = np.array([[3, -1, -1, -1], [0, 5, -1, -1]], np.int32)
    lens = [5, 11]
    ids = np.zeros((2, 12), np.int32)
    pos = np.full((2, 12), -1, np.int32)
    pos_map = np.full((2, 32), -1, np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.randint(0, 97, size=n)
        pos[b, :n] = np.arange(n)
        pos_map[b, :n] = np.arange(n)
    steps = [(ids, pos, pos_map.copy())]
    ids1 = rng.randint(0, 97, size=(2, 1)).astype(np.int32)
    pos1 = np.array([[5], [11]], np.int32)
    pos_map[0, 5], pos_map[1, 11] = 5, 11
    steps.append((ids1, pos1, pos_map.copy()))
    ids2 = rng.randint(0, 97, size=(2, 2)).astype(np.int32)
    pos2 = np.array([[6, 7], [12, -1]], np.int32)
    pos_map[0, 6], pos_map[0, 7], pos_map[1, 12] = 6, 7, 12
    steps.append((ids2, pos2, pos_map.copy()))
    return table, steps, np.array(lens, np.int32)


def test_forward_paged_prefill_and_decode_match_jax(pair):
    jm, tm, _ = pair
    table, steps, _ = _paged_steps()
    jcache = jm.gpt.init_paged_cache(8, 8)
    tcache = tm.gpt.init_paged_cache(8, 8)
    with torch.no_grad():
        for ids, pos, pos_map in steps:
            want, jcache = jm.forward_paged(
                jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(pos_map),
                jnp.asarray(table), jcache)
            got, tcache = tm.forward_paged(
                torch.from_numpy(ids), torch.from_numpy(pos),
                torch.from_numpy(pos_map), torch.from_numpy(table), tcache)
            valid = pos >= 0
            np.testing.assert_allclose(got.numpy()[valid],
                                       np.asarray(want)[valid],
                                       rtol=RTOL, atol=ATOL)
            # pool pages after the scatter (the write-drop page P = 8
            # collects padding writes in an unspecified order: skip it)
            for jl, tl in zip(jcache["layers"], tcache["layers"]):
                for key in ("k", "v"):
                    np.testing.assert_allclose(
                        tl[key].numpy()[:8], np.asarray(jl[key])[:8],
                        rtol=RTOL, atol=ATOL)


def test_forward_paged_gather_last_matches_jax(pair):
    jm, tm, _ = pair
    table, steps, lens = _paged_steps()
    ids, pos, pos_map = steps[0]
    want, _ = jm.forward_paged(
        jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(pos_map),
        jnp.asarray(table), jm.gpt.init_paged_cache(8, 8),
        gather_last=jnp.asarray(lens))
    with torch.no_grad():
        got, _ = tm.forward_paged(
            torch.from_numpy(ids), torch.from_numpy(pos),
            torch.from_numpy(pos_map), torch.from_numpy(table),
            tm.gpt.init_paged_cache(8, 8), gather_last=torch.from_numpy(lens))
    assert got.shape == (2, 97)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_copy_pages_matches_jax(pair):
    jm, tm, _ = pair
    rng = np.random.RandomState(2)
    jcache = jm.gpt.init_paged_cache(4, 8)
    tcache = tm.gpt.init_paged_cache(4, 8)
    for jl, tl in zip(jcache["layers"], tcache["layers"]):
        for key in ("k", "v"):
            a = rng.randn(*tl[key].shape).astype(np.float32)
            jl[key] = jnp.asarray(a)
            tl[key].copy_(torch.from_numpy(a))
    src, dst = np.array([0, 2, -1], np.int32), np.array([3, 1, -1], np.int32)
    jcache = jm.gpt.copy_pages(jcache, src, dst)
    tcache = tm.gpt.copy_pages(tcache, src, dst)
    for jl, tl in zip(jcache["layers"], tcache["layers"]):
        for key in ("k", "v"):
            np.testing.assert_array_equal(tl[key].numpy(),
                                          np.asarray(jl[key]))


def test_load_jax_params_rejects_mismatches(pair):
    _, _, arrays = pair
    tm = GPTForCausalLM(gpt_tiny(**TINY), device="cpu")
    missing = dict(arrays)
    missing.pop("gpt.ln_f.bias")
    with pytest.raises(InvalidArgumentError, match="missing"):
        load_jax_params(tm, missing)
    extra = dict(arrays, **{"gpt.head.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(InvalidArgumentError, match="unexpected"):
        load_jax_params(tm, extra)
    bad = dict(arrays)
    bad["gpt.wte.weight"] = np.zeros((96, 32), np.float32)
    with pytest.raises(InvalidArgumentError, match="shape"):
        load_jax_params(tm, bad)


def test_seeded_init_is_reproducible_and_configs_match_jax():
    a = GPTForCausalLM(gpt_tiny(**TINY), device="cpu",
                       generator=torch.Generator().manual_seed(3))
    b = GPTForCausalLM(gpt_tiny(**TINY), device="cpu",
                       generator=torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert float(a.gpt.wte.weight.detach().std()) == pytest.approx(0.02, rel=0.2)
    small, jsmall = gpt_small(), jax_gpt_small()
    for k in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "max_position", "layer_norm_epsilon"):
        assert getattr(small, k) == getattr(jsmall, k), k


@pytest.mark.parametrize("kw", [dict(moe_experts=2), dict(lora_capacity=2),
                                dict(sequence_parallel="ring")])
def test_unported_configs_raise(kw):
    if "moe_experts" in kw:
        # ported since the MoE slice: the config builds MoELayer blocks
        from paddle_tpu_torch.moe import MoELayer

        net = GPTForCausalLM(GPTConfig(**TINY, **kw), device="cpu")
        assert all(isinstance(b.mlp, MoELayer) for b in net.gpt.blocks)
        assert net.gpt.blocks[0].mlp.num_experts == 2
        return
    if "lora_capacity" in kw:
        # ported since the LoRA slice: the config registers adapter tables
        # (capacity 2, the default rank 8) on every block projection
        net = GPTForCausalLM(GPTConfig(**TINY, **kw), device="cpu")
        tabs = [n for n, _ in net.named_buffers() if n.endswith(".lora_A")]
        assert len(tabs) == 4 * TINY["num_layers"]
        assert tuple(net.gpt.blocks[0].attn.qkv.lora_A.shape) == (2, 32, 8)
        return
    with pytest.raises(UnimplementedError, match="ROADMAP"):
        GPTForCausalLM(GPTConfig(**TINY, **kw), device="cpu")
