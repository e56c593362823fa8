"""Batched multi-LoRA in the port (paddle_tpu_torch/lora/) held against the
JAX package on the CPU at a tiny size (vocab 97, hidden 32, 2 layers,
capacity 2, rank 4, as tests/test_lora.py).

The same seeded numpy inputs go through both packages, with the JAX
parameters AND buffers (the adapter tables among them) copied by
``bridge.load_jax_params``: ``lora_delta`` against the JAX ``lora_delta``
(its masked-einsum route off the TPU) at rtol 1e-5 / atol 1e-6, the
grouped hops against the JAX masked einsum, model logits under one
``adapter_scope`` against the dense-merged reference (rtol 2e-4 / atol
2e-5) and against JAX, ``-1`` rows bitwise the base model, adapter
artifacts across the packages in both directions, the table edits'
validation, the config repair (bench.py's multi-LoRA config builds), the
quantized and bridged trees carrying the tables, and the engine's hot
add / remove.  ``gpu``-marked cases hold kernel 10 against its plain
version at the LoRA hop shapes on the card.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import lora as jlora
from paddle_tpu import slim as jslim
from paddle_tpu.lora import batched as jbatched
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu_torch import lora, slim
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.lora import batched
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.grouped_matmul import (grouped_matmul,
                                                 grouped_matmul_ref)
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.slim.quantization import weight_trees

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_position=64, dropout=0.0)
IDS = np.array([[3, 9, 27, 5], [11, 2, 40, 8]], np.int32)
ENG = dict(prompt_buckets=[8], batch_size=2, cache_len=48, paged=True,
           kv_page_size=8)


def _jax_model(capacity=2, rank=4, **kw):
    pt.seed(4321)
    jm = JaxGPT(JaxGPTConfig(**TINY, lora_capacity=capacity,
                             lora_rank=rank, **kw))
    jm.eval()
    return jm


def _bridged(jm, capacity=2, rank=4, **kw):
    """The port model carrying the JAX model's parameters and buffers."""
    tm = GPTForCausalLM(GPTConfig(**TINY, lora_capacity=capacity,
                                  lora_rank=rank, **kw), device="cpu")
    load_jax_params(tm, {k: np.asarray(p.value)
                         for k, p in jm.named_parameters()},
                    {k: np.asarray(b.value) for k, b in jm.named_buffers()})
    return tm.eval()


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(2)
    jm = _jax_model()
    return jm, _bridged(jm)


def _jax_install(jm, slot, adapter):
    """Write an adapter into the eager JAX model's buffer boxes."""
    new = jbatched.write_adapter(jm.buffer_pytree(), slot, adapter)
    for name, box in jm.named_buffers():
        if name in new:
            box.value = jnp.asarray(new[name])


def _install(tm, slot, adapter):
    """Write an adapter into the port model's own tables, in place."""
    tables = dict(tm.named_buffers())
    with torch.no_grad():
        batched._write_slot(tables, slot, adapter)


def _port_adapter(jad):
    return lora.LoraAdapter(jad.name, jad.rank, jad.alpha, jad.sites)


# -- lora_delta and the grouped hops ------------------------------------------

@pytest.mark.parametrize("case", [
    ("ragged", 4, 8, [0, -1, 3, 3, 1, -1, 0, 2]),
    ("all the same", 4, 8, [2] * 8),
    ("all dead", 4, 8, [-1] * 8),
    ("cap 1", 1, 8, [0, -1, 0, 0, -1, 0, 0, 0]),
    ("prefill B x T", 3, 6 * 5, None),
])
def test_lora_delta_matches_jax(case):
    name, cap, n, ids = case
    rng = np.random.RandomState(len(name) + cap)
    D, r, F = 32, 4, 96
    if ids is None:  # B = 6 rows of T = 5 tokens, each row one slot
        ids = np.repeat(rng.randint(-1, cap, size=6), 5)
    ids = np.asarray(ids, np.int32)
    A = (rng.randn(cap, D, r) * 0.3).astype(np.float32)
    B = (rng.randn(cap, r, F) * 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=cap).astype(np.float32)
    x = rng.randn(n, D).astype(np.float32)
    jd, jlive = jbatched.lora_delta(jnp.asarray(A), jnp.asarray(B),
                                    jnp.asarray(scale), jnp.asarray(x),
                                    jnp.asarray(ids))
    td, tlive = batched.lora_delta(*map(torch.from_numpy, (A, B, scale, x)),
                                   torch.from_numpy(ids))
    np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive))
    live = ids >= 0
    np.testing.assert_allclose(td.numpy()[live], np.asarray(jd)[live],
                               rtol=1e-5, atol=1e-6)


def test_lora_delta_rows_independent_of_order():
    """Each row's delta is bit-equal whatever the order of the rows."""
    rng = np.random.RandomState(3)
    A = torch.from_numpy((rng.randn(4, 32, 8) * 0.3).astype(np.float32))
    B = torch.from_numpy((rng.randn(4, 8, 64) * 0.3).astype(np.float32))
    scale = torch.full((4,), 2.0)
    x = torch.from_numpy(rng.randn(12, 32).astype(np.float32))
    ids = torch.from_numpy(rng.randint(-1, 4, size=12).astype(np.int32))
    d, live = batched.lora_delta(A, B, scale, x, ids)
    perm = torch.from_numpy(rng.permutation(12))
    dp, livep = batched.lora_delta(A, B, scale, x[perm], ids[perm])
    assert torch.equal(livep, live[perm])
    assert torch.equal(dp[livep], d[perm][livep])


@pytest.mark.parametrize("r", [3, 4, 8])
@pytest.mark.parametrize("hop", ["rank as F", "rank as K"])
def test_grouped_hops_match_the_jax_masked_einsum(r, hop):
    """Both hops' shapes through the port's CPU routes — the masked einsum
    of ``_grouped`` and the ``grouped_matmul`` op (the kernel's CPU
    version) — against JAX's ``_grouped`` (its einsum route on the CPU)."""
    rng = np.random.RandomState(r)
    cap, C = 3, 10
    D, F = (32, r) if hop == "rank as F" else (r, 96)
    xe = rng.randn(cap, C, D).astype(np.float32)
    w = rng.randn(cap, D, F).astype(np.float32)
    counts = np.array([10, 0, 4], np.int32)
    want = np.asarray(jbatched._grouped(jnp.asarray(xe), jnp.asarray(w),
                                        jnp.asarray(counts)))
    tx, tw, tc = map(torch.from_numpy, (xe, w, counts))
    for got in (batched._grouped(tx, tw, tc), grouped_matmul(tx, tw, tc),
                grouped_matmul_ref(tx, tw, tc)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        assert not got.numpy()[1].any() and not got.numpy()[2, 4:].any()


def test_gate_takes_the_kernel_for_every_cuda_activation(monkeypatch):
    """``_grouped``: a CUDA activation goes to ``grouped_matmul`` at any
    width (no lane clause); a CPU one takes the masked einsum."""
    seen = []
    monkeypatch.setattr(batched, "grouped_matmul",
                        lambda xe, w, c: seen.append(
                            (tuple(xe.shape), tuple(w.shape))) or "kernel")
    for D, F in ((768, 8), (8, 2304), (13, 5)):
        card = SimpleNamespace(device=torch.device("cuda"),
                               shape=(16, 8, D))
        w = SimpleNamespace(shape=(16, D, F))
        assert batched._grouped(card, w, None) == "kernel"
    assert seen == [((16, 8, 768), (16, 768, 8)), ((16, 8, 8), (16, 8, 2304)),
                    ((16, 8, 13), (16, 13, 5))]
    x = torch.ones(2, 3, 4)
    out = batched._grouped(x, torch.ones(2, 4, 5), torch.tensor([3, 1]))
    assert len(seen) == 3 and tuple(out.shape) == (2, 3, 5)


# -- the model -----------------------------------------------------------------

def test_config_repair_builds_bench_multilora_config():
    """bench.py's ``bench_gpt_generate_multilora`` config builds in the port
    (GPTConfig lacked lora_rank / lora_alpha)."""
    cfg = GPTConfig(vocab_size=8192, hidden_size=256, num_layers=4,
                    num_heads=8, max_position=512, dropout=0.0,
                    lora_capacity=16, lora_rank=8)
    jcfg = JaxGPTConfig(vocab_size=8192, hidden_size=256, num_layers=4,
                        num_heads=8, max_position=512, dropout=0.0,
                        lora_capacity=16, lora_rank=8)
    for k in ("lora_capacity", "lora_rank", "lora_alpha"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    m = GPTForCausalLM(cfg, device="cpu")
    qkv = m.gpt.blocks[3].attn.qkv
    assert tuple(qkv.lora_A.shape) == (16, 256, 8)
    assert tuple(qkv.lora_B.shape) == (16, 8, 768)
    assert qkv.lora_scale.dtype == torch.float32
    assert torch.equal(qkv.lora_scale, torch.full((16,), 2.0))
    sites = [n for n, b in m.named_buffers() if n.endswith(".lora_A")]
    assert len(sites) == 16  # 4 sites x 4 layers
    GPTConfig(lora_capacity=16, lora_rank=8, lora_alpha=16.0)
    for bad in (dict(lora_capacity=-1), dict(lora_capacity=2, lora_rank=0)):
        with pytest.raises(ValueError):
            GPTConfig(**bad)
        with pytest.raises(ValueError):
            JaxGPTConfig(**bad)


def test_tables_match_jax_names_and_dtypes():
    jm = _jax_model()
    tm = GPTForCausalLM(GPTConfig(**TINY, lora_capacity=2, lora_rank=4),
                        device="cpu")
    jb = {k: np.asarray(b.value) for k, b in jm.named_buffers()}
    tb = dict(tm.named_buffers())
    assert set(jb) == set(tb)
    for k, a in jb.items():
        assert tuple(a.shape) == tuple(tb[k].shape), k
        assert str(a.dtype) == str(tb[k].dtype).replace("torch.", ""), k
        assert not tb[k].any() or k.endswith("lora_scale")
    # a bf16 model keeps float32 scales, as JAX's
    bm = GPTForCausalLM(GPTConfig(**TINY, lora_capacity=2, lora_rank=3,
                                  lora_alpha=16.0, dtype="bfloat16"),
                        device="cpu")
    assert bm.gpt.blocks[0].mlp.fc1.lora_A.dtype == torch.bfloat16
    sc = bm.gpt.blocks[0].mlp.fc1.lora_scale
    assert sc.dtype == torch.float32 and float(sc[0]) == np.float32(16 / 3)


def test_moe_model_adapts_attention_only():
    jm = _jax_model(moe_experts=2)
    tm = _bridged(jm, moe_experts=2)
    names = sorted(n for n, _ in lora.lora_targets(tm))
    assert names == sorted(n for n, _ in jlora.lora_targets(jm))
    assert all(n.rsplit(".", 1)[-1] in ("qkv", "out") for n in names)


def test_random_adapter_same_draws_as_jax(pair):
    jm, tm = pair
    ja = jlora.random_adapter(jm, "a", rank=3, alpha=6.0, seed=7)
    ta = lora.random_adapter(tm, "a", rank=3, alpha=6.0, seed=7)
    assert list(ja.sites) == list(ta.sites)
    for s, (a, b) in ja.sites.items():
        assert np.array_equal(a, ta.sites[s][0])
        assert np.array_equal(b, ta.sites[s][1])
    assert ta.scale == ja.scale == 2.0


def test_logits_match_jax_under_the_same_scope():
    jm = _jax_model()
    adps = [jlora.random_adapter(jm, f"a{i}", rank=3 + i, seed=5 + i,
                                 alpha=8.0) for i in range(2)]
    for slot, a in enumerate(adps):
        _jax_install(jm, slot, a)
    tm = _bridged(jm)  # the installed tables ride the buffers
    for ids in ([0, 1], [1, -1], [-1, -1], [0, 0]):
        with jlora.adapter_scope(np.array(ids, np.int32)):
            want = np.asarray(jm(jnp.asarray(IDS)))
        with torch.no_grad(), lora.adapter_scope(ids):
            got = tm(torch.from_numpy(IDS)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_batched_gather_matches_dense_merged_reference(pair):
    _, tm0 = pair
    tm = _bridged(_jax_model())
    adp = lora.random_adapter(tm, "a0", rank=3, alpha=6.0, seed=7)
    _install(tm, 0, adp)
    ids = torch.from_numpy(IDS)
    with torch.no_grad():
        with lora.adapter_scope([0, 0]):
            got = tm(ids).numpy()
        merged = lora.merge_adapter(tm, adp)
        ref = torch.func.functional_call(tm, merged, (ids,)).numpy()
        base = tm(ids).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert float(np.abs(got - base).max()) > 1e-6
    # merged in float64, as JAX's merge_adapter
    jm = _jax_model()
    jmerged = jlora.merge_adapter(jm, jlora.LoraAdapter(
        adp.name, adp.rank, adp.alpha, adp.sites))
    for k, v in jmerged.items():
        np.testing.assert_array_equal(merged[k].numpy(), np.asarray(v))


def test_slot_minus_one_is_bitwise_base(pair):
    tm = _bridged(_jax_model())
    _install(tm, 1, lora.random_adapter(tm, "a0", rank=4, seed=3))
    ids = torch.from_numpy(IDS)
    with torch.no_grad():
        base = tm(ids).numpy()
        with lora.adapter_scope([-1, -1]):
            dead = tm(ids).numpy()
        with lora.adapter_scope(torch.tensor([1, -1])):
            mixed = tm(ids).numpy()
    assert np.array_equal(base, dead)
    assert np.array_equal(base[1], mixed[1])
    assert float(np.abs(mixed[0] - base[0]).max()) > 1e-6


def test_forward_paths_take_adapter_ids(pair):
    """``forward_cached`` / ``forward_paged`` scope ``adapter_ids`` around
    the block stack only: the same logits as the dense forward under the
    scope, and ``-1`` bitwise no ids."""
    tm = _bridged(_jax_model())
    _install(tm, 0, lora.random_adapter(tm, "a0", rank=4, seed=3))
    ids = torch.from_numpy(IDS).long()
    pos = np.broadcast_to(np.arange(4), (2, 4))
    with torch.no_grad():
        with lora.adapter_scope([0, -1]):
            want = tm(ids).numpy()[:, -1]
        got, _ = tm.forward_cached(ids, pos, tm.gpt.init_cache(2, 16),
                                   gather_last=[4, 4],
                                   adapter_ids=np.array([0, -1]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        cache = tm.gpt.init_paged_cache(4, 8)
        table = torch.tensor([[0, -1], [1, -1]], dtype=torch.int32)
        pmap = torch.full((2, 16), -1, dtype=torch.long)
        pmap[:, :4] = torch.arange(4)
        got_p, _ = tm.forward_paged(ids, torch.from_numpy(pos.copy()), pmap,
                                    table, cache, gather_last=torch.tensor(
                                        [4, 4]),
                                    adapter_ids=torch.tensor([0, -1]))
        np.testing.assert_allclose(got_p.numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        none, _ = tm.forward_cached(ids, pos, tm.gpt.init_cache(2, 16),
                                    gather_last=[4, 4])
        dead, _ = tm.forward_cached(ids, pos, tm.gpt.init_cache(2, 16),
                                    gather_last=[4, 4],
                                    adapter_ids=[-1, -1])
    assert torch.equal(none, dead)


def test_runtime_scope_contract():
    from paddle_tpu_torch.lora import runtime

    assert runtime.active_ids() is None and not runtime.active()
    with pytest.raises(InvalidArgumentError):
        lora.adapter_scope(np.zeros((2, 2), np.int32))
    with lora.adapter_scope([0, 1]):
        with lora.adapter_scope(torch.tensor([-1, -1])):
            assert runtime.active_ids().tolist() == [-1, -1]
        assert runtime.active_ids().tolist() == [0, 1]
        assert runtime.active_ids().dtype == torch.int32
    assert runtime.active_ids() is None
    tm = _bridged(_jax_model())
    with pytest.raises(InvalidArgumentError), torch.no_grad(), \
            lora.adapter_scope([0, 0, 0]):
        tm(torch.from_numpy(IDS))


def test_write_adapter_validation(pair):
    """tests/test_lora.py's validation, on the port's flat dicts (tensors)
    and on numpy, with the same results as JAX's write_adapter."""
    jm, tm = pair
    bufs = dict(tm.named_buffers())
    assert lora.adapter_capacity(bufs) == 2
    assert lora.adapter_capacity({}) == 0
    big = lora.random_adapter(tm, "big", rank=8, seed=1)
    with pytest.raises(InvalidArgumentError):
        lora.write_adapter(bufs, 0, big)
    ok = lora.random_adapter(tm, "ok", rank=2, seed=1)
    with pytest.raises(InvalidArgumentError):
        lora.write_adapter(bufs, 5, ok)
    bad = lora.LoraAdapter("bad", 2, 2.0, {
        "gpt.nowhere.qkv": (np.zeros((32, 2), np.float32),
                            np.zeros((2, 96), np.float32))})
    with pytest.raises(InvalidArgumentError):
        lora.write_adapter(bufs, 0, bad)
    new = lora.write_adapter(bufs, 0, ok)
    site = next(iter(ok.sites))
    a_tab = new[site + ".lora_A"]
    assert a_tab.shape[2] == 4 and not a_tab[0, :, 2:].any()
    assert not bufs[site + ".lora_A"].any()  # the input was not mutated
    jnew = jbatched.write_adapter(jm.buffer_pytree(), 0, jlora.LoraAdapter(
        ok.name, ok.rank, ok.alpha, ok.sites))
    nnew = lora.write_adapter({k: v.numpy() for k, v in bufs.items()}, 0, ok)
    for k in new:
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(jnew[k]))
        np.testing.assert_array_equal(nnew[k], np.asarray(jnew[k]))
    cleared = lora.clear_slot(new, 0)
    assert not cleared[site + ".lora_A"].any()
    assert new[site + ".lora_A"].any()
    with pytest.raises(InvalidArgumentError):
        lora.clear_slot(new, 2)
    with pytest.raises(InvalidArgumentError):
        lora.clear_slot({"x.weight": torch.zeros(2)}, 0)
    # a refused in-place write touches nothing
    tables = {k: v.clone() for k, v in bufs.items()}
    half = lora.LoraAdapter("half", 2, 2.0, {
        site: ok.sites[site], "gpt.nowhere.qkv": bad.sites["gpt.nowhere.qkv"]})
    with pytest.raises(InvalidArgumentError):
        batched._write_slot(tables, 0, half)
    assert not tables[site + ".lora_A"].any()


# -- artifacts -----------------------------------------------------------------

def test_export_load_roundtrip(pair, tmp_path):
    _, tm = pair
    adp = lora.random_adapter(tm, "ship-me", rank=3, alpha=5.0, seed=11)
    path = lora.export_adapter(adp, str(tmp_path / "adp"))
    assert path.endswith(".pdlora")
    assert os.path.exists(path + ".manifest.json")
    back = lora.load_adapter(path)
    assert (back.name, back.rank, back.alpha) == ("ship-me", 3, 5.0)
    assert set(back.sites) == set(adp.sites)
    for s, (a, b) in adp.sites.items():
        assert np.array_equal(a, back.sites[s][0])
        assert np.array_equal(b, back.sites[s][1])


@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_artifacts_cross_between_packages(pair, tmp_path, direction):
    jm, tm = pair
    src = (jlora.random_adapter(jm, "x", rank=3, alpha=5.0, seed=2)
           if direction == "jax to port"
           else lora.random_adapter(tm, "x", rank=3, alpha=5.0, seed=2))
    export, load = ((jlora.export_adapter, lora.load_adapter)
                    if direction == "jax to port"
                    else (lora.export_adapter, jlora.load_adapter))
    back = load(export(src, str(tmp_path / "x")))
    assert (back.name, back.rank, back.alpha) == ("x", 3, 5.0)
    assert list(back.sites) == list(src.sites)
    for s, (a, b) in src.sites.items():
        assert np.array_equal(a, back.sites[s][0])
        assert np.array_equal(b, back.sites[s][1])


def test_load_rejects_tampered_and_unmanifested(pair, tmp_path):
    _, tm = pair
    path = lora.export_adapter(lora.random_adapter(tm, "t", rank=2, seed=5),
                               str(tmp_path / "adp"))
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    with pytest.raises(InvalidArgumentError, match="sha256"):
        lora.load_adapter(path)
    os.remove(path + ".manifest.json")
    with pytest.raises(InvalidArgumentError, match="manifest"):
        lora.load_adapter(path)


# -- trees: quantization and the bridge -----------------------------------------

def test_quantize_model_keeps_tables_float(pair):
    _, tm = pair
    qm = slim.quantize_model(tm, "int8")
    qkv = qm.gpt.blocks[0].attn.qkv
    assert qkv.weight.dtype == torch.int8
    assert qkv.lora_A.dtype == torch.float32
    assert qkv.lora_scale.dtype == torch.float32
    params, buffers = weight_trees(qm)
    lora_keys = {k for k in buffers if ".lora_" in k}
    assert len(lora_keys) == 3 * 4 * 2 and not (lora_keys & set(params))
    jparams, jbuffers = jslim.quantize_model_trees(_jax_model(), "int8")
    assert set(buffers) == set(jbuffers) and set(params) == set(jparams)
    for k in lora_keys:
        assert str(np.asarray(jbuffers[k]).dtype) == "float32", k


def test_bridge_carries_tables_by_name(tmp_path):
    jm = _jax_model()
    _jax_install(jm, 1, jlora.random_adapter(jm, "b", rank=4, seed=9))
    tm = _bridged(jm)
    for k, b in jm.named_buffers():
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(),
                                      np.asarray(b.value))
    _, buffers = weight_trees(tm)
    assert {k for k in buffers if ".lora_" in k} == {
        k for k, _ in jm.named_buffers() if ".lora_" in k}
    with pytest.raises(InvalidArgumentError):
        load_jax_params(tm, {k: np.asarray(p.value)
                             for k, p in jm.named_parameters()},
                        {"gpt.blocks.0.attn.qkv.lora_A":
                         np.zeros((2, 32, 5), np.float32)})


# -- the engine -------------------------------------------------------------------

def _adapter(tm, name="hot", seed=9):
    return lora.random_adapter(tm, name, rank=4, seed=seed, alpha=32.0,
                               std=0.2)


def test_hot_add_remove(pair):
    _, tm = pair
    p = (np.arange(6) * 9 + 4) % 97
    with GenerationEngine(tm, name="pt-lora-hot", **ENG) as eng:
        eng.warmup()
        base = eng.generate(p, 8, timeout=120).tolist()
        eng.install_adapter(0, _adapter(tm))
        assert eng.adapters == {0: "hot"}
        tuned = eng.generate(p, 8, timeout=120, adapter_id=0).tolist()
        assert eng.generate(p, 8, timeout=120,
                            adapter_id=-1).tolist() == base
        assert eng._adapter_hits[0] == 7  # the 7 decode steps of slot 0
        eng.remove_adapter(0)
        assert eng.adapters == {} and eng._adapter_hits[0] == 0
        assert eng.generate(p, 8, timeout=120, adapter_id=0).tolist() == base
        st = eng.stats()
        assert st["adapter_installs"] == 1 and st["adapter_removals"] == 1
    assert tuned != base
    # the caller's model is untouched: the engine wrote its own copy
    assert not tm.gpt.blocks[0].attn.qkv.lora_A.any()


def test_hot_install_while_requests_are_in_flight(pair):
    _, tm = pair
    prompts = [(np.arange(5) * 7 + i) % 97 for i in range(6)]
    with GenerationEngine(tm, name="pt-lora-live", **ENG) as eng:
        eng.warmup()
        futs = [eng.submit(p, 12, adapter_id=i % 2)
                for i, p in enumerate(prompts)]
        eng.install_adapter(1, _adapter(tm, "b", 4))
        eng.install_adapter(0, _adapter(tm, "a", 5))
        eng.remove_adapter(1)
        outs = [f.result(120) for f in futs]
        assert all(o.shape == (12,) for o in outs)
        assert eng.stats()["errors"] == 0
        # slot 1 was removed: it serves the base tokens now
        assert eng.generate(prompts[1], 12, timeout=120,
                            adapter_id=1).tolist() == eng.generate(
            prompts[1], 12, timeout=120).tolist()


def test_submit_validates_adapter_id(pair):
    _, tm = pair
    with GenerationEngine(tm, name="pt-lora-val", **ENG) as eng:
        with pytest.raises(InvalidArgumentError):
            eng.submit(np.arange(4) % 97, 4, adapter_id=7)
        with pytest.raises(InvalidArgumentError):
            eng.install_adapter(2, _adapter(tm))
        with pytest.raises(InvalidArgumentError):
            eng.remove_adapter(-1)
    plain = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    with GenerationEngine(plain, name="pt-lora-none", **ENG) as eng:
        assert "adapter_installs" not in eng.stats()
        with pytest.raises(InvalidArgumentError):
            eng.submit(np.arange(4) % 97, 4, adapter_id=0)
        with pytest.raises(InvalidArgumentError, match="LoRA"):
            eng.install_adapter(0, _adapter(tm))
        eng.submit(np.arange(4) % 97, 2, adapter_id=-1).result(120)


def test_paged_engine_tokens_match_jax(pair):
    """The port's paged LoRA engine gives the JAX paged engine's tokens for
    the same model, adapters and prompts, one request at a time."""
    jm, tm = pair
    jads = [jlora.random_adapter(jm, f"t{i}", rank=4, seed=20 + i,
                                 alpha=32.0, std=0.2) for i in range(2)]
    prompts = [(np.arange(5) * 11 + 3) % 97, np.arange(4) % 97,
               (np.arange(6) * 3 + 1) % 97]
    with JaxGenerationEngine(jm, name="jx-lora", **ENG) as je, \
            GenerationEngine(tm, name="pt-lora-jx", **ENG) as te:
        for slot, a in enumerate(jads):
            je.install_adapter(slot, a)
            te.install_adapter(slot, _port_adapter(a))
        te.warmup()
        for aid in (0, 1, -1):
            for p in prompts:
                assert te.generate(p, 8, timeout=120,
                                   adapter_id=aid).tolist() == \
                    je.generate(p, 8, timeout=120, adapter_id=aid).tolist()


@pytest.mark.parametrize("how", ["reload_weights", "swap_weights"])
def test_weight_swaps_replace_the_tables(pair, tmp_path, how):
    """``reload_weights`` / ``swap_weights`` replace the adapter tables as
    the JAX engine replaces its buffer tree (installed adapters are gone
    from the tables), while ``adapters`` keeps reporting them, in both
    packages."""
    from paddle_tpu_torch import save

    jm, tm = pair
    p = (np.arange(6) * 9 + 4) % 97
    jad = jlora.random_adapter(jm, "s", rank=4, seed=9, alpha=32.0, std=0.2)
    path = str(tmp_path / "w.pdiparams")
    params, buffers = weight_trees(tm)
    save({"params": params, "buffers": buffers}, path)
    got = {}
    for pkg, eng in (("jax", JaxGenerationEngine(jm, name="jx-sw", **ENG)),
                     ("port", GenerationEngine(tm, name="pt-sw", **ENG))):
        with eng:
            eng.install_adapter(0, jad if pkg == "jax"
                                else _port_adapter(jad))
            base = eng.generate(p, 8, timeout=120).tolist()
            tuned = eng.generate(p, 8, timeout=120, adapter_id=0).tolist()
            if how == "reload_weights":
                eng.reload_weights()
            else:
                eng.swap_weights(path)
            after = eng.generate(p, 8, timeout=120, adapter_id=0).tolist()
            got[pkg] = (base, tuned, after, eng.adapters)
    assert got["jax"] == got["port"]
    base, tuned, after, view = got["port"]
    assert tuned != base and after == base and view == {0: "s"}


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # gpt_small (f32): hop 1 D -> r, hop 2 r -> F, decode / verify /
    # admission rows, caps 1 / 4 / 16
    (16, 8, 768, 8, "float32"), (16, 8, 8, 2304, "float32"),
    (16, 8, 8, 768, "float32"), (16, 8, 3072, 8, "float32"),
    (16, 8, 8, 3072, "float32"), (4, 40, 768, 8, "float32"),
    (4, 40, 8, 2304, "float32"), (1, 384, 768, 8, "float32"),
    (1, 384, 8, 3072, "float32"),
    # bench.py's 4 x 256 config, and bf16
    (16, 8, 256, 8, "float32"), (16, 384, 8, 1024, "float32"),
    (16, 8, 768, 8, "bfloat16"), (16, 8, 8, 2304, "bfloat16"),
])
def test_kernel_matches_plain_at_lora_shapes_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cap, n, D, F, dt = case
    dtype = getattr(torch, dt)
    gen = torch.Generator().manual_seed(sum(case[:4]))
    x = torch.randn(cap, n, D, generator=gen).to("cuda", dtype)
    w = (torch.randn(cap, D, F, generator=gen) / D ** 0.5).to("cuda", dtype)
    ids = torch.randint(-1, cap, (n,), generator=gen)
    counts = torch.stack([(ids == g).sum() for g in range(cap)]).cuda()
    y, y2 = grouped_matmul(x, w, counts), grouped_matmul(x, w, counts)
    ref = grouped_matmul_ref(x, w, counts)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-3))
    torch.testing.assert_close(y, ref, **tol)
