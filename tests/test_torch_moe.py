"""The port's mixture-of-experts layer, model and serving held against the
JAX package (``paddle_tpu.moe``).

From bridged parameters and the same numpy inputs: ``MoELayer`` outputs,
aux loss, routed / dropped counts and gradients (autograd against
``jax.grad``) for top-1 and top-2, eval and train mode (jitter 0), with
and without capacity overflow, the JAX side with its kernel gate open
(the Pallas ``grouped_matmul`` in interpret mode) and closed (the masked
einsum), the port's likewise (the CPU ``grouped_matmul`` or its einsum).
float32 at rtol / atol 1e-5 (gradients 1e-5 of their tensor's largest
entry: the two frameworks sum in other orders).  Then the routing
contracts (the slot-major tie-break oracle, the zero-gate tie, jitter
from the device generator), the dense-equivalence invariant, a tiny MoE
GPT (logits, loss with aux, two ``train_batch`` steps) against JAX, the
engine (tokens, counters) and the thread-local stats stack.  On the card
(``gpu``): the layer through kernel 10 against the CPU's einsum, and the
zero-gate tie there.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.moe import MoELayer as JaxMoELayer
from paddle_tpu.moe import stats as jstats
from paddle_tpu.nn.layer_base import functional_call
from paddle_tpu.ops import autotune as jat
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.moe import MoELayer
from paddle_tpu_torch.moe import stats as tstats
from paddle_tpu_torch.ops import grouped_matmul
from paddle_tpu_torch.serving import GenerationEngine


class _Cfg:
    """Minimal duck-typed config for a bare MoELayer (both packages)."""

    def __init__(self, D=16, F=32, E=4, k=2, cf=1.25, jitter=0.0):
        self.hidden_size, self.intermediate_size, self.dropout = D, F, 0.0
        self.moe_experts, self.moe_top_k = E, k
        self.moe_capacity_factor, self.moe_jitter = cf, jitter


def _arrays(layer):
    return {k: np.asarray(p.value) for k, p in layer.named_parameters()}


def _pair(cfg, seed=0):
    """A JAX layer and a port layer with the JAX parameters."""
    jpt.seed(seed)
    jl = JaxMoELayer(cfg)
    tl = MoELayer(cfg)
    load_jax_params(tl, _arrays(jl))
    return jl, tl


def _jax_run(jl, params, x, g, train):
    """y, aux, counts and grads (params, x) of sum(y * g) + 0.5 aux."""
    E = jl.num_experts

    def f(params, x):
        with jstats.collect() as ms:
            y = functional_call(jl, params, x, training=train)
        aux = ms.total_aux()
        return jnp.sum(y * g) + 0.5 * aux, (y, aux, ms.counts(E))

    (_, (y, aux, counts)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, x)
    return (np.asarray(y), float(aux), np.asarray(counts),
            {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx))


def _torch_run(tl, x, g, train):
    tl.train(train)
    tx = torch.from_numpy(x).requires_grad_()
    with tstats.collect() as ms:
        y = tl(tx)
    aux = ms.total_aux()
    ((y * torch.from_numpy(g)).sum() + 0.5 * aux).backward()
    return (y.detach().numpy(), float(aux.detach()),
            ms.counts(tl.num_experts).numpy(),
            {k: p.grad.numpy() for k, p in tl.named_parameters()},
            tx.grad.numpy())


def _grad_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=name)


@pytest.mark.parametrize("kernel", ["kernel", "einsum"])
@pytest.mark.parametrize("capacity", ["ample", "overflow"])
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("k", [1, 2])
def test_layer_matches_jax(monkeypatch, k, mode, capacity, kernel):
    cf = 4.0 if capacity == "ample" else 0.5
    cfg = _Cfg(D=16, F=32, E=4, k=k, cf=cf)
    jl, tl = _pair(cfg, seed=k)
    if kernel == "kernel":  # both gates open: Pallas (interpret) / CPU op
        monkeypatch.setattr(jat, "fused_epilogues_eligible",
                            lambda feature_dim=None: True)
        monkeypatch.setattr(MoELayer, "_use_kernel", lambda self, xe: True)
    assert jl._use_kernel(jnp.zeros((4, 2, 16))) == (kernel == "kernel")
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 16).astype(np.float32)
    g = rng.randn(2, 6, 16).astype(np.float32)
    params = {n: p.value for n, p in jl.named_parameters()}
    jy, jaux, jcounts, jgp, jgx = _jax_run(jl, params, jnp.asarray(x), g,
                                           mode == "train")
    ty, taux, tcounts, tgp, tgx = _torch_run(tl, x, g, mode == "train")
    np.testing.assert_array_equal(tcounts, jcounts)
    assert int(tcounts[1].sum() > 0) == (capacity == "overflow")
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    _grad_close(tgx, jgx, "x")
    assert set(tgp) == set(jgp)
    for name in jgp:
        _grad_close(tgp[name], jgp[name], name)


def test_capacity_tiebreak_slot_major_then_token():
    """C = 1 a expert, 2 tokens x top-2: a token's FIRST choice beats any
    token's SECOND choice for the same expert, and within a choice rank
    the earlier token wins (the JAX test's oracle, on the port)."""
    tl = MoELayer(_Cfg(D=2, F=4, E=2, k=2, cf=0.5))
    tl.eval()
    assert tl.capacity(2) == 1
    with torch.no_grad():
        # x = eye: logits row n = gate row n = ln(p), softmax returns p
        tl.gate.copy_(torch.log(torch.tensor([[0.4, 0.6], [0.9, 0.1]])))
        tl.expert_fc1.zero_()
        tl.expert_fc2.zero_()
        tl.expert_b1.zero_()
        # expert e outputs the constant e + 1 in every lane
        tl.expert_b2.copy_(torch.tensor([[1.0, 1.0], [2.0, 2.0]]))
        with tstats.collect() as ms:
            y = tl(torch.eye(2))
    counts = ms.counts(2)
    assert counts.tolist() == [[1, 1], [1, 1]]
    torch.testing.assert_close(y[0], torch.full((2,), 0.6 * 2.0))
    torch.testing.assert_close(y[1], torch.full((2,), 0.9 * 1.0))


def test_zero_gate_ties_pick_the_lowest_experts_as_jax():
    """Every probability ties under a zero gate: jax.lax.top_k takes the
    lowest expert indices, and so must the port (torch.topk promises no
    order on ties)."""
    cfg = _Cfg(D=16, F=32, E=4, k=2, cf=4.0)
    jl, tl = _pair(cfg, seed=4)
    jl.gate.value = jnp.zeros_like(jl.gate.value)
    with torch.no_grad():
        tl.gate.zero_()
    x = np.random.RandomState(8).randn(6, 16).astype(np.float32)
    g = np.ones((6, 16), np.float32)
    params = {n: p.value for n, p in jl.named_parameters()}
    jy, jaux, jcounts, _, _ = _jax_run(jl, params, jnp.asarray(x), g, False)
    ty, taux, tcounts, _, _ = _torch_run(tl, x, g, False)
    assert tcounts.tolist() == [[6, 6, 0, 0], [0, 0, 0, 0]]
    np.testing.assert_array_equal(tcounts, jcounts)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)


def test_jitter_comes_from_the_device_generator():
    cfg = _Cfg(D=16, F=32, E=4, k=2, cf=2.0, jitter=0.3)
    tl = MoELayer(cfg)
    tl.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(9).randn(24, 16)
                         .astype(np.float32))

    def run(seed=None, train=True):
        if seed is not None:
            tpt.seed(seed)
        tl.train(train)
        with torch.no_grad(), tstats.collect() as ms:
            y = tl(x)
        return y, ms.counts(4)

    a, ca = run(5)
    torch.manual_seed(123)  # the global RNG plays no part
    b, cb = run(5)
    c, cc = run(6)
    assert torch.equal(a, b) and torch.equal(ca, cb)
    assert not torch.equal(a, c)
    # eval mode routes greedily: the same as a jitter-free layer in train
    greedy, _ = run(train=False)
    tl.jitter = 0.0
    plain, _ = run(train=True)
    assert torch.equal(greedy, plain) and not torch.equal(greedy, a)


# -- dense equivalence --------------------------------------------------------
def test_routed_model_equals_the_dense_model():
    """Identical experts, top-1 and capacity >= tokens: the routed model
    is the dense model.  The JAX package's own bit-identity test fails on
    this tree (ROADMAP §C); the port holds the invariant at a stated
    tolerance, since its batched expert products sum in another order than
    the dense product: loss at rtol 1e-6, every shared gradient within
    1e-5 of its tensor's largest entry, and each expert weight's gradients
    summed over experts equal the dense layer's."""
    E = 4
    dense = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    moe = tgpt.GPTForCausalLM(
        tgpt.gpt_tiny(moe_experts=E, moe_top_k=1,
                      moe_capacity_factor=float(2 * E), moe_jitter=0.0,
                      moe_balance_weight=0.0),
        device="cpu", generator=torch.Generator().manual_seed(0))
    dp = dict(dense.named_parameters())
    with torch.no_grad():
        for name, p in moe.named_parameters():
            if name in dp:
                p.copy_(dp[name])
        for bd, bm in zip(dense.gpt.blocks, moe.gpt.blocks):
            bm.mlp.expert_fc1.copy_(bd.mlp.fc1.weight.expand(E, -1, -1))
            bm.mlp.expert_b1.copy_(bd.mlp.fc1.bias.expand(E, -1))
            bm.mlp.expert_fc2.copy_(bd.mlp.fc2.weight.expand(E, -1, -1))
            bm.mlp.expert_b2.copy_(bd.mlp.fc2.bias.expand(E, -1))
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, 128, size=(2, 12)))
    losses, grads = [], []
    for net in (dense, moe):
        net.train()
        loss = net.loss(net(ids), ids)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad for n, p in net.named_parameters()})
    gd, gm = grads
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    for name, g in gd.items():
        if ".mlp." in name:
            continue
        _grad_close(gm[name].numpy(), g.numpy(), name)
    for i in range(len(dense.gpt.blocks)):
        pre = f"gpt.blocks.{i}.mlp."
        assert float(gm[pre + "expert_fc1"].abs().max()) > 0
        for expert, dname in (("expert_fc1", "fc1.weight"),
                              ("expert_b1", "fc1.bias"),
                              ("expert_fc2", "fc2.weight"),
                              ("expert_b2", "fc2.bias")):
            _grad_close(gm[pre + expert].sum(0).numpy(),
                        gd[pre + dname].numpy(), pre + expert)
        assert not bool(gm[pre + "gate"].any())  # top-1: no router gradient


def test_zero_experts_is_the_dense_model():
    """``moe_experts=0`` builds dense blocks, whatever the other MoE knobs
    say: the same parameters, logits and loss (bit for bit), no aux."""
    a = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu",
                            generator=torch.Generator().manual_seed(1))
    b = tgpt.GPTForCausalLM(
        tgpt.gpt_tiny(moe_top_k=1, moe_capacity_factor=3.0, moe_jitter=0.5,
                      moe_balance_weight=1.0),
        device="cpu", generator=torch.Generator().manual_seed(1))
    assert not any(isinstance(m, MoELayer) for m in b.modules())
    assert [n for n, _ in a.named_parameters()] == [
        n for n, _ in b.named_parameters()]
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, 128, size=(2, 10)))
    la, lb = a(ids), b(ids)
    assert b._moe_aux is None  # no MoE block recorded an aux loss
    assert torch.equal(la, lb)
    assert torch.equal(a.loss(la, ids), b.loss(lb, ids))


# -- the model against JAX ----------------------------------------------------
MOE_KW = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25,
              moe_jitter=0.0)


def _gpt_pair(seed=3, **kw):
    jpt.seed(seed)
    jnet = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**MOE_KW, **kw))
    tnet = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**MOE_KW, **kw), device="cpu")
    init = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    load_jax_params(tnet, init)
    return jnet, tnet, init


def test_gpt_logits_and_loss_with_aux_match_jax():
    jnet, tnet, _ = _gpt_pair()
    assert isinstance(tnet.gpt.blocks[0].mlp, MoELayer)
    ids = np.random.RandomState(4).randint(0, 128, size=(2, 16)).astype(
        np.int32)
    jnet.eval()
    tnet.eval()
    jlog = jnet(jnp.asarray(ids))
    jaux = float(jnet._moe_aux)
    jloss = float(jnet.loss(jlog, jnp.asarray(ids)))
    tid = torch.from_numpy(ids).long()
    with torch.no_grad():
        tlog = tnet(tid)
        taux = float(tnet._moe_aux)
        tloss = float(tnet.loss(tlog, tid))
    assert tnet._moe_aux is None  # consumed by loss
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    assert 1.0 <= taux / len(tnet.gpt.blocks) < 4.0  # Switch aux ~ 1
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    # the aux term is really in the loss: weight 0.01 x the summed aux
    with torch.no_grad():
        tlog = tnet(tid)
        tnet._moe_aux = None
        bare = float(tnet.loss(tlog, tid))
    np.testing.assert_allclose(tloss - bare, 0.01 * taux, rtol=1e-4)


def test_gpt_two_train_batch_steps_match_jax():
    """Losses at rtol 1e-5 and parameters within 1e-4, as
    ``tests/test_torch_training.py`` holds the dense GPT (the key third of
    each ``qkv.bias``, zero in exact arithmetic, within ``steps · lr`` of
    its start on both sides)."""
    lr, steps = 1e-3, 2
    jnet, tnet, init = _gpt_pair(seed=5)
    jm = jpt.Model(jnet, ["x"], ["y"]).prepare(
        optimizer=jopt.AdamW(lr, weight_decay=0.01, multi_precision=True),
        loss=jnet.loss)
    tm = tpt.Model(tnet, ["x"], ["y"]).prepare(
        optimizer=tpt.optimizer.AdamW(lr, weight_decay=0.01,
                                      multi_precision=True),
        loss=tnet.loss)
    rng = np.random.RandomState(6)
    jl, tl = [], []
    for _ in range(steps):
        ids = rng.randint(0, 128, size=(2, 16)).astype(np.int32)
        jl.append(jm.train_batch([ids], [ids])[0])
        tl.append(tm.train_batch([ids], [ids])[0])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jparams = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    for name, p in tnet.named_parameters():
        got, want = p.detach().numpy(), jparams[name]
        if name.endswith("attn.qkv.bias"):
            d = got.shape[0] // 3
            for moved in (got[d:2 * d], want[d:2 * d]):
                assert np.abs(moved - init[name][d:2 * d]).max() <= (
                    steps * lr * 1.01)
            got, want = np.delete(got, np.s_[d:2 * d]), np.delete(
                want, np.s_[d:2 * d])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=name)
    moved = jparams["gpt.blocks.0.mlp.expert_fc1"] - init[
        "gpt.blocks.0.mlp.expert_fc1"]
    assert np.abs(moved).max() >= 0.5 * lr  # the experts really trained


# -- serving ------------------------------------------------------------------
ENGINE_CFG = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4,
                  max_position=64, dropout=0.0, moe_top_k=2, moe_jitter=0.0)
PROMPTS = [np.random.RandomState(k).randint(1, 61, size=3 + k).astype(
    np.int32) for k in range(3)]
NEW = 6


def _greedy(model, prompt, n):
    ids, out = list(map(int, prompt)), []
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([ids]))[0, -1]
            out.append(int(logits.argmax()))
            ids.append(out[-1])
    return out


def _engine_models(experts):
    jpt.seed(9)
    kw = dict(ENGINE_CFG, moe_experts=experts,
              moe_capacity_factor=float(max(experts, 1)))
    jnet = jgpt.GPTConfig(**kw)
    jmodel = jgpt.GPTForCausalLM(jnet)
    jmodel.eval()
    tmodel = tgpt.GPTForCausalLM(tgpt.GPTConfig(**kw), device="cpu")
    load_jax_params(tmodel, {k: np.asarray(p.value)
                             for k, p in jmodel.named_parameters()})
    tmodel.eval()
    return jmodel, tmodel


def test_moe_engine_tokens_and_counters():
    """Capacity factor = E: no token is dropped, routing inside the padded
    batch is per-token independent, so the served tokens equal the
    uncached greedy and the JAX engine's from the same weights; every
    post-warm step's routed tokens are counted."""
    jmodel, tmodel = _engine_models(4)
    launches = grouped_matmul.launches
    with GenerationEngine(tmodel, prompt_buckets=[8], batch_size=2,
                          paged=True, kv_page_size=8, speculative_k=2,
                          name="moe-port") as eng:
        eng.warmup()
        widths = []
        step = eng._step

        def counted(packed, cache):
            widths.append((packed.shape[1] - eng._C - eng._C // 8) // 2)
            return step(packed, cache)

        eng._step = counted
        outs = [eng.submit(p, NEW).result(120).tolist() for p in PROMPTS]
        st = eng.stats()
    with JaxEngine(jmodel, prompt_buckets=[8], batch_size=2,
                   continuous=True, name="moe-jax") as jeng:
        jeng.warmup()
        jouts = [jeng.submit(p, NEW).result(300).tolist() for p in PROMPTS]
    for p, o, jo in zip(PROMPTS, outs, jouts):
        assert o == _greedy(tmodel, p, NEW) == jo
    layers, k, B = 2, 2, 2
    assert st["moe_routed_tokens"] == sum(layers * k * B * w
                                          for w in widths)
    assert st["moe_dropped_tokens"] == 0 and st["moe_overflow_frac"] == 0.0
    assert st["moe_sampled_steps_after_warm"] == st["decode_steps"] == len(
        widths)
    assert st["moe_overflow_steps_after_warm"] == 0
    assert st["moe_dead_experts"] >= 0
    assert grouped_matmul.launches == launches  # the CPU never launches


def test_dense_engine_publishes_no_moe_keys():
    _, tmodel = _engine_models(0)
    with GenerationEngine(tmodel, prompt_buckets=[8], batch_size=2,
                          paged=True, kv_page_size=8,
                          name="dense-port") as eng:
        eng.warmup()
        out = eng.submit(PROMPTS[0], NEW).result(120).tolist()
        st = eng.stats()
    assert out == _greedy(tmodel, PROMPTS[0], NEW)
    assert not [key for key in st if key.startswith("moe_")], st


def test_quantized_moe_engine_is_not_ported():
    # a quantized MoE engine serves and the config builds, its experts
    # float (tests/test_torch_moe_serving.py holds the tokens to JAX's)
    _, tmodel = _engine_models(4)
    with GenerationEngine(tmodel, prompt_buckets=[8], paged=True,
                          quantized="int8", kv_page_size=8) as eng:
        out = eng.generate(PROMPTS[0], NEW, timeout=120)
    assert len(out) == NEW and eng.quant_active
    m = tgpt.GPTForCausalLM(tgpt.gpt_tiny(moe_experts=2, quantization="int8"),
                            device="cpu")
    assert m.gpt.blocks[0].attn.qkv.weight.dtype == torch.int8
    assert m.gpt.blocks[0].mlp.expert_fc1.dtype == torch.float32


def test_stats_stack_is_thread_local():
    seen = {}
    ready, done = threading.Event(), threading.Event()

    def other():
        with tstats.collect() as ms:
            ready.set()
            done.wait(10)
            seen["other"] = len(ms.entries)

    t = threading.Thread(target=other)
    t.start()
    ready.wait(10)
    with tstats.collect() as mine:
        tstats.record(torch.tensor(1.0), torch.ones(2, dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32))
    done.set()
    t.join(10)
    assert seen["other"] == 0 and len(mine.entries) == 1
    assert mine.counts(2).tolist() == [[1, 1], [0, 0]]
    assert float(mine.total_aux()) == 1.0
    with tstats.collect() as empty:
        pass
    assert empty.total_aux() is None
    assert empty.counts(3).tolist() == [[0, 0, 0], [0, 0, 0]]


# -- on the card --------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("D, F", [(128, 256), (40, 100)])
def test_layer_on_card_matches_cpu_and_breaks_ties_low(D, F):
    """At any width, lane-aligned or not, the card runs kernel 10 (the CPU
    the masked einsum): outputs, aux and counts agree, float32 at 1e-5;
    under a zero gate every probability ties and the card, too, picks
    experts 0 and 1 (``torch.topk``'s order on ties varies there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg = _Cfg(D=D, F=F, E=4, k=2, cf=1.25)
    layer = MoELayer(cfg)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    layer.eval()
    x = torch.from_numpy(np.random.RandomState(3).randn(64, D).astype(
        np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        ldev = layer.to(dev)
        before = grouped_matmul.launches
        with torch.no_grad(), tstats.collect() as ms:
            y = ldev(x.to(dev))
        out[dev] = (y.cpu(), float(ms.total_aux()), ms.counts(4).cpu(),
                    grouped_matmul.launches - before)
    (yc, ac, cc, nc), (yh, ah, ch, nh) = out["cuda"], out["cpu"]
    assert (nc, nh) == (2, 0)
    assert torch.equal(cc, ch)
    torch.testing.assert_close(yc, yh, rtol=1e-5, atol=1e-5)
    assert abs(ac - ah) <= 1e-6 * abs(ah)
    layer = layer.to("cuda")
    with torch.no_grad():
        layer.gate.zero_()
        with tstats.collect() as ms:
            layer(x.cuda())
    # 64 tokens pick experts 0 and 1; C = ceil(2 x 64 x 1.25 / 4) = 40
    assert ms.counts(4).cpu().tolist() == [[40, 40, 0, 0], [24, 24, 0, 0]]
