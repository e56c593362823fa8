"""The port's ``amp`` (the per-layer autocast policy, ``decorate``,
``GradScaler``) held against the JAX package's ``paddle_tpu.amp``.

* Per-layer dtypes: the float dtypes of every layer call's inputs (after
  the policy) and outputs, recorded by forward hooks on a tiny
  ``BertForPretraining``, equal JAX's layer for layer under O1, O2, and O1
  with custom white / black lists.
* A tiny BERT's MLM + NSP loss and every parameter's gradient under O1
  against ``jax.grad`` under JAX's O1 (with JAX's ``layernorm_residual``
  wrapped so that its VJP returns each cotangent in its input's dtype, as
  autograd does: JAX's own cannot be differentiated here, a standing
  difference pinned by its own test): the loss within 2e-2 relative and
  each gradient within 3e-2 of its L2 norm (bf16 products round their
  outputs to 8 mantissa bits, in other places in the two packages).  The
  key third of each ``qkv.bias`` has no gradient in exact arithmetic: it
  is held to an absolute bound instead.  The gradients reach the float32
  parameters in float32.
* ``decorate`` at O2: bf16 parameters, float32 masters in the optimizer,
  and the MLM decoder's float32 ``h`` against the bf16 table promoted as
  ``jnp.einsum`` promotes it; one train step's loss against JAX's.
* A layer's parameters are restored when its call raises.
* ``GradScaler``'s state machine, step for step against JAX's eager
  scaler: the scale, the counters, skipped steps on inf / nan gradients,
  the parameters after each step, and ``state_dict`` both ways.

The JAX BERT takes its fused route (``layernorm_residual`` and
``softmax_cross_entropy``, the Pallas kernels in interpret mode) because
the tests open its CPU gate ``paddle_tpu.models.bert._fused_epilogues``;
the port always takes the fused form, which like the TPU route returns
``layernorm_residual``'s outputs in x's dtype (on the CPU the JAX model
would run ``ln1(x + ...)``, whose black-listed LayerNorm returns float32).
Dropout is 0 and inputs are numpy arrays from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.amp as jamp
import paddle_tpu.models.bert as jbert_mod
import paddle_tpu_torch as tpt
import paddle_tpu_torch.amp as tamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn.layer_base import Parameter, functional_call
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn import Linear


@pytest.fixture
def fused_jax(monkeypatch):
    monkeypatch.setattr(jbert_mod, "_fused_epilogues",
                        lambda feature_dim=None: True)


def _cotangents_in_primal_dtypes(op):
    """``op`` (JAX's ``layernorm_residual``) whose VJP hands each input a
    cotangent in that input's dtype — what autograd does with the port's.
    JAX's own VJP hands a float32 residual a bf16 cotangent, which
    ``jax.grad`` of BERT under O1 then cannot add to the float32 cotangent
    that the attention's input cast sends the same value: ``lax.add``
    raises (ROADMAP §C).  The values are the op's own."""
    def wrapped(x, residual, weight, bias, **kw):
        dtypes = [a.dtype for a in (x, residual, weight, bias)]
        fn = lambda *a: op(*a, **kw)  # noqa: E731

        @jax.custom_vjp
        def f(*a):
            return fn(*a)

        def f_fwd(*a):
            return jax.vjp(fn, *a)

        def f_bwd(vjp, ct):
            return tuple(c.astype(dt) for c, dt in zip(vjp(ct), dtypes))

        f.defvjp(f_fwd, f_bwd)
        return f(x, residual, weight, bias)
    return wrapped


def _batch(seed=0, B=2, S=16, P=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, size=(B, S)).astype(np.int32)
    tt = (rng.rand(B, S) < 0.5).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, 12:] = 0
    mp = np.stack([np.sort(rng.choice(S, P, replace=False))
                   for _ in range(B)]).astype(np.int32)
    mlm = np.take_along_axis(ids, mp, axis=1)
    nsp = rng.randint(0, 2, size=(B, 1)).astype(np.int32)
    return [ids, tt, am, mp], [mlm, nsp]


def _pair(seed=3):
    jpt.seed(seed)
    jnet = jbert.BertForPretraining(jbert.bert_tiny())
    tnet = tbert.BertForPretraining(tbert.bert_tiny(), device="cpu")
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    return jnet, tnet


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _floats(tree):
    out = []
    if isinstance(tree, (tuple, list)):
        for v in tree:
            out += _floats(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            out += _floats(v)
    elif hasattr(tree, "dtype") and "float" in _dtype_name(tree):
        out.append(_dtype_name(tree))
    return out


def _record_jax(jnet, inputs, **amp):
    calls = []
    hooks = []
    for name, layer in jnet.named_sublayers(include_self=True):
        def hook(layer, args, out, name=name):
            calls.append((name, _floats(args), _floats(out)))
        hooks.append(layer.register_forward_post_hook(hook))
    with jamp.auto_cast(**amp):
        jnet(*[jnp.asarray(a) for a in inputs])
    for h in hooks:
        h.remove()
    return calls


def _record_torch(tnet, inputs, **amp):
    calls = []
    hooks = []
    for name, layer in tnet.named_modules():
        if isinstance(layer, torch.nn.ModuleList):
            continue

        def hook(layer, args, out, name=name):
            calls.append((name, _floats(args), _floats(out)))
        hooks.append(layer.register_forward_hook(hook))
    with tamp.auto_cast(**amp):
        with torch.no_grad():
            tnet(*[torch.from_numpy(a) for a in inputs])
    for h in hooks:
        h.remove()
    return calls


@pytest.mark.parametrize("amp", [
    dict(level="O1"),
    dict(level="O2"),
    dict(level="O1", custom_white_list=["GELU", "LayerNorm"],
         custom_black_list=["BertSelfAttention"]),
    dict(level="O1", dtype="float16"),
    dict(level="O0"),
], ids=["O1", "O2", "O1_custom_lists", "O1_float16", "O0"])
def test_per_layer_dtypes_match_jax(fused_jax, amp):
    jnet, tnet = _pair()
    inputs, _ = _batch()
    want = _record_jax(jnet, inputs, **amp)
    got = _record_torch(tnet, inputs, **amp)
    assert [c[0] for c in got] == [c[0] for c in want]
    for g, w in zip(got, want):
        assert g == w, (g, w)
    # not vacuous: the policy casts somewhere (or nowhere at O0)
    dts = {d for c in got for d in c[1] + c[2]}
    assert (dts == {"float32"}) == (amp["level"] == "O0")


def _jax_loss_and_grads(jnet, inputs, labels, **amp):
    params = {k: p.value for k, p in jnet.named_parameters()}

    def loss_fn(p):
        with jamp.auto_cast(**amp):
            out = functional_call(jnet, p, *[jnp.asarray(a) for a in inputs],
                                  training=True)
            return jnet.loss(*out, *[jnp.asarray(a) for a in labels])

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: np.asarray(v, np.float32)
                         for k, v in grads.items()}


def test_jax_fused_bert_cannot_take_its_own_o1_gradient(fused_jax):
    """The standing difference the gradient test works around."""
    jnet, _ = _pair(seed=4)
    inputs, labels = _batch(seed=1)
    with pytest.raises(TypeError, match="lax.add requires arguments to "
                       "have the same dtypes"):
        _jax_loss_and_grads(jnet, inputs, labels, level="O1")


def test_o1_loss_and_gradients_match_jax(fused_jax, monkeypatch):
    import paddle_tpu.ops.fused_layernorm as jfl

    monkeypatch.setattr(jfl, "layernorm_residual",
                        _cotangents_in_primal_dtypes(jfl.layernorm_residual))
    jnet, tnet = _pair(seed=4)
    inputs, labels = _batch(seed=1)
    jl, jg = _jax_loss_and_grads(jnet, inputs, labels, level="O1")
    tnet.train()
    with tamp.auto_cast(level="O1"):
        out = tnet(*[torch.from_numpy(a) for a in inputs])
        mlm, nsp = out
        assert mlm.dtype == torch.float32 and nsp.dtype == torch.bfloat16
        loss = tnet.loss(*out, *[torch.from_numpy(a) for a in labels])
    loss.backward()
    np.testing.assert_allclose(loss.item(), jl, rtol=2e-2)
    params = dict(tnet.named_parameters())
    assert set(params) == set(jg)
    for name, p in params.items():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        got, want = p.grad.numpy(), jg[name]
        if name.endswith("attn.qkv.bias"):
            d = want.shape[0] // 3
            # zero in exact arithmetic: both hold rounding noise only
            assert np.abs(got[d:2 * d]).max() <= 1e-2 * np.abs(want).max()
            got, want = np.delete(got, np.s_[d:2 * d]), np.delete(
                want, np.s_[d:2 * d])
        err = np.linalg.norm(got - want)
        assert err <= 3e-2 * np.linalg.norm(want) + 1e-6, (name, err)


def test_decorate_o2_with_masters_matches_jax(fused_jax):
    jnet, tnet = _pair(seed=5)
    jo = jopt.AdamW(1e-3, weight_decay=0.01)
    to = tpt.optimizer.AdamW(1e-3, weight_decay=0.01)
    jnet, jo = jamp.decorate(jnet, jo, level="O2")
    tnet, to = tamp.decorate(tnet, to, level="O2")
    assert to._multi_precision and jo._multi_precision
    assert all(p.dtype == torch.bfloat16 for p in tnet.parameters())
    names = ["x"] * 4, ["y"] * 2
    jm = jpt.Model(jnet, *names).prepare(jo, jnet.loss, amp_configs="O2")
    tm = tpt.Model(tnet, *names).prepare(to, tnet.loss, amp_configs="O2")
    inputs, labels = _batch(seed=2)
    jl = jm.train_batch(inputs, labels)[0]
    tl = tm.train_batch(inputs, labels)[0]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    sd = to.state_dict()
    for name, p in tnet.named_parameters():
        assert sd[f"{name}.master"].dtype == torch.float32
        assert torch.equal(p.detach(), sd[f"{name}.master"].to(p.dtype))
    # the tied decoder: bf16 table, float32 h (LayerNorm is black-listed)
    with tamp.auto_cast(level="O2"), torch.no_grad():
        mlm, _ = tnet(*[torch.from_numpy(a) for a in inputs])
    assert mlm.dtype == torch.float32
    # O1 and O2 are no-ops for decorate's other levels
    assert tamp.decorate(tnet, level="O1") is tnet


def test_parameters_are_restored_after_a_call_that_raises():
    lin = Linear(4, 3)
    lin.reset_parameters(torch.Generator().manual_seed(0))
    w, b = lin.weight, lin.bias
    with tamp.auto_cast(level="O1"):
        with pytest.raises(RuntimeError):
            lin(torch.randn(2, 5))  # wrong width: the matmul raises
        y = lin(torch.randn(2, 4))
        assert y.dtype == torch.bfloat16
        assert lin.weight is w  # restored after the call returned too
    assert lin.weight is w and lin.bias is b
    assert lin._parameters["weight"].dtype == torch.float32
    assert not tamp.amp_state().enabled


def test_policy_is_thread_local_and_nests():
    import threading

    seen = []
    with tamp.auto_cast(level="O2", dtype="float16"):
        t = threading.Thread(target=lambda: seen.append(
            tamp.amp_state().enabled))
        t.start()
        t.join()
        with tamp.auto_cast(level="O1"):
            assert tamp.amp_state().dtype == torch.bfloat16
        assert tamp.amp_state().dtype == torch.float16
    assert seen == [False] and not tamp.amp_state().enabled
    with pytest.raises(Exception, match="O3"):
        with tamp.auto_cast(level="O3"):
            pass
    assert tamp.amp_guard is tamp.auto_cast


# the scaler's schedule: finite / non-finite gradients, step by step
SCHEDULE = [False, False, False, True, False, True, True, False, False,
            False, True, False]


def _scalers(**kw):
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2, **kw)
    return jamp.GradScaler(**kw), tamp.GradScaler(**kw)


@pytest.mark.parametrize("dynamic", [True, False])
def test_grad_scaler_state_machine_matches_jax(dynamic):
    js, ts = _scalers(use_dynamic_loss_scaling=dynamic)
    rng = np.random.RandomState(0)
    w0 = rng.randn(3, 2).astype(np.float32)
    jw = Parameter(jnp.asarray(w0))
    jo = jopt.SGD(0.5, parameters=[jw])
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    to = tpt.optimizer.SGD(0.5, parameters=[tw])
    for i, bad in enumerate(SCHEDULE):
        g = rng.randn(3, 2).astype(np.float32) * js.get_loss_scaling()
        if bad:
            g[1, 0] = np.inf if i % 2 else np.nan
        loss = np.float32(rng.rand())
        np.testing.assert_array_equal(
            ts.scale(torch.tensor(loss)).numpy(),
            np.asarray(js.scale(jnp.asarray(loss))))
        js.step(jo, [jnp.asarray(g)])
        before = tw.detach().clone()
        tw.grad = torch.from_numpy(g.copy())
        ts.step(to)
        to.clear_grad()
        assert torch.equal(tw.detach(), before) == bad, i  # skipped
        js.update()
        ts.update()
        np.testing.assert_array_equal(tw.detach().numpy(),
                                      np.asarray(jw.value))
        jsd, tsd = js.state_dict(), ts.state_dict()
        assert jsd.keys() == tsd.keys()
        for k in jsd:
            assert np.asarray(jsd[k]).dtype == np.asarray(tsd[k]).dtype, k
            np.testing.assert_array_equal(tsd[k], jsd[k], err_msg=k)
    scales = {ts.get_loss_scaling()}
    assert (scales != {1024.0}) == dynamic and ts._skipped_steps == 4
    # state_dict crosses both ways
    js2, ts2 = _scalers()
    ts2.load_state_dict(js.state_dict())
    js2.load_state_dict(ts.state_dict())
    assert ts2.get_loss_scaling() == js2.get_loss_scaling() == \
        js.get_loss_scaling()


def test_grad_scaler_unscale_then_step_and_minimize():
    _, ts = _scalers()
    tw = torch.nn.Parameter(torch.ones(2))
    to = tpt.optimizer.SGD(1.0, parameters=[tw])
    tw.grad = torch.full((2,), 2048.0)
    ts.unscale(to)
    torch.testing.assert_close(tw.grad, torch.full((2,), 2.0))
    ts.step(to)  # does not divide again
    torch.testing.assert_close(tw.detach(), torch.full((2,), -1.0))
    tw.grad = torch.full((2,), float("inf"))
    ts.minimize(to)
    assert ts._state["bad_steps"] == 1
    off = tamp.GradScaler(enable=False)
    loss = torch.tensor(3.0)
    assert off.scale(loss) is loss and not off.is_enable()


@pytest.mark.parametrize("case", ["gpt_o2_decorated", "moe_gpt_o1"])
def test_gpt_products_promote_mixed_operands_as_jax(case, monkeypatch):
    """The products amp can hand mixed operands: GPT's tied LM head under
    O2 after ``decorate`` (ln_f's float32 output beside the bf16 table) and
    the MoE router and expert products under O1 (a bf16 activation beside
    float32 experts) promote as ``jnp.einsum`` does; the loss against
    JAX's within 3e-2 relative (JAX's fused gates forced open, as above,
    so both take the TPU route's dtypes)."""
    import paddle_tpu.models.gpt as jgpt_mod
    import paddle_tpu.ops.autotune as jat
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.models import gpt as tgpt

    monkeypatch.setattr(jgpt_mod, "_fused_epilogues",
                        lambda feature_dim=None: True)
    monkeypatch.setattr(jat, "fused_epilogues_eligible",
                        lambda feature_dim=None: True)
    kw = (dict(moe_experts=4, moe_top_k=2, moe_jitter=0.0)
          if case == "moe_gpt_o1" else {})
    level = "O2" if case == "gpt_o2_decorated" else "O1"
    jpt.seed(6)
    jnet = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**kw))
    tnet = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**kw), device="cpu")
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    if level == "O2":
        jnet = jamp.decorate(jnet, level="O2")
        tnet = tamp.decorate(tnet, level="O2")
    ids = np.random.RandomState(8).randint(0, 128, size=(2, 16)).astype(
        np.int32)
    with jamp.auto_cast(level=level):
        jlogits = jnet(jnp.asarray(ids))
        jl = float(jnet.loss(jlogits, jnp.asarray(ids)))
    tnet.eval()
    with tamp.auto_cast(level=level), torch.no_grad():
        tlogits = tnet(torch.from_numpy(ids))
        tl = float(tnet.loss(tlogits, torch.from_numpy(ids)))
    assert tlogits.dtype == torch.float32
    assert str(jlogits.dtype) == "float32"
    np.testing.assert_allclose(tl, jl, rtol=3e-2)
