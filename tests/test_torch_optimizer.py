"""Port of the optimizers, regularizers, clips and lr schedulers
(paddle_tpu_torch/optimizer, paddle_tpu_torch/regularizer.py) held
against the JAX package's functional ``opt.init`` / ``opt.update``: every
rule (SGD, Momentum, Adam, AdamW, and since the sparse slice Adagrad,
Ftrl, Adamax, RMSProp, Adadelta, Lamb, Lars), the weight averaging
(EMA, ModelAverage, Lookahead) and gradient merge over four steps, and a
JAX optimizer state loaded into the port and stepped once more.

Three steps on numpy parameters and gradients from a seed, with the
learning rate passed as the JAX training step passes it (a float32
scalar); parameters, every slot (JAX's slot names) and the step count
are compared.  Tolerances:

* float32, and the float32 ``master`` slot under ``multi_precision``:
  rtol 1e-5, atol 1e-6 (the same float32 arithmetic, fused differently);
* bf16 parameters: rtol/atol 1e-2 — the cast-down master may round the
  other way at a tie, and without a master the JAX rule rounds some
  intermediates to bf16 where the port computes in float32 (the
  optimizer module's docstring).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = {"w": (4, 5), "b": (5,), "ln.weight": (7,)}
STEPS = 3

# name -> factory(opt module, regularizer module, lr module, **kw)
CASES = {
    "sgd": lambda o, r, s, **k: o.SGD(0.1, **k),
    "sgd_l2_float": lambda o, r, s, **k: o.SGD(0.1, weight_decay=0.01, **k),
    "sgd_clip_norm": lambda o, r, s, **k: o.SGD(
        0.1, grad_clip=o.ClipGradByNorm(0.3), **k),
    "momentum": lambda o, r, s, **k: o.Momentum(0.1, momentum=0.9, **k),
    "momentum_nesterov_l2decay": lambda o, r, s, **k: o.Momentum(
        0.1, momentum=0.9, use_nesterov=True,
        weight_decay=r.L2Decay(0.02), **k),
    "momentum_clip_value": lambda o, r, s, **k: o.Momentum(
        0.1, grad_clip=o.ClipGradByValue(0.2), **k),
    "adam": lambda o, r, s, **k: o.Adam(1e-2, **k),
    "adam_l1decay": lambda o, r, s, **k: o.Adam(
        1e-2, weight_decay=r.L1Decay(0.01), **k),
    "adam_clip_global_norm": lambda o, r, s, **k: o.Adam(
        1e-2, grad_clip=o.ClipGradByGlobalNorm(0.5), **k),
    "adamw": lambda o, r, s, **k: o.AdamW(1e-2, weight_decay=0.05, **k),
    "adamw_decay_fn": lambda o, r, s, **k: o.AdamW(
        1e-2, weight_decay=0.05,
        apply_decay_param_fun=lambda n: not n.endswith("weight"), **k),
    "adamw_scheduler": lambda o, r, s, **k: o.AdamW(
        s.StepDecay(1e-2, step_size=1, gamma=0.5), weight_decay=0.01, **k),
    "adagrad": lambda o, r, s, **k: o.Adagrad(0.1, **k),
    "adagrad_init_acc_l2": lambda o, r, s, **k: o.Adagrad(
        0.1, initial_accumulator_value=0.1, weight_decay=0.01, **k),
    "ftrl": lambda o, r, s, **k: o.Ftrl(0.1, l1=1e-3, l2=0.01, **k),
    "ftrl_lr_power": lambda o, r, s, **k: o.Ftrl(0.1, lr_power=-0.7, **k),
    "adamax": lambda o, r, s, **k: o.Adamax(1e-2, **k),
    "rmsprop": lambda o, r, s, **k: o.RMSProp(1e-2, **k),
    "rmsprop_centered_momentum": lambda o, r, s, **k: o.RMSProp(
        1e-2, centered=True, momentum=0.9, **k),
    "adadelta": lambda o, r, s, **k: o.Adadelta(1.0, **k),
    "lamb": lambda o, r, s, **k: o.Lamb(1e-2, lamb_weight_decay=0.01, **k),
    "lamb_exclude_fn": lambda o, r, s, **k: o.Lamb(
        1e-2, exclude_from_weight_decay_fn=lambda n: n == "b", **k),
    "lars": lambda o, r, s, **k: o.Lars(0.1, lars_coeff=0.01, **k),
    "lars_exclude": lambda o, r, s, **k: o.Lars(
        0.1, exclude_from_weight_decay=["ln"], **k),
}
DTYPES = {"float32": (np.float32, False), "float32_mp": (np.float32, True),
          "bfloat16": ("bfloat16", False), "bfloat16_mp": ("bfloat16", True)}


def _data(seed):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * (0.5 + t)).astype(np.float32)
              for k, s in SHAPES.items()} for t in range(STEPS)]
    return params, grads


def _run_jax(case, dtype, mp, params, grads):
    opt = CASES[case](jopt, jreg, jlr, multi_precision=mp)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    p = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        p, state = opt.update({k: jnp.asarray(v, jdt) for k, v in g.items()},
                              state, p,
                              lr=jnp.asarray(opt.get_lr(), jnp.float32))
        if opt.lr_scheduler is not None:
            opt.lr_scheduler.step()
    return p, state


def _run_torch(case, dtype, mp, params, grads):
    opt = CASES[case](topt, treg, tlr, multi_precision=mp)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p = {k: torch.tensor(v, dtype=tdt) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        p, state = opt.update({k: torch.tensor(v, dtype=tdt)
                               for k, v in g.items()}, state, p)
        if opt.lr_scheduler is not None:
            opt.lr_scheduler.step()
    return p, state


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(case, dtype):
    dt, mp = DTYPES[dtype]
    params, grads = _data(list(CASES).index(case))
    jp, js = _run_jax(case, dt, mp, params, grads)
    tp, ts = _run_torch(case, dt, mp, params, grads)
    assert ts["count"] == int(js["count"]) == STEPS
    tight = dict(rtol=1e-5, atol=1e-6)
    loose = dict(rtol=1e-2, atol=1e-2)
    for name in SHAPES:
        assert tp[name].dtype == (torch.bfloat16 if dt == "bfloat16"
                                  else torch.float32)
        np.testing.assert_allclose(_f32(tp[name]), _f32(jp[name]),
                                   err_msg=name,
                                   **(tight if dt == np.float32 else loose))
        jslots, tslots = js["slots"][name], ts["slots"][name]
        assert set(tslots) == set(jslots), (set(tslots), set(jslots))
        for slot, v in tslots.items():
            assert v.dtype == torch.float32, (name, slot)
            exact = dt == np.float32 or mp
            np.testing.assert_allclose(_f32(v), _f32(jslots[slot]),
                                       err_msg=f"{name}.{slot}",
                                       **(tight if exact else loose))


def test_master_slot_only_for_low_precision_with_multi_precision():
    opt = topt.AdamW(1e-3, multi_precision=True)
    st = opt.init({"a": torch.zeros(3, dtype=torch.bfloat16),
                   "b": torch.zeros(3)})
    assert set(st["slots"]["a"]) == {"master", "moment1", "moment2"}
    assert set(st["slots"]["b"]) == {"moment1", "moment2"}
    st = topt.Adam(1e-3).init({"a": torch.zeros(3, dtype=torch.bfloat16)})
    assert set(st["slots"]["a"]) == {"moment1", "moment2"}
    assert st["slots"]["a"]["moment1"].dtype == torch.float32


def test_eager_step_reads_grads_and_equals_update():
    params, grads = _data(1)
    bound = {k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}
    eager = topt.AdamW(1e-2, parameters=bound, weight_decay=0.05)
    func = topt.AdamW(1e-2, weight_decay=0.05)
    p = {k: torch.tensor(v) for k, v in params.items()}
    state = func.init(p)
    for g in grads:
        for k, t in bound.items():
            t.grad = torch.tensor(g[k])
        eager.step()
        eager.clear_grad()
        p, state = func.update({k: torch.tensor(v) for k, v in g.items()},
                               state, p)
    for k in SHAPES:
        torch.testing.assert_close(bound[k].detach(), p[k], rtol=0, atol=0)
        assert bound[k].grad is None
    sd = eager.state_dict()
    assert sd["count"] == STEPS
    assert set(sd) == {"count"} | {f"{k}.{s}" for k in SHAPES
                                   for s in ("moment1", "moment2")}


def test_update_is_pure():
    params, grads = _data(2)
    p = {k: torch.tensor(v) for k, v in params.items()}
    opt = topt.Momentum(0.1)
    state = opt.init(p)
    new_p, new_state = opt.update({k: torch.tensor(v)
                                   for k, v in grads[0].items()}, state, p)
    assert state["count"] == 0 and new_state["count"] == 1
    for k in SHAPES:
        np.testing.assert_array_equal(p[k].numpy(), params[k])
        assert not torch.equal(new_p[k], p[k])
        assert float(state["slots"][k]["velocity"].abs().sum()) == 0.0


def test_adamw_rejects_l1decay_and_sgd_without_parameters_cannot_step():
    with pytest.raises(InvalidArgumentError):
        topt.AdamW(1e-3, weight_decay=treg.L1Decay(0.1))
    with pytest.raises(InvalidArgumentError, match="parameters"):
        topt.SGD(0.1).step()


SCHEDULERS = {
    "noam": lambda s: s.NoamDecay(d_model=64, warmup_steps=5,
                                  learning_rate=2.0),
    "piecewise": lambda s: s.PiecewiseDecay([3, 8], [0.1, 0.05, 0.01]),
    "natural_exp": lambda s: s.NaturalExpDecay(0.1, gamma=0.3),
    "inverse_time": lambda s: s.InverseTimeDecay(0.1, gamma=0.5),
    "polynomial": lambda s: s.PolynomialDecay(0.1, decay_steps=7,
                                              end_lr=0.01, power=2.0),
    "polynomial_cycle": lambda s: s.PolynomialDecay(0.1, decay_steps=6,
                                                    cycle=True),
    "linear_warmup_float": lambda s: s.LinearWarmup(0.1, warmup_steps=4,
                                                    start_lr=0.0,
                                                    end_lr=0.1),
    "linear_warmup_inner": lambda s: s.LinearWarmup(
        s.CosineAnnealingDecay(0.1, T_max=9), warmup_steps=4, start_lr=0.01,
        end_lr=0.1),
    "exponential": lambda s: s.ExponentialDecay(0.1, gamma=0.8),
    "multi_step": lambda s: s.MultiStepDecay(0.1, milestones=[4, 9, 15],
                                             gamma=0.5),
    "step": lambda s: s.StepDecay(0.1, step_size=6, gamma=0.3),
    "lambda": lambda s: s.LambdaDecay(0.1, lambda e: 1.0 / (1 + e)),
    "cosine": lambda s: s.CosineAnnealingDecay(0.1, T_max=12, eta_min=0.01),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_jax_over_20_steps(name):
    js, ts = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    got, want = [], []
    for _ in range(20):
        got.append(ts())
        want.append(js())
        ts.step()
        js.step()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert ts.state_dict() == js.state_dict()


def test_reduce_on_plateau_matches_jax_over_20_steps():
    kw = dict(learning_rate=0.1, patience=2, factor=0.5, cooldown=1)
    js, ts = jlr.ReduceOnPlateau(**kw), tlr.ReduceOnPlateau(**kw)
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.81, 0.82, 0.83, 0.84,
               0.85, 0.7, 0.71, 0.72, 0.73, 0.74, 0.75, 0.76, 0.77, 0.78]
    for m in metrics:
        js.step(m)
        ts.step(m)
        assert ts() == js()
    assert ts() < 0.1


# -- weight averaging and gradient merge, four steps --------------------------
AVG_STEPS = 4


def _grads_list(seed):
    _, grads = _data(seed)
    rng = np.random.RandomState(seed + 100)
    grads.append({k: rng.randn(*s).astype(np.float32)
                  for k, s in SHAPES.items()})
    return grads


def _jax_params(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _torch_params(params):
    return {k: torch.tensor(v) for k, v in params.items()}


def _assert_tree(t, j, path=""):
    if isinstance(t, dict):
        assert set(t) == set(j), (path, set(t), set(j))
        for k in t:
            _assert_tree(t[k], j[k], f"{path}.{k}")
    else:
        np.testing.assert_allclose(_f32(t), _f32(j), rtol=1e-5, atol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("inner", ["sgd", "adam", "adamw_mp_bf16"])
def test_lookahead_four_steps_match_jax(inner):
    make = {"sgd": lambda o: o.SGD(0.1),
            "adam": lambda o: o.Adam(1e-2),
            "adamw_mp_bf16": lambda o: o.AdamW(
                1e-2, weight_decay=0.05, multi_precision=True)}[inner]
    bf16 = inner.endswith("bf16")
    params, _ = _data(7)
    grads = _grads_list(7)
    jl = jopt.Lookahead(make(jopt), alpha=0.5, k=2)
    tl = topt.Lookahead(make(topt), alpha=0.5, k=2)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    tp = {k: torch.tensor(v, dtype=tdt) for k, v in params.items()}
    js, ts = jl.init(jp), tl.init(tp)
    for g in grads:
        jp, js = jl.update({k: jnp.asarray(v, jdt) for k, v in g.items()},
                           js, jp, lr=jnp.asarray(jl.get_lr(), jnp.float32))
        tp, ts = tl.update({k: torch.tensor(v, dtype=tdt)
                            for k, v in g.items()}, ts, tp)
    assert ts["count"] == int(js["count"]) == AVG_STEPS
    tol = dict(rtol=1e-2, atol=1e-2) if bf16 else dict(rtol=1e-5, atol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(_f32(tp[k]), _f32(jp[k]), err_msg=k,
                                   **tol)
        np.testing.assert_allclose(_f32(ts["slow"][k]), _f32(js["slow"][k]),
                                   err_msg=k, rtol=1e-5, atol=1e-6)
    sd = topt.Lookahead(make(topt), k=2)
    assert sd.state_dict() == {}


@pytest.mark.parametrize("k_steps,avg", [(2, True), (4, False), (1, True)])
def test_gradient_merge_four_steps_matches_jax(k_steps, avg):
    from paddle_tpu.optimizer.gradient_merge import \
        GradientMergeOptimizer as JGM
    from paddle_tpu_torch.optimizer.gradient_merge import \
        GradientMergeOptimizer as TGM

    params, _ = _data(8)
    grads = _grads_list(8)
    jg = JGM(jopt.Adam(1e-2), k_steps=k_steps, avg=avg)
    tg = TGM(topt.Adam(1e-2), k_steps=k_steps, avg=avg)
    jp, tp = _jax_params(params), _torch_params(params)
    js, ts = jg.init(jp), tg.init(tp)
    for g in grads:
        jp, js = jg.update(_jax_params(g), js, jp,
                           lr=jnp.asarray(1e-2, jnp.float32))
        tp, ts = tg.update(_torch_params(g), ts, tp)
    assert ts["count"] == int(js["count"]) == AVG_STEPS // k_steps
    _assert_tree(tp, jp)
    _assert_tree(ts["slots"], js["slots"])


def _layer_pair(seed):
    import paddle_tpu as jpt
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.bridge import load_jax_params

    jpt.seed(seed)
    jnet = jnn.Linear(5, 3)
    tnet = tnn.Linear(5, 3)
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    return jnet, tnet


@pytest.mark.parametrize("which", ["ema", "ema_thres", "model_average"])
def test_ema_and_model_average_four_steps_match_jax(which):
    make = {"ema": lambda o, n: o.ExponentialMovingAverage(n, decay=0.9),
            "ema_thres": lambda o, n: o.ExponentialMovingAverage(
                n, decay=0.99, thres_steps=True),
            "model_average": lambda o, n: o.ModelAverage(
                n, average_window_rate=0.5, min_average_window=2,
                max_average_window=3)}[which]
    jnet, tnet = _layer_pair(9)
    jo = jopt.SGD(0.1, parameters=jnet.parameters())
    to = topt.SGD(0.1, parameters=list(tnet.parameters()))
    ja, ta = make(jopt, jnet), make(topt, tnet)
    rng = np.random.RandomState(9)
    for _ in range(AVG_STEPS):
        g = [rng.randn(5, 3).astype(np.float32),
             rng.randn(3).astype(np.float32)]
        jo.step([jnp.asarray(x) for x in g])
        to.step([torch.tensor(x) for x in g])
        ja.update()
        ta.update()
    trained = {k: p.detach().clone() for k, p in tnet.named_parameters()}
    with ja.apply(), ta.apply():
        for k, p in tnet.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(),
                np.asarray(dict(jnet.named_parameters())[k].value),
                rtol=1e-5, atol=1e-6, err_msg=k)
            assert not torch.equal(p, trained[k])
    for k, p in tnet.named_parameters():  # restored
        assert torch.equal(p.detach(), trained[k])


# -- a JAX optimizer state resumes in the port --------------------------------
RESUME = {
    "momentum": lambda o: o.Momentum(0.1, momentum=0.9),
    "adam": lambda o: o.Adam(1e-2),
    "adamw_mp": lambda o: o.AdamW(1e-2, weight_decay=0.05,
                                  multi_precision=True),
    "adagrad": lambda o: o.Adagrad(0.1, initial_accumulator_value=0.1),
    "ftrl": lambda o: o.Ftrl(0.1, l1=1e-3, l2=0.01),
    "rmsprop_centered": lambda o: o.RMSProp(1e-2, centered=True,
                                            momentum=0.9),
    "adadelta": lambda o: o.Adadelta(1.0),
    "lamb": lambda o: o.Lamb(1e-2),
    "lars": lambda o: o.Lars(0.1, lars_coeff=0.01),
}


@pytest.mark.parametrize("case", list(RESUME))
def test_jax_state_dict_resumes_in_the_port(case):
    """Two JAX steps, the state as ``state_dict`` keys (``count``,
    ``<param>.<slot>``, numpy leaves) into a port optimizer bound to the
    same parameters, one eager port step: equal to JAX's third step."""
    params, grads = _data(11)
    jo = RESUME[case](jopt)
    jp = _jax_params(params)
    js = jo.init(jp)
    for g in grads[:2]:
        jp, js = jo.update(_jax_params(g), js, jp,
                           lr=jnp.asarray(jo.get_lr(), jnp.float32))
    flat = {"count": np.asarray(js["count"])}
    for pname, slots in js["slots"].items():
        for sname, v in slots.items():
            flat[f"{pname}.{sname}"] = np.asarray(v)
    bound = {k: torch.tensor(np.asarray(v), requires_grad=True)
             for k, v in jp.items()}
    to = RESUME[case](topt)
    to._bind(bound)
    to.set_state_dict(flat)
    to.step({k: torch.tensor(v) for k, v in grads[2].items()})
    jp, js = jo.update(_jax_params(grads[2]), js, jp,
                       lr=jnp.asarray(jo.get_lr(), jnp.float32))
    assert to.state_dict()["count"] == int(js["count"]) == 3
    for k in SHAPES:
        np.testing.assert_allclose(bound[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    _assert_tree(to._state["slots"], js["slots"])


@pytest.mark.parametrize("wrapper", ["lookahead", "gradient_merge"])
def test_wrapped_optimizer_state_survives_model_save_and_load(tmp_path,
                                                              wrapper):
    """``Model.save`` writes a wrapper's whole state tree (Lookahead's
    ``{"inner", "slow", "count"}``, gradient merge's slots with their
    ``gm_acc`` and micro-step) and ``Model.load`` restores it, so a
    resumed run steps exactly as the uninterrupted one."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.optimizer.gradient_merge import \
        GradientMergeOptimizer

    def make():
        net = tnn.Linear(5, 3)
        net.reset_parameters(torch.Generator().manual_seed(0))
        inner = topt.Adam(1e-2)
        opt = (topt.Lookahead(inner, alpha=0.5, k=2) if wrapper == "lookahead"
               else GradientMergeOptimizer(inner, k_steps=2))
        return net, tpt.Model(net, inputs=1, labels=1).prepare(
            optimizer=opt, loss=lambda o, y: ((o - y) ** 2).mean())

    rng = np.random.RandomState(0)
    batches = [(rng.randn(4, 5).astype(np.float32),
                rng.randn(4, 3).astype(np.float32)) for _ in range(5)]
    net, m = make()
    for x, y in batches[:3]:
        m.train_batch([x], [y])
    m.save(str(tmp_path / "ckpt"))
    twin, m2 = make()
    m2.load(str(tmp_path / "ckpt"))
    for x, y in batches[3:]:
        m.train_batch([x], [y])
        m2.train_batch([x], [y])
    for (k, a), b in zip(net.named_parameters(), twin.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
