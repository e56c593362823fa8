"""The port's checkpoints (``paddle_tpu_torch.save`` / ``load``,
``Layer.set_state_dict``, ``Optimizer.set_state_dict``, ``Model.save`` /
``load``) held against the JAX package's, which writes the same format.

* Round trips of nested state are exact; a bf16 tensor is written as a
  float32 array (lossless) and comes back exact in its parameter's dtype.
* A tiny BERT saved by ``Model.save`` in either package loads with
  ``Model.load`` in the other: the parameters equal the writer's exactly
  (f32 and bf16) and the ``eval_batch`` loss agrees at 1e-6 (relative:
  the two forwards sum in other orders); the ``.pdopt`` resumes AdamW with
  ``count`` and every slot equal, and one more step agrees with the
  writer's own next step (parameters at 1e-5; the key third of each
  ``qkv.bias``, whose gradient is zero in exact arithmetic and which Adam
  moves by rounding noise normalized to up to ``lr``, within ``lr`` — see
  tests/test_torch_training.py).
* The corrupt, missing, misnamed-foreign and headerless cases raise the
  same typed errors in both packages; a JAX ``ml_dtypes.bfloat16`` leaf
  where ``ml_dtypes`` cannot be imported raises naming the leaf.
Inputs are numpy arrays from a seed; dropout is 0.
"""
import collections
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import serialization as jser
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework import serialization as tser
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.models import bert as tbert

Pair = collections.namedtuple("Pair", "a b")
LR = 1e-3


def _bert_batch(seed):
    rng = np.random.RandomState(seed)
    B, S, P = 2, 16, 3
    ids = rng.randint(0, 128, size=(B, S)).astype(np.int32)
    tt = (rng.rand(B, S) < 0.5).astype(np.int32)
    am = np.ones((B, S), np.int32)
    mp = np.stack([np.sort(rng.choice(S, P, replace=False))
                   for _ in range(B)]).astype(np.int32)
    mlm = np.take_along_axis(ids, mp, axis=1)
    nsp = rng.randint(0, 2, size=(B, 1)).astype(np.int32)
    return [ids, tt, am, mp], [mlm, nsp]


def _jax_model(dtype="float32"):
    jpt.seed(5)
    net = jbert.BertForPretraining(jbert.bert_tiny())
    if dtype == "bfloat16":
        net = net.astype("bfloat16")
    opt = jopt.AdamW(LR, weight_decay=0.01, multi_precision=True)
    return jpt.Model(net, ["x"] * 4, ["y"] * 2).prepare(
        optimizer=opt, loss=net.loss), net


def _torch_model(dtype="float32", jnet=None):
    net = tbert.BertForPretraining(tbert.bert_tiny(), device="cpu",
                                   generator=torch.Generator().manual_seed(9))
    if dtype == "bfloat16":
        net = net.astype("bfloat16")
    if jnet is not None:
        load_jax_params(net, {k: np.asarray(p.value)
                              for k, p in jnet.named_parameters()})
    opt = tpt.optimizer.AdamW(LR, weight_decay=0.01, multi_precision=True)
    return tpt.Model(net, ["x"] * 4, ["y"] * 2).prepare(
        optimizer=opt, loss=net.loss), net


def _assert_next_step_close(got, want):
    for k, v in want.items():
        g = got[k]
        if k.endswith("attn.qkv.bias"):
            d = v.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], v[d:2 * d], rtol=0,
                                       atol=2 * LR, err_msg=k)
            g, v = np.delete(g, np.s_[d:2 * d]), np.delete(v, np.s_[d:2 * d])
        np.testing.assert_allclose(g, v, rtol=0, atol=1e-5, err_msg=k)


def _jparams(jnet):
    return {k: np.asarray(p.value).astype(np.float32)
            for k, p in jnet.named_parameters()}


def _tparams(tnet):
    return {k: p.detach().float().numpy()
            for k, p in tnet.named_parameters()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32])
def test_nested_round_trip_is_exact(tmp_path, dtype):
    gen = torch.Generator().manual_seed(0)
    t = (torch.randn(3, 5, generator=gen) * 100).to(dtype)
    obj = {"w": t, "nested": {"list": [t[0], 3, "s"], "tuple": (1.5, t[1])},
           "pair": Pair(t[2], None), "scalar": np.float32(2.5),
           "arr": np.arange(4, dtype=np.int64)}
    path = str(tmp_path / "sub" / "state.pdparams")
    tpt.save(obj, path)
    assert not os.path.exists(path + ".tmp")
    got = tpt.load(path)
    want_dtype = np.float32 if dtype == torch.bfloat16 else None
    w = got["w"]
    assert isinstance(w, np.ndarray)
    if want_dtype is not None:
        assert w.dtype == want_dtype  # bf16 written as float32, lossless
    torch.testing.assert_close(torch.from_numpy(w).to(dtype), t, rtol=0,
                               atol=0)
    assert got["nested"]["list"][1:] == [3, "s"]
    assert got["nested"]["tuple"][0] == 1.5
    np.testing.assert_array_equal(got["nested"]["tuple"][1],
                                  t[1].float().numpy().astype(w.dtype))
    assert isinstance(got["pair"], Pair) and got["pair"].b is None
    assert got["scalar"] == np.float32(2.5)
    np.testing.assert_array_equal(got["arr"], np.arange(4))
    # the JAX package reads the port's file, and the port reads JAX's
    np.testing.assert_array_equal(jser.load(path)["w"], w)
    jpath = str(tmp_path / "j.pdparams")
    jser.save({"w": w, "n": 3}, jpath)
    np.testing.assert_array_equal(tpt.load(jpath)["w"], w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_model_save_loads_in_the_port(tmp_path, dtype):
    jm, jnet = _jax_model(dtype)
    inputs, labels = _bert_batch(0)
    for i in range(2):
        jm.train_batch(*_bert_batch(i))
    path = str(tmp_path / "ckpt")
    jm.save(path)
    tm, tnet = _torch_model(dtype)
    tm.load(path)
    got, want = _tparams(tnet), _jparams(jnet)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert dict(tnet.named_parameters())[k].dtype == getattr(torch,
                                                                 dtype)
    if dtype == "float32":
        np.testing.assert_allclose(tm.eval_batch(inputs, labels)[0],
                                   jm.eval_batch(inputs, labels)[0],
                                   rtol=1e-6)
    # the .pdopt: count and every slot equal JAX's
    sd = tm._optimizer.state_dict()
    assert sd["count"] == int(jm._opt_state["count"]) == 2
    for pname, slots in jm._opt_state["slots"].items():
        for sname, v in slots.items():
            got = sd[f"{pname}.{sname}"]
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(v).astype(np.float32),
                err_msg=f"{pname}.{sname}")
    if dtype == "float32":  # one more step resumes as JAX's own
        nxt = _bert_batch(7)
        jm.train_batch(*nxt)
        tm.train_batch(*nxt)
        _assert_next_step_close(_tparams(tnet), _jparams(jnet))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_model_save_loads_in_jax(tmp_path, dtype):
    jm0, jnet0 = _jax_model(dtype)
    tm, tnet = _torch_model(dtype, jnet=jnet0)
    inputs, labels = _bert_batch(0)
    for i in range(2):
        tm.train_batch(*_bert_batch(i))
    path = str(tmp_path / "ckpt")
    tm.save(path)
    jm, jnet = _jax_model(dtype)
    jm.load(path)
    got, want = _jparams(jnet), _tparams(tnet)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert str(jnet.state_dict()[k].dtype) == dtype
    if dtype == "float32":
        np.testing.assert_allclose(jm.eval_batch(inputs, labels)[0],
                                   tm.eval_batch(inputs, labels)[0],
                                   rtol=1e-6)
    sd = tm._optimizer.state_dict()
    assert int(jm._opt_state["count"]) == sd["count"] == 2
    for pname, slots in jm._opt_state["slots"].items():
        for sname, v in slots.items():
            np.testing.assert_array_equal(
                np.asarray(v).astype(np.float32),
                sd[f"{pname}.{sname}"].float().numpy(),
                err_msg=f"{pname}.{sname}")
    if dtype == "float32":
        nxt = _bert_batch(7)
        jm.train_batch(*nxt)
        tm.train_batch(*nxt)
        _assert_next_step_close(_jparams(jnet), _tparams(tnet))


def test_lr_scheduler_state_rides_in_the_pdopt(tmp_path):
    net = tbert.BertForPretraining(tbert.bert_tiny(), device="cpu")
    sched = tpt.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    m = tpt.Model(net, ["x"] * 4, ["y"] * 2).prepare(
        optimizer=tpt.optimizer.AdamW(sched), loss=net.loss)
    m.train_batch(*_bert_batch(0))
    sched.step()
    sched.step()
    m.save(str(tmp_path / "c"))
    assert jser.load(str(tmp_path / "c.pdopt"))["LR_Scheduler"] == \
        sched.state_dict()
    net2 = tbert.BertForPretraining(tbert.bert_tiny(), device="cpu")
    sched2 = tpt.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    m2 = tpt.Model(net2, ["x"] * 4, ["y"] * 2).prepare(
        optimizer=tpt.optimizer.AdamW(sched2), loss=net2.loss)
    m2.load(str(tmp_path / "c"))
    assert sched2.last_epoch == sched.last_epoch == 2
    assert sched2.last_lr == sched.last_lr == 0.025


def test_set_state_dict_casts_reports_and_checks_shapes():
    net = tbert.BertForPretraining(tbert.bert_tiny(), device="cpu").astype(
        "bfloat16")
    sd = {k: v.float().numpy() + 1 for k, v in net.state_dict().items()}
    sd["not.a.param"] = np.zeros(3)
    missing = net.set_state_dict(sd)
    assert missing == ["not.a.param"]
    for k, v in net.state_dict().items():
        assert v.dtype == torch.bfloat16
        torch.testing.assert_close(v, torch.from_numpy(sd[k]).to(v.dtype),
                                   rtol=0, atol=0)
    # the JAX package reports the same names for the same dict
    jnet = jbert.BertForPretraining(jbert.bert_tiny())
    assert jnet.set_state_dict(sd) == missing
    bad = {"bert.pooler.weight": np.zeros((3, 3), np.float32)}
    with pytest.raises(InvalidArgumentError, match="shape mismatch"):
        net.set_state_dict(bad)
    assert net.load_dict == net.set_state_dict
    own = net.bert.pooler.state_dict(include_sublayers=False)
    assert list(own) == ["weight", "bias"]


def _errors(fn, path):
    try:
        fn(path)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__
    return None


@pytest.mark.parametrize("case", ["missing", "truncated", "foreign_name",
                                  "garbage_pdparams", "headerless_pdparams"])
def test_bad_files_raise_the_same_typed_errors(tmp_path, case):
    payload = pickle.dumps({"w": np.ones(3, np.float32)}, protocol=4)
    path = str(tmp_path / {"foreign_name": "x.bin",
                           "garbage_pdparams": "g.pdparams",
                           "headerless_pdparams": "h.pdparams"}.get(
                               case, "c.pdparams"))
    if case == "truncated":
        with open(path, "wb") as f:
            f.write(b"PTPU0001" + payload[:-5])
    elif case == "foreign_name":
        with open(path, "wb") as f:
            f.write(payload)
    elif case == "garbage_pdparams":
        with open(path, "wb") as f:
            f.write(b"not a pickle at all")
    elif case == "headerless_pdparams":
        with open(path, "wb") as f:
            f.write(payload)
    got, want = _errors(tser.load, path), _errors(jser.load, path)
    assert got == want, (got, want)
    assert got == {"missing": "NotFoundError", "headerless_pdparams": None
                   }.get(case, "InvalidArgumentError")
    if case == "headerless_pdparams":
        np.testing.assert_array_equal(tser.load(path)["w"], np.ones(3))


def test_jax_bf16_leaf_without_ml_dtypes_raises_naming_it(tmp_path,
                                                          monkeypatch):
    jm, jnet = _jax_model("bfloat16")
    path = str(tmp_path / "bf")
    jm.save(path)
    raw = jser.load(path + ".pdparams")
    assert raw["bert.pooler.weight"].dtype.name == "bfloat16"
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # not importable
    with pytest.raises(InvalidArgumentError,
                       match=r"leaf bert\.\S+ is a ml_dtypes\.bfloat16"):
        tser.load(path + ".pdparams")
    # float32 leaves still load with ml_dtypes missing
    tpt.save({"w": torch.ones(2, dtype=torch.bfloat16)},
             str(tmp_path / "f.pdparams"))
    assert tser.load(str(tmp_path / "f.pdparams"))["w"].dtype == np.float32


def test_optimizer_set_state_dict_takes_the_jax_flat_layout():
    """The eager JAX optimizer's ``state_dict`` (count, "<param>.<slot>",
    LR_Scheduler) restores the port's optimizer."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 3).astype(np.float32)
    g = rng.randn(4, 3).astype(np.float32)
    import jax.numpy as jnp

    from paddle_tpu.nn.layer_base import Parameter
    jw = Parameter(jnp.asarray(w0))
    jo = jopt.Adam(0.1, parameters=[jw])
    jo.step({"param_0": jnp.asarray(g)})
    jo.step({"param_0": jnp.asarray(g)})
    flat = {k: np.asarray(v) for k, v in jo.state_dict().items()}
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    to = tpt.optimizer.Adam(0.1, parameters=[tw])
    to.set_state_dict(flat)
    sd = to.state_dict()
    assert sd["count"] == 2
    for k in ("param_0.moment1", "param_0.moment2"):
        np.testing.assert_array_equal(sd[k].numpy(), flat[k])
    with pytest.raises(InvalidArgumentError, match="bound"):
        tpt.optimizer.Adam(0.1).set_state_dict(flat)
