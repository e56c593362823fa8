"""The port's training loop (``Model.fit`` / ``evaluate`` / ``predict``,
``hapi.callbacks``) held against the JAX package's.

A tiny ``BertForSequenceClassification`` (float32, dropout 0) from one
bridged initialization, ``Accuracy`` and ``CrossEntropyLoss``, AdamW,
``shuffle=False``: two epochs of ``fit`` with evaluation after each must
give the same per-epoch logs (loss, acc) at 1e-5 and the same final
parameters at 1e-4 (the key third of each ``qkv.bias`` — no gradient in
exact arithmetic, moved by Adam's normalized rounding noise — within the
``lr`` a step bound, as in tests/test_torch_training.py).  Beside that:
``evaluate`` and ``predict`` (per batch and stacked), ``ModelCheckpoint``'s
files per epoch and at the end, ``EarlyStopping`` stopping at the same
epoch (and its ``best_model``), the ``LRScheduler`` callback stepping the
scheduler as JAX's does (by step and by epoch), ``summary``; and in the
port alone: the loop hands callbacks the loss as a 0-d tensor (no wait
for the card), ``amp_configs`` keeps the autocast keys only, and resume is
exact — two epochs, or one epoch, ``save``, ``load`` into fresh objects
and one more, give bit-equal parameters.  ``chip_smoke.py``'s phase F3
(card against CPU under O1) runs here at a tiny size, both sides on the
CPU.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
import paddle_tpu_torch as tpt
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.metric as tmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.models import bert as tbert

LR = 1e-3
N, S, BS = 20, 12, 8  # 3 batches an epoch, the last one short


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, size=(n, S)).astype(np.int64)
    tt = (rng.rand(n, S) < 0.5).astype(np.int64)
    am = np.ones((n, S), np.int64)
    am[::3, 9:] = 0
    label = rng.randint(0, 3, size=(n, 1)).astype(np.int64)
    return [ids, tt, am, label]


def _pair(seed=2):
    jpt.seed(seed)
    jnet = jbert.BertForSequenceClassification(jbert.bert_tiny(),
                                               num_classes=3)
    tnet = tbert.BertForSequenceClassification(tbert.bert_tiny(),
                                               num_classes=3, device="cpu")
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    return jnet, tnet


def _models(jsched=None, tsched=None, topk=(1, 2)):
    jnet, tnet = _pair()
    names = (["ids", "tt", "am"], ["label"])
    jm = jpt.Model(jnet, *names).prepare(
        jopt.AdamW(jsched or LR, weight_decay=0.01), jnn.CrossEntropyLoss(),
        metrics=[jmetric.Accuracy(topk=topk)])
    tm = tpt.Model(tnet, *names).prepare(
        tpt.optimizer.AdamW(tsched or LR, weight_decay=0.01),
        tpt.nn.CrossEntropyLoss(), metrics=[tmetric.Accuracy(topk=topk)])
    return jm, tm, jnet, tnet


class _Record:
    """Per-epoch and per-eval logs, as floats."""

    def __init__(self):
        self.epochs, self.evals, self.batch_losses = [], [], []

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_epoch_end(self, epoch, logs=None):
        self.epochs.append(_plain(logs))

    def on_eval_end(self, logs=None):
        self.evals.append(_plain(logs))

    def on_train_batch_end(self, step, logs=None):
        self.batch_losses.append(logs["loss"])

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)


def _plain(logs):
    out = {}
    for k, v in (logs or {}).items():
        if isinstance(v, (list, tuple)):
            out[k] = [float(x) for x in v]
        else:
            out[k] = float(v)
    return out


def _assert_logs_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def _assert_params_close(tnet, jnet, steps):
    want = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    for k, p in tnet.named_parameters():
        got, w = p.detach().numpy(), want[k]
        if k.endswith("attn.qkv.bias"):
            d = w.shape[0] // 3
            np.testing.assert_allclose(got[d:2 * d], w[d:2 * d], rtol=0,
                                       atol=2 * steps * LR, err_msg=k)
            got, w = np.delete(got, np.s_[d:2 * d]), np.delete(
                w, np.s_[d:2 * d])
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-4, err_msg=k)


def test_fit_evaluate_predict_match_jax(tmp_path):
    jm, tm, jnet, tnet = _models()
    jrec, trec = _Record(), _Record()
    train, evald = _data(0), _data(1, n=10)
    jm.fit(jio.TensorDataset(train), jio.TensorDataset(evald),
           batch_size=BS, epochs=2, shuffle=False, verbose=0,
           callbacks=[jrec], save_dir=str(tmp_path / "j"))
    tm.fit(tio.TensorDataset(train), tio.TensorDataset(evald),
           batch_size=BS, epochs=2, shuffle=False, verbose=0,
           callbacks=[trec], save_dir=str(tmp_path / "t"))
    _assert_logs_close(trec.epochs, jrec.epochs)
    _assert_logs_close(trec.evals, jrec.evals)
    assert list(trec.epochs[0]) == ["loss", "acc_top1", "acc_top2",
                                    "batch_size"]
    # the loop hands callbacks device scalars: no wait for the card
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in trec.batch_losses)
    assert len(trec.batch_losses) == 6
    _assert_params_close(tnet, jnet, steps=6)
    # ModelCheckpoint: one checkpoint an epoch and the final one
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j")) == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams", "final.pdopt",
        "final.pdparams"]
    # evaluate alone, and predict (per batch and stacked)
    want = jm.evaluate(jio.TensorDataset(evald), batch_size=4, verbose=0)
    got = tm.evaluate(tio.TensorDataset(evald), batch_size=4, verbose=0)
    _assert_logs_close([_plain(got)], [_plain(want)])
    assert isinstance(got["loss"], float)
    jp = jm.predict(jio.TensorDataset(evald[:3]), batch_size=4)
    tp = tm.predict(tio.TensorDataset(evald[:3]), batch_size=4)
    assert len(tp) == len(jp) == 3
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    stacked = tm.predict(tio.TensorDataset(evald[:3]), batch_size=4,
                         stack_outputs=True)
    assert stacked.shape == (10, 3) and stacked.dtype == np.float32
    # a DataLoader is taken as it is
    loader = tio.DataLoader(tio.TensorDataset(evald), batch_size=4,
                            places="cpu")
    assert tm.evaluate(loader, verbose=0)["loss"] == pytest.approx(
        got["loss"], rel=1e-6)


@pytest.mark.parametrize("by", ["step", "epoch"])
def test_lr_scheduler_callback_steps_as_jax(by):
    jsched = jopt.lr.StepDecay(LR, step_size=2, gamma=0.5)
    tsched = tpt.optimizer.lr.StepDecay(LR, step_size=2, gamma=0.5)
    jm, tm, jnet, tnet = _models(jsched, tsched)
    train = _data(0)
    kw = dict(by_step=by == "step", by_epoch=by == "epoch")
    jm.fit(jio.TensorDataset(train), batch_size=BS, epochs=2, shuffle=False,
           verbose=0, callbacks=[jcb.LRScheduler(**kw)])
    tm.fit(tio.TensorDataset(train), batch_size=BS, epochs=2, shuffle=False,
           verbose=0, callbacks=[tcb.LRScheduler(**kw)])
    assert tsched.last_epoch == jsched.last_epoch == (6 if by == "step"
                                                      else 2)
    assert tsched.last_lr == pytest.approx(jsched.last_lr, rel=1e-12)
    _assert_params_close(tnet, jnet, steps=6)


def test_early_stopping_stops_at_the_same_epoch(tmp_path):
    counts = {}
    for name, pkg, io, cb in (("jax", jpt, jio, jcb), ("port", tpt, tio,
                                                       tcb)):
        jm, tm, _, _ = _models()
        m = jm if name == "jax" else tm
        rec = _Record()
        # min_delta far above any change: the first eval improves on inf,
        # the second cannot, and patience 1 stops there
        es = cb.EarlyStopping(monitor="loss", patience=1, min_delta=10.0,
                              verbose=0)
        d = str(tmp_path / name)
        m.fit(io.TensorDataset(_data(0)), io.TensorDataset(_data(1, 10)),
              batch_size=BS, epochs=5, shuffle=False, verbose=0,
              callbacks=[es, rec], save_dir=d)
        counts[name] = (len(rec.epochs), m.stop_training,
                        sorted(os.listdir(d)))
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] == 2 and counts["port"][1]
    assert "best_model.pdparams" in counts["port"][2]


def test_resume_is_exact_in_the_port(tmp_path):
    def fresh():
        _, tm, _, tnet = _models()
        return tm, tnet

    train = tio.TensorDataset(_data(0))
    a, anet = fresh()
    a.fit(train, batch_size=BS, epochs=2, shuffle=False, verbose=0)
    b, bnet = fresh()
    b.fit(train, batch_size=BS, epochs=1, shuffle=False, verbose=0)
    b.save(str(tmp_path / "mid"))
    c, cnet = fresh()
    c.load(str(tmp_path / "mid"))
    assert c._optimizer.state_dict()["count"] == 3
    c.fit(train, batch_size=BS, epochs=1, shuffle=False, verbose=0)
    for (k, p), q in zip(anet.named_parameters(), cnet.parameters()):
        assert torch.equal(p, q), k


def test_prepare_keeps_autocast_keys_and_fit_runs_under_o1():
    _, tnet = _pair()
    m = tpt.Model(tnet, ["ids", "tt", "am"], ["label"])
    m.prepare(tpt.optimizer.AdamW(LR), tpt.nn.CrossEntropyLoss(),
              amp_configs={"level": "O1", "init_loss_scaling": 1024.0,
                           "custom_black_list": ["Tanh"]})
    assert m._amp == {"level": "O1", "custom_black_list": ["Tanh"]}
    seen = set()
    hook = tnet.bert.pooler.register_forward_hook(
        lambda mod, args, out: seen.add(out.dtype))
    rec = _Record()
    m.fit(tio.TensorDataset(_data(0)), batch_size=BS, epochs=1,
          shuffle=False, verbose=0, callbacks=[rec])
    hook.remove()
    assert seen == {torch.bfloat16}
    assert all(np.isfinite(float(v)) for v in rec.batch_losses)
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    m.prepare(tpt.optimizer.AdamW(LR), tpt.nn.CrossEntropyLoss(),
              amp_configs="O0")
    assert m._amp == {}


def test_progbar_logger_prints_and_summary_matches_jax(capsys):
    jm, tm, _, _ = _models()
    tm.fit(tio.TensorDataset(_data(0)), batch_size=BS, epochs=1,
           shuffle=False, verbose=2, log_freq=1)
    out = capsys.readouterr().out
    assert "Epoch 0: step 0/3 - loss:" in out and "Epoch 0 done" in out
    assert tm.summary() == jm.summary()
    assert len(tm.parameters()) == len(list(tm.network.parameters()))
    with pytest.raises(Exception, match="one-shot"):
        tm.fit(iter([]), epochs=2, verbose=0)


def test_chip_smoke_fit_parity_phase_runs_on_cpu(monkeypatch):
    """chip_smoke.py's phase F3 (the card against the CPU under amp O1:
    the first batch's gradient, then two ``fit`` steps) at a tiny BERT
    with both sides on the CPU: it finds kernel 2's 4 x layers LayerNorm
    parameters, and the two sides agree exactly."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = tbert.BertConfig(vocab_size=512, hidden_size=64, num_layers=2,
                           num_heads=2, intermediate_size=128,
                           max_position=128, dropout=0.0)
    losses, rel = chip_smoke.fit_card_vs_cpu(torch, cfg)
    assert rel == {"all": 0.0, "kernel 2": 0.0}
    assert len(losses["cpu"]) == 2
    assert all(np.isfinite(v) for v in losses["cpu"])
