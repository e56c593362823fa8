"""hapi callbacks — port of ``paddle_tpu.hapi.callbacks``: ``Callback``,
``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler``,
``EarlyStopping`` and ``config_callbacks``, with the JAX package's hooks
and defaults.

``Model.fit`` hands the callbacks the loss as a 0-d device tensor; a
callback that reads it (``ProgBarLogger`` every ``log_freq`` steps,
``EarlyStopping`` at the end of an evaluation) pulls it to the host, and
only then does the loop wait for the card.
"""
from __future__ import annotations

import numbers
import os
import time
from typing import List, Optional

import numpy as np
import torch

__all__ = [
    "Callback",
    "CallbackList",
    "ProgBarLogger",
    "ModelCheckpoint",
    "LRScheduler",
    "EarlyStopping",
    "config_callbacks",
]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # train
    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    # eval
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    # predict
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Periodic stdout logging (the reference renders a progress bar; here a
    compact line every ``log_freq`` steps — terminal-friendly under drivers)."""

    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()
        self._window_t0 = time.time()
        self._window_steps = 0
        self._window_samples = 0

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            # device scalars (0-d tensors) sync here — only when printed
            if isinstance(v, (numbers.Number, np.generic)) or getattr(v, "ndim", None) == 0:
                parts.append(f"{k}: {float(v):.4f}")
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], numbers.Number):
                parts.append(f"{k}: " + "/".join(f"{float(x):.4f}" for x in v))
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        # per-step timing, so perf work is not blind
        self._window_steps += 1
        bs = (logs or {}).get("batch_size")
        if isinstance(bs, numbers.Number):
            self._window_samples += int(bs)
        if self.verbose and step % self.log_freq == 0:
            # sync on the window's last loss BEFORE reading the clock:
            # steps are queued ahead, so without it dt would measure the
            # host's dispatch instead of the card's time
            v = (logs or {}).get("loss")
            if isinstance(v, torch.Tensor):
                v.item()
            dt = time.time() - self._window_t0
            perf = ""
            if self._window_steps and dt > 0:
                perf = f" - {dt * 1e3 / self._window_steps:.1f} ms/step"
                if self._window_samples:
                    perf += f" - {self._window_samples / dt:.1f} samples/s"
            print(f"Epoch {self.epoch}: step {step}/{self.steps or '?'} - "
                  f"{self._fmt(logs)}{perf}")
            self._window_t0 = time.time()
            self._window_steps = 0
            self._window_samples = 0

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            print(f"Epoch {epoch} done in {dt:.1f}s - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir and self.model:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (by_step and/or by_epoch)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        assert by_step != by_epoch, "step either per batch or per epoch"
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline if self.baseline is not None else (
            -np.inf if self.mode == "max" else np.inf
        )
        self.model.stop_training = False

    def _better(self, cur):
        if self.mode == "max":
            return cur > self.best + self.min_delta
        return cur < self.best - self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        cur = float(cur)
        if self._better(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and getattr(self.model, "_save_dir", None):
                self.model.save(os.path.join(self.model._save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"EarlyStopping: no {self.monitor} improvement for {self.wait} evals")


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=10, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "epochs": epochs, "steps": steps, "verbose": verbose,
        "metrics": metrics or [],
    })
    return lst
