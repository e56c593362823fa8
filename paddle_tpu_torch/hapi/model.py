"""paddle.Model — port of ``paddle_tpu.hapi.model`` (the batch-level API).

``Model(network, inputs=None, labels=None)``; ``prepare(optimizer, loss)``
binds an optimizer built without ``parameters=`` to the network's
dotted-name parameters; ``train_batch(inputs, labels)`` moves numpy
arrays (``ml_dtypes.bfloat16`` ones included) or tensors onto the
network's device and runs one step in train mode — forward, loss,
backward, optimizer step, grads dropped — and
returns ``(float(loss), [])``.  ``eval_batch`` and ``predict_batch`` run in
eval mode without gradients.  Where the JAX package compiles the step
into one XLA executable, the port runs it eagerly; the kernels on the
path are the hand-written ones of ``paddle_tpu_torch.ops``.

Not ported yet (ROADMAP queue A, training step): the ``fit`` /
``evaluate`` / ``predict`` loops and callbacks, metrics, ``amp_configs``,
``steps_per_execution``, fleet (distributed) optimizers, save/load;
``fit``, ``evaluate`` and those ``prepare`` arguments raise
``UnimplementedError``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError, UnimplementedError
from ..optimizer.optimizer import Optimizer

__all__ = ["Model"]

_QUEUE = "ROADMAP queue A, training step"


def _tuplize(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _as_tensor(b, device) -> torch.Tensor:
    """A batch entry on ``device``.  numpy ``ml_dtypes.bfloat16`` arrays
    (what the JAX package's ``train_batch`` takes, ``bench.py`` feeds bf16
    images) are recognized by dtype name and reinterpreted bit for bit as
    ``torch.bfloat16``, without importing ``ml_dtypes``."""
    if isinstance(b, np.ndarray) and b.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(b).view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(b, device=device)


def _unported(what: str):
    raise UnimplementedError(f"Model: {what} is not ported yet ({_QUEUE})")


class Model:
    """Wrap a network with train/eval/predict conveniences.

    ``inputs`` / ``labels`` may be specs (lists); only their count matters
    here: it says how a batch splits into network inputs and loss
    labels.
    """

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._n_inputs = (len(_tuplize(inputs)) if inputs is not None
                          else None)
        self._n_labels = (len(_tuplize(labels)) if labels is not None
                          else 1)
        self._optimizer: Optional[Optimizer] = None
        self._loss = None
        self._prepared = False

    def prepare(self, optimizer: Optional[Optimizer] = None, loss=None,
                metrics=None, amp_configs=None, steps_per_execution: int = 1):
        if loss is not None and not callable(loss):
            raise InvalidArgumentError("loss must be a Layer or callable")
        if metrics:
            _unported("metrics")
        if amp_configs:
            _unported("amp_configs")
        if int(steps_per_execution) != 1:
            _unported("steps_per_execution > 1")
        if getattr(optimizer, "_fleet_strategy", None) is not None:
            _unported("a fleet distributed optimizer")
        if optimizer is not None and optimizer._params is None:
            optimizer._bind(self.network.named_parameters())
        self._optimizer = optimizer
        self._loss = loss
        self._prepared = True
        return self

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _batch(self, inputs, labels):
        dev = self.device
        batch = _tuplize(inputs) + (_tuplize(labels) if labels is not None
                                    else ())
        return tuple(_as_tensor(b, dev) for b in batch)

    def _split_batch(self, batch):
        n_in = self._n_inputs
        if n_in is None:
            n_in = max(len(batch) - self._n_labels, 1)
        return batch[:n_in], batch[n_in:]

    def _forward_loss(self, batch):
        inputs, labels = self._split_batch(batch)
        out = self.network(*inputs)
        loss = None
        if self._loss is not None:
            loss = self._loss(*(_tuplize(out) + tuple(labels)))
        return loss, out

    # -- batch-level API -----------------------------------------------------
    def train_batch(self, inputs, labels=None):
        """One optimization step; returns ``(loss, metrics_results)``."""
        if not self._prepared or self._optimizer is None \
                or self._loss is None:
            raise InvalidArgumentError(
                "call prepare(optimizer=..., loss=...) first")
        batch = self._batch(inputs, labels)
        self.network.train()
        loss, _ = self._forward_loss(batch)
        loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        return float(loss.detach()), []

    def eval_batch(self, inputs, labels=None):
        if not self._prepared or self._loss is None:
            raise InvalidArgumentError("call prepare(loss=...) first")
        batch = self._batch(inputs, labels)
        self.network.eval()
        with torch.no_grad():
            loss, _ = self._forward_loss(batch)
        return float(loss), []

    def predict_batch(self, inputs):
        batch = self._batch(inputs, None)
        self.network.eval()
        with torch.no_grad():
            return self.network(*batch)

    # -- not ported yet ------------------------------------------------------
    def fit(self, *args, **kwargs):
        _unported("fit() (loops, callbacks, data loaders)")

    def evaluate(self, *args, **kwargs):
        _unported("evaluate()")
