"""paddle.Model — port of ``paddle_tpu.hapi.model``: the high-level
train / evaluate / predict API.

``Model(network, inputs=None, labels=None)``; ``prepare(optimizer, loss,
metrics=, amp_configs=)`` binds an optimizer built without
``parameters=`` to the network's dotted-name parameters.  Batch level:
``train_batch`` runs one step in train mode (forward, loss, backward,
optimizer step, grads dropped) and returns ``(float(loss), metrics)``;
``eval_batch`` / ``predict_batch`` run in eval mode without gradients.
Inputs may be numpy arrays (``ml_dtypes.bfloat16`` ones included) or
tensors; they are moved to the network's device.  Loops, as the JAX
package's: ``fit`` (epochs over a ``Dataset`` or ``DataLoader``, with
callbacks, metrics and periodic evaluation), ``evaluate`` and
``predict``; ``save`` / ``load`` write and read ``<path>.pdparams`` and
``<path>.pdopt`` in the JAX package's format, so a checkpoint resumes in
either package.

Where the JAX package compiles a step into one XLA executable, the port
runs it eagerly; the kernels on the path are the hand-written ones of
``paddle_tpu_torch.ops``.  ``fit`` and ``evaluate`` keep each loss a 0-d
device tensor: the loop does not wait for the card until a callback reads
a loss (``ProgBarLogger`` every ``log_freq`` steps) or a metric updates
(metrics are host numpy, as in the JAX package).  ``amp_configs`` (a
level string such as ``"O1"``, or a dict of ``auto_cast`` arguments;
GradScaler keys are dropped, as in the JAX package) runs the forward and
the loss under :func:`paddle_tpu_torch.amp.auto_cast`.  A network with
sparse tables (``Embedding(sparse=True)``) trains through the JAX
package's sparse step (``framework.selected_rows.build_sparse_step``):
the tables get SelectedRows gradients from their lookups only, which the
optimizer's rule updates row by row (``Adam(lazy_mode=True)`` …).

``prepare(steps_per_execution=k)`` runs k train steps per execution, as
the JAX package's ``lax.scan`` of k steps does, with its rules: no
metrics, the learning rate read once per execution (an ``LRScheduler``
warns), per-step losses returned as one ``[k]`` tensor, ``fit`` grouping
full groups of equal batches and running ragged tails as single steps.
On a CUDA device an execution after the first is one CUDA graph replay
(``hapi/_graph_step.py``); on the CPU the k steps run eagerly in a loop
with the same semantics.  ``train_batch`` stays one step.

With an optimizer from ``fleet.distributed_optimizer``, ``prepare``
builds the strategy's ``distributed.fleet.ShardingPlan`` (``recompute``
and ``sequence_parallel`` applied to the network first), as the JAX
``prepare`` does: every rank runs the same program on the same global
batch; the plan keeps this rank's rows, averages the gradients over the
data axes, steps the optimizer (ZeRO-1 over ``sharding``) and the
returned loss is the global mean.  Metrics, ``eval_batch`` and
``predict_batch`` see every rank's rows; ``fit`` / ``evaluate`` drop a
final batch that cannot split over the data shards (warning), ``predict``
pads it and slices the padding off.  A plan does not compose with
``steps_per_execution > 1`` (JAX's error).

Not ported yet, each raising ``UnimplementedError``:
``save(training=False)``, the inference export (queue A, static graph and
the long tail), and ``save`` / ``load`` of a plan whose parameters or
optimizer slots are sharded (queue A, distributed execution).
"""
from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..amp.auto_cast import auto_cast
from ..framework import serialization
from ..framework.dtype import numpy_to_tensor
from ..framework.errors import InvalidArgumentError, UnimplementedError
from ..framework.selected_rows import build_sparse_step, sparse_param_names
from ..metric import Metric
from ..optimizer.optimizer import Optimizer
from . import callbacks as _callbacks_mod
from ._graph_step import GraphSteps

__all__ = ["Model"]

#: the auto_cast arguments ``amp_configs`` may carry (the rest — a
#: GradScaler's — are dropped, as in the JAX package)
_AMP_KEYS = {"enable", "custom_white_list", "custom_black_list", "level",
             "dtype"}


def _tuplize(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _state_tree(tree):
    """An optimizer state as the JAX package pickles it: the step counts
    as int32 scalars."""
    if isinstance(tree, dict):
        return {k: _state_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.int32) if isinstance(tree, int) else tree


def _grouped(loader, spe: int):
    """``steps_per_execution`` batching, as the JAX ``fit``'s: yield
    ``("multi", [k batches])`` for full groups of equal batch size and
    ``("single", batch)`` for the rest — a short group at the end of an
    epoch and the batches around a smaller one, flushed in step order
    (everything when ``spe == 1``)."""
    pending: list = []
    group_bs = None
    for b in loader:
        if spe == 1:
            yield "single", b
            continue
        b = _tuplize(b)
        bs = int(np.shape(b[0])[0])
        if pending and bs != group_bs:
            for p in pending:
                yield "single", p
            pending = []
        if not pending:
            group_bs = bs
        pending.append(b)
        if len(pending) == spe:
            yield "multi", pending
            pending = []
    for b in pending:
        yield "single", b


def _pad_rows(b, pad: int):
    """``b`` with its last row repeated ``pad`` more times."""
    if isinstance(b, torch.Tensor):
        return torch.cat([b, b[-1:].expand(pad, *b.shape[1:])])
    b = np.asarray(b)
    return np.concatenate([b, np.repeat(b[-1:], pad, axis=0)])


def _unported(what: str, item: str):
    raise UnimplementedError(
        f"Model: {what} is not ported yet (ROADMAP queue A, {item})")


class Model:
    """Wrap a network with train / eval / predict conveniences.

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
        self._metrics: List[Metric] = []
        self._amp: Dict[str, Any] = {}
        self._sparse: Dict[int, str] = {}
        self._steps_per_execution = 1
        self._graph_steps: Optional[GraphSteps] = None
        self._plan = None
        self._prepared = False
        self.stop_training = False
        self._save_dir = None

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer: Optional[Optimizer] = None, loss=None,
                metrics: Optional[Sequence[Metric]] = None, amp_configs=None,
                steps_per_execution: int = 1):
        if loss is not None and not callable(loss):
            raise InvalidArgumentError("loss must be a Layer or callable")
        steps_per_execution = int(steps_per_execution)
        if steps_per_execution < 1:
            raise InvalidArgumentError("steps_per_execution must be >= 1")
        if steps_per_execution > 1 and metrics:
            raise InvalidArgumentError(
                "steps_per_execution > 1 cannot update host-side metrics "
                "per inner step; drop metrics or keep it at 1")
        if steps_per_execution > 1 and optimizer is not None and \
                optimizer.lr_scheduler is not None:
            warnings.warn(
                "steps_per_execution > 1: the learning rate is read once per "
                "execution, so an LRScheduler advances per execution (every "
                f"{steps_per_execution} optimizer steps), not per step — "
                "matching Keras. Scale the scheduler's step granularity "
                "accordingly.", UserWarning)
        strategy = getattr(optimizer, "_fleet_strategy", None)
        if strategy is not None and steps_per_execution > 1:
            raise InvalidArgumentError(
                "steps_per_execution > 1 does not yet compose with "
                "fleet strategies (the plan wraps the single-step "
                "executable); run with the default strategy")
        self._steps_per_execution = steps_per_execution
        self._graph_steps = None
        if steps_per_execution > 1:
            self._graph_steps = GraphSteps(
                steps_per_execution,
                lambda batch, plan: (self._train_step(batch, plan)[0],),
                self.device,
                before_capture=lambda: self._optimizer.clear_grad())
        self._metrics = list(metrics or [])
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise InvalidArgumentError(f"metric {m!r} is not a Metric")
        if isinstance(amp_configs, str):  # amp_configs="O1"
            amp_configs = {"level": amp_configs}
        amp = {k: v for k, v in dict(amp_configs or {}).items()
               if k in _AMP_KEYS}
        self._amp = amp if amp and amp.get("level", "O1") != "O0" else {}
        self._plan = None
        if strategy is not None:
            self._plan = self._fleet_plan(optimizer, strategy)
        elif optimizer is not None and optimizer._params is None:
            optimizer._bind(self.network.named_parameters())
        self._sparse = sparse_param_names(self.network)
        if self._sparse and self._plan is not None \
                and self._plan.n_data_shards > 1:
            _unported("sparse tables under data parallelism (the "
                      "cross-replica SelectedRows reduction, "
                      "all_gather_rows)", "distributed execution")
        self._optimizer = optimizer
        self._loss = loss
        self._prepared = True
        return self

    def _fleet_plan(self, optimizer, strategy):
        """The fleet path of ``prepare`` (the JAX ``prepare``'s): apply
        ``recompute`` and ``sequence_parallel`` to the network, build the
        ShardingPlan, place the network and bind the optimizer."""
        from ..distributed.fleet.plan import ShardingPlan

        net = self.network
        if strategy.recompute:
            from ..nn.recompute import apply_recompute

            rc_cfg = strategy.recompute_configs or {}
            if apply_recompute(net, rc_cfg.get("layer_classes"),
                               rc_cfg.get("policy")) == 0:
                warnings.warn(
                    "strategy.recompute matched no block sublayers — "
                    "pass recompute_configs={'layer_classes': [...]}",
                    RuntimeWarning)
        if strategy.sequence_parallel:
            # route attention through ring/Ulysses over the sep axis
            method = (strategy.sequence_parallel_configs or {}).get(
                "method", "ring")
            hits = 0
            for sub in net.modules():
                if hasattr(sub, "sequence_parallel") and hasattr(sub, "qkv"):
                    sub.sequence_parallel = method
                    hits += 1
            if hits == 0:
                warnings.warn(
                    "strategy.sequence_parallel found no attention "
                    "layers exposing a `sequence_parallel` knob",
                    RuntimeWarning)
        plan = ShardingPlan(net, optimizer, strategy)
        plan.place_network()
        plan.bind_optimizer()
        return plan

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _amp_ctx(self):
        return auto_cast(**self._amp) if self._amp \
            else contextlib.nullcontext()

    def _batch(self, inputs, labels):
        dev = self.device
        batch = _tuplize(inputs) + (_tuplize(labels) if labels is not None
                                    else ())
        if self._plan is not None:  # this rank's rows of the global batch
            batch = self._plan.shard_batch(tuple(
                b if hasattr(b, "shape") else np.asarray(b) for b in batch))
        return tuple(numpy_to_tensor(b, dev) if isinstance(
            b, (np.ndarray, np.generic, torch.Tensor))
            else torch.as_tensor(b, device=dev) for b in batch)

    def _split_batch(self, batch):
        n_in = self._n_inputs
        if n_in is None:
            n_in = max(len(batch) - self._n_labels, 1)
        return batch[:n_in], batch[n_in:]

    def _forward_loss(self, batch):
        inputs, labels = self._split_batch(batch)
        with self._amp_ctx():  # loss layers are black-listed: float32
            out = self.network(*inputs)
            loss = None
            if self._loss is not None:
                loss = self._loss(*(_tuplize(out) + tuple(labels)))
        return loss, out, labels

    def _update_metrics(self, out, labels):
        results = []
        if self._metrics and self._plan is not None:
            # metrics see the global batch, as the JAX step's outputs are
            out, labels = (self._plan.gather_batch(out),
                           self._plan.gather_batch(tuple(labels)))
        outs = _tuplize(out)
        for m in self._metrics:
            computed = m.compute(outs[0], *labels)
            results.append(m.update(*computed) if isinstance(computed, tuple)
                           else m.update(computed))
        return results

    # -- batch-level API -----------------------------------------------------
    def train_batch(self, inputs, labels=None):
        """One optimization step; returns ``(loss, metrics_results)``."""
        loss, metrics = self._train_batch_device(inputs, labels)
        return float(loss), metrics

    def _check_trainable(self):
        if not self._prepared or self._optimizer is None \
                or self._loss is None:
            raise InvalidArgumentError(
                "call prepare(optimizer=..., loss=...) first")

    def _train_batch_device(self, inputs, labels=None):
        """``train_batch`` with the loss left a 0-d device tensor: no wait
        for the card (but where a metric updates)."""
        self._check_trainable()
        loss, out, labels = self._train_step(self._batch(inputs, labels))
        return loss, self._update_metrics(out, labels)

    def _train_step(self, batch, plan=None):
        """One step on ``batch`` (device tensors); ``plan``: the
        optimizer step's host half, taken beforehand (a k-step
        execution's).  Returns the detached loss, the outputs and the
        labels."""
        self.network.train()
        if self._plan is not None:
            loss, out, labels = self._forward_loss(batch)
            loss.backward()
            self._plan.sync_gradients()
            self._plan.step(plan)
            for p in self.network.parameters():
                p.grad = None
            return self._plan.mean_loss(loss.detach()), out, labels
        if self._sparse:
            loss, out, labels = self._sparse_step(batch, plan)
        else:
            loss, out, labels = self._forward_loss(batch)
            loss.backward()
            self._step_optimizer(None, plan)
        self._optimizer.clear_grad()
        return loss.detach(), out, labels

    def _step_optimizer(self, grads, plan):
        """``optimizer.step(grads)``, with the step's host half where one
        was taken beforehand (a plain call otherwise, so a wrapped
        ``step`` keeps working for ``train_batch``)."""
        args = () if grads is None else (grads,)
        if plan is None:
            self._optimizer.step(*args)
        else:
            self._optimizer.step(*args, _plan=plan)

    def _sparse_step(self, batch, plan=None):
        """The step of a network with sparse tables: gradients from
        ``build_sparse_step`` (SelectedRows for the tables), handed to the
        optimizer by the names it is bound to."""
        opt = self._optimizer
        bound = opt._bound()
        params = dict(self.network.named_parameters())
        shapes = {n: tuple(params[n].shape) for n in self._sparse.values()
                  if params[n].requires_grad}

        def forward_loss(_params):
            loss, out, labels = self._forward_loss(batch)
            return loss, (out, labels)

        (loss, (out, labels)), grads = build_sparse_step(
            forward_loss, self._sparse, shapes)(params)
        by_id = {id(params[n]): g for n, g in grads.items()}
        self._step_optimizer({n: by_id.get(id(p)) for n, p in bound.items()},
                             plan)
        return loss, out, labels

    def _train_batches_device(self, batches):
        """Run ``len(batches) == steps_per_execution`` train steps in one
        execution (each batch a tuple of inputs and labels); returns the
        per-step losses as one ``[k]`` device tensor.  The learning rate
        is read once.  On a CUDA device the execution is a CUDA graph
        replay after the first; on the CPU the steps run eagerly."""
        self._check_trainable()
        if self._graph_steps is None:
            raise InvalidArgumentError(
                "call prepare(optimizer=..., loss=..., "
                "steps_per_execution=k) with k > 1 first")
        # checked before the plans advance the optimizer's step count
        if len(batches) != self._steps_per_execution:
            raise InvalidArgumentError(
                f"an execution takes {self._steps_per_execution} batches, "
                f"got {len(batches)}")
        batches = [self._batch(*self._split(b)) for b in batches]
        opt = self._optimizer
        lr, state = opt.get_lr(), opt._ensure_state()
        plans = [opt._plan(state, lr) for _ in batches]
        return self._graph_steps.run(list(zip(*batches)), plans)[0]

    def eval_batch(self, inputs, labels=None):
        loss, metrics = self._eval_batch_device(inputs, labels)
        return float(loss), metrics

    def _eval_batch_device(self, inputs, labels=None):
        if not self._prepared or self._loss is None:
            raise InvalidArgumentError("call prepare(loss=...) first")
        batch = self._batch(inputs, labels)
        self.network.eval()
        with torch.no_grad():
            loss, out, labels = self._forward_loss(batch)
        if self._plan is not None:
            loss = self._plan.mean_loss(loss)
        return loss, self._update_metrics(out, labels)

    def predict_batch(self, inputs):
        """The network's outputs in eval mode, without gradients (and, as
        in the JAX package, without the amp policy)."""
        batch = self._batch(inputs, None)
        self.network.eval()
        with torch.no_grad():
            out = self.network(*batch)
        if self._plan is not None:  # every rank's rows, in batch order
            out = self._plan.gather_batch(out)
        return out

    # -- loops ---------------------------------------------------------------
    def _as_loader(self, data, batch_size, shuffle, drop_last, num_workers,
                   allow_partial=False):
        """A Dataset becomes a DataLoader that stages batches onto the
        network's device; a DataLoader or any iterable of batches is used
        as it is.  Under a plan a final batch that cannot split over the
        data shards is dropped (with a warning) unless ``allow_partial``."""
        from ..io import DataLoader, Dataset

        if isinstance(data, Dataset):
            if self._plan is not None and not allow_partial \
                    and not drop_last:
                if len(data) % batch_size:
                    warnings.warn(
                        f"dropping the final partial batch "
                        f"({len(data) % batch_size} samples) — it cannot "
                        f"split across {self._plan.n_data_shards} data "
                        f"shards", RuntimeWarning)
                drop_last = True
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers,
                              places=self.device)
        return data

    def _split(self, batch, with_labels=True):
        batch = _tuplize(batch)
        n_in = (self._n_inputs if self._n_inputs is not None
                else max(len(batch) - self._n_labels, 1) if with_labels
                else len(batch))
        return batch[:n_in], batch[n_in:]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None):
        """Train over ``train_data`` for ``epochs``, evaluating on
        ``eval_data`` every ``eval_freq`` epochs; callbacks as the JAX
        package's (``config_callbacks`` adds ``ProgBarLogger`` when
        ``verbose``, ``ModelCheckpoint`` and ``LRScheduler``)."""
        train_loader = self._as_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        eval_loader = self._as_loader(eval_data, batch_size, False, False,
                                      num_workers)
        if epochs > 1 and hasattr(train_loader, "__next__"):
            raise InvalidArgumentError(
                "train_data is a one-shot iterator but epochs > 1: epochs "
                "after the first would train on zero batches.  Pass a "
                "Dataset/DataLoader (re-iterable) or epochs=1.")
        self._save_dir = save_dir
        spe = self._steps_per_execution
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        if spe > 1:
            # callbacks fire once per execution, and how many executions
            # an epoch has depends on batch sizes the loader reveals only
            # while iterating: report an unknown length, as the JAX fit
            steps = None
        cbks = _callbacks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, verbose=verbose, save_freq=save_freq,
            save_dir=save_dir, metrics=self._metrics_names())
        self.stop_training = False
        cbks.on_train_begin()
        logs: Dict[str, Any] = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, (kind, batch) in enumerate(
                    _grouped(train_loader, spe)):
                cbks.on_train_batch_begin(step)
                if kind == "multi":
                    losses = self._train_batches_device(batch)
                    logs = {"loss": losses.mean(),
                            "batch_size": sum(int(b[0].shape[0])
                                              for b in batch)}
                    cbks.on_train_batch_end(step, logs)
                    if self.stop_training:
                        break
                    continue
                inputs, labels = self._split(batch)
                loss, metrics = self._train_batch_device(inputs, labels)
                logs = {"loss": loss}  # a device scalar: callbacks pull it
                # multi-output metric results (Accuracy topk=(1, 5)) pair
                # 1:1 with the flattened names
                flat = [r for res in metrics for r in _tuplize(res)]
                logs.update(zip(self._metrics_names(), flat))
                logs["batch_size"] = int(inputs[0].shape[0])
                cbks.on_train_batch_end(step, logs)
                if self.stop_training:
                    break
            for m in self._metrics:  # epoch-end logs: accumulated values
                logs.update(zip(_tuplize(m.name()),
                                _tuplize(m.accumulate())))
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size,
                              verbose=verbose, callbacks=cbks, _inner=True)
            if self.stop_training:
                break
        cbks.on_train_end(logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _inner=False):
        """The mean loss over ``eval_data``'s batches and the accumulated
        metrics, as ``{"loss": float, <metric name>: value}``."""
        loader = self._as_loader(eval_data, batch_size, False, False,
                                 num_workers)
        cbks = callbacks if _inner else _callbacks_mod.config_callbacks(
            callbacks, model=self, verbose=verbose,
            metrics=self._metrics_names())
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        batch_losses = []  # device scalars: one wait, at the end
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            inputs, labels = self._split(batch)
            loss, _ = self._eval_batch_device(inputs, labels)
            batch_losses.append(loss)
            cbks.on_eval_batch_end(step, {"loss": loss})
        n_batches = len(batch_losses)
        total = float(torch.stack(batch_losses).sum()) if n_batches else 0.0
        if n_batches == 0:
            import warnings

            warnings.warn("evaluate() saw zero batches: metrics are "
                          "meaningless", RuntimeWarning)
        logs = {"loss": total / max(n_batches, 1)}
        for m in self._metrics:
            logs.update(zip(_tuplize(m.name()), _tuplize(m.accumulate())))
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """The network's outputs over ``test_data``: a list with one entry a
        batch (numpy; bf16 outputs as float32), or with
        ``stack_outputs=True`` the batches concatenated along axis 0."""
        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers, allow_partial=True)
        outputs = []
        for batch in loader:
            inputs, _ = self._split(batch, with_labels=False)
            pad = 0
            if self._plan is not None:
                # pad the partial final batch to shardability, slice it off
                # after: predictions stay 1:1 with the dataset
                n = int(inputs[0].shape[0])
                pad = (-n) % self._plan.n_data_shards
                if pad:
                    inputs = tuple(_pad_rows(b, pad) for b in inputs)
            out = serialization._to_host(self.predict_batch(inputs))
            if pad:
                out = (type(out)(o[:-pad] for o in out)
                       if isinstance(out, (tuple, list)) else out[:-pad])
            outputs.append(out)
        if stack_outputs and outputs:
            first = outputs[0]
            if isinstance(first, (tuple, list)):
                outputs = type(first)(
                    np.concatenate(xs, axis=0) for xs in zip(*outputs))
            else:
                outputs = np.concatenate(outputs, axis=0)
        return outputs

    # -- persistence ---------------------------------------------------------
    def save(self, path: str, training: bool = True, input_spec=None):
        """``training=True``: write ``path.pdparams`` (the network's state
        dict) and, with an optimizer, ``path.pdopt`` (``{"state": {"count",
        "slots": {param: {slot: array}}}, "LR_Scheduler" | "lr"}``, the JAX
        package's layout; a ``Lookahead``'s state is its ``{"inner",
        "slow", "count"}`` tree).  Parent directories are created."""
        if not training:
            _unported("save(training=False), the inference export",
                      "static graph and the long tail")
        self._check_unsharded("save")
        serialization.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            st = self._optimizer._state
            opt_state: Dict[str, Any] = (
                {"state": _state_tree(st)} if st is not None else {})
            sched = self._optimizer.lr_scheduler
            if sched is not None:
                opt_state["LR_Scheduler"] = sched.state_dict()
            else:
                opt_state["lr"] = self._optimizer.get_lr()
            serialization.save(opt_state, path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer: bool = False):
        """Read ``path.pdparams`` into the network (each value cast to its
        parameter's dtype and device) and, unless ``reset_optimizer``,
        ``path.pdopt`` into the prepared optimizer (slots, count, and the
        scheduler or learning rate)."""
        self._check_unsharded("load")
        state = serialization.load(path + ".pdparams")
        missing = self.network.set_state_dict(state)
        if missing and not skip_mismatch:
            raise InvalidArgumentError(
                f"unmatched keys in checkpoint: {missing[:5]}")
        if not reset_optimizer and os.path.exists(path + ".pdopt"):
            opt_state = serialization.load(path + ".pdopt")
            opt = self._optimizer
            if opt is not None:
                flat: Dict[str, Any] = {}
                if "state" in opt_state:
                    flat = opt._state_dict_of(opt_state["state"])
                sched = opt.lr_scheduler
                if sched is not None and "LR_Scheduler" in opt_state:
                    flat["LR_Scheduler"] = opt_state["LR_Scheduler"]
                elif sched is None and "lr" in opt_state:
                    opt.set_lr(float(opt_state["lr"]))
                opt.set_state_dict(flat)
        return self

    def _check_unsharded(self, what):
        if self._plan is not None and self._plan.sharded:
            _unported(f"{what} of a plan with sharded parameters or "
                      f"optimizer slots", "distributed execution")

    # -- misc ----------------------------------------------------------------
    def parameters(self):
        return list(self.network.parameters())

    def _metrics_names(self):
        names = []
        for m in self._metrics:
            names.extend(_tuplize(m.name()))
        return names

    def summary(self, input_size=None, dtype=None):
        """Print each parameter's dotted name, shape and size, and the
        totals; returns ``{"total_params", "trainable_params"}``."""
        rows = []
        total = trainable = 0
        for name, p in self.network.named_parameters():
            n = int(p.numel())
            total += n
            if p.requires_grad:
                trainable += n
            rows.append((name, tuple(p.shape), n))
        width = max([len(r[0]) for r in rows], default=10) + 2
        lines = [f"{'Layer':<{width}}{'Shape':<20}{'Params':>12}"]
        lines += [f"{n:<{width}}{str(s):<20}{c:>12,}" for n, s, c in rows]
        lines.append(f"Total params: {total:,}")
        lines.append(f"Trainable params: {trainable:,}")
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": trainable}
