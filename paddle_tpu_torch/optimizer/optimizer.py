"""Optimizers — port of ``paddle_tpu.optimizer.optimizer`` (the Optimizer
base, SGD, Momentum, Adagrad, Adam, AdamW, Adamax, Ftrl, RMSProp,
Adadelta, Lamb, Lars).

The rules are the JAX package's, not ``torch.optim``'s:

* state is ``{"count": int, "slots": {param_name: {slot: tensor}}}`` — one
  step count shared by every parameter (it replaces the reference's
  per-parameter beta-power accumulators); Adam's bias correction is
  ``m / (1 - b1^t)`` with ``eps`` added to ``sqrt(vhat)``;
* moments (and Momentum's velocity) are float32 for a bf16/fp16 parameter
  even without ``multi_precision``;
* ``multi_precision=True`` keeps a float32 ``master`` slot for bf16/fp16
  parameters only: the grad is cast to the master's dtype, the rule runs
  on the master, and the parameter becomes the cast-down master;
* ``weight_decay`` (a float, ``L2Decay`` or ``L1Decay``) adds the penalty
  gradient before the rule — except AdamW, whose decay is decoupled and
  applied AFTER the Adam step, ``new = new - lr·coeff·new`` (on the master
  where there is one), filtered by ``apply_decay_param_fun(dotted_name)``;
* ``grad_clip`` runs on the whole grad dict before the count advances;
* ``state_dict`` / ``set_state_dict`` use JAX's flat layout and slot
  names (``count``, ``"<param>.moment1"``, ``moment2``, ``master``,
  ``velocity``, ``LR_Scheduler``), so optimizer state moves between the
  packages (``Model.save`` / ``load`` write the nested ``{"count",
  "slots"}`` form of the same state).

Where the JAX package runs a bf16 parameter without a master through
bf16 arithmetic, the port computes the rule in float32 and rounds once
(the same result up to bf16 rounding of intermediates).

A step has a host half and a device half.  The host half
(:meth:`Optimizer._plan`) advances the step counts and computes, in the
JAX package's host arithmetic (float32 bias corrections ``1 - beta^t``,
``1 - lr·coeff`` in double), every scalar the rule reads, and the branch
it takes (a ``Lookahead`` sync step, a gradient-merge apply step): a
:class:`StepPlan`.  The device half reads those scalars as 0-d tensors on
the parameters' device, never as Python numbers, so a CUDA graph that
captures it replays with the scalars of each new step written into its
table (``hapi/_graph_step.py``), and an eager step and a replayed one run
the same kernels on the same values.

Two surfaces, one rule: the functional ``init`` / ``update(grads, state,
params, lr=)`` of the JAX package (pure: returns new params and state),
and the eager ``step()`` over the parameters bound by ``parameters=`` or
by ``hapi.Model.prepare``, reading each parameter's ``.grad`` and
updating in place.  The per-parameter updates are grouped by device and
dtype into ``torch._foreach_*`` calls (plain PyTorch, a few launches per
group instead of ~10 per parameter; the rules that are rarely on a hot
path loop over the parameters).

A :class:`~paddle_tpu_torch.framework.selected_rows.SelectedRows`
gradient (an ``Embedding(sparse=True)`` table inside a sparse-aware train
step) goes by the rule's ``_sparse_mode``, as in the JAX package:
``"row"`` (SGD, Momentum, Adagrad, Ftrl) updates only the touched rows —
gather the rows of the parameter, the master and every slot, run the same
rule on them, scatter back, O(k·D) whatever the table's height;
``"lazy_flag"`` (Adam, AdamW) does so with ``lazy_mode=True`` and
densifies otherwise (every row's moments decay, the reference's non-lazy
sparse Adam); ``"dense"`` (Adamax, RMSProp, Adadelta, Lamb, Lars)
densifies.  Duplicate ids are summed first, in a fixed order; padding and
out-of-range ids update nothing (``selected_rows.safe_rows``).  Lazy AdamW
decays the touched rows only.  The JAX Lamb and Lars raise ``TypeError`` on
a SelectedRows gradient; here they densify, as their sparse mode says.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..framework.dtype import is_low_precision, numpy_to_tensor
from ..framework.errors import InvalidArgumentError
from ..framework.selected_rows import SelectedRows, safe_rows
from ..regularizer import L2Decay, WeightDecayRegularizer
from .lr import LRScheduler

__all__ = ["Optimizer", "StepPlan", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "Ftrl", "RMSProp", "Adadelta", "Lamb", "Lars"]


def _device_of(params) -> torch.device:
    for p in params.values():
        return p.device
    return torch.device("cpu")


def _clone_tree(tree):
    """A copy of a state tree: nested dicts, tensors cloned."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _bias_correction(beta: float, count: int) -> float:
    """``1 - beta^t`` in float32, as the JAX rules compute it."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(count))


class StepPlan:
    """The host half of one optimizer step: the scalars the rule reads,
    by name, and the branch decisions of the step (``key``).

    The device half reads a scalar with :meth:`get` as a 0-d tensor: an
    element of the plan's row, a float64 vector on the parameters'
    device (copied from the host for an eager step, a row of a captured
    graph's table when the step is captured), cast to the dtype of the
    tensor it meets — what a Python number becomes in a float32 op."""

    __slots__ = ("names", "values", "_branches", "_row", "_cache")

    def __init__(self):
        self.names: Dict[str, int] = {}
        self.values: list = []
        self._branches: Dict[int, bool] = {}
        self._row: Optional[torch.Tensor] = None
        self._cache: Dict[tuple, torch.Tensor] = {}

    def put(self, name: str, value: float):
        self.names[name] = len(self.values)
        self.values.append(float(value))

    def branch(self, owner, taken: bool) -> bool:
        """Record the branch ``owner`` (an optimizer) takes this step."""
        self._branches[id(owner)] = bool(taken)
        return bool(taken)

    def taken(self, owner) -> bool:
        return self._branches[id(owner)]

    @property
    def key(self) -> tuple:
        """The step's branch decisions and scalar names: steps with equal
        keys run the same kernels."""
        return tuple(self._branches.values()), tuple(self.names)

    def bind(self, row: torch.Tensor):
        """Read the scalars from ``row`` (a float64 vector on the device
        with this plan's values at its indices)."""
        self._row = row
        self._cache = {}

    def materialize(self, device):
        """Copy the values to ``device`` as the row (an eager step): from
        pinned memory and without a wait on the card."""
        if self._row is not None:
            return
        host = torch.tensor(self.values or [0.0], dtype=torch.float64)
        device = torch.device(device)
        if device.type == "cuda":
            host = host.pin_memory()
        self.bind(host.to(device, non_blocking=True))

    def get(self, name: str, dtype=torch.float32) -> torch.Tensor:
        key = (name, dtype)
        t = self._cache.get(key)
        if t is None:
            t = self._cache[key] = self._row[self.names[name]].to(dtype)
        return t


def _named(parameters) -> "OrderedDict[str, torch.Tensor]":
    """``parameters=`` as an ordered ``{name: tensor}``: a mapping keeps
    its names, a sequence of tensors is named ``param_<i>``."""
    if isinstance(parameters, Mapping):
        return OrderedDict(parameters)
    return OrderedDict((f"param_{i}", p) for i, p in enumerate(parameters))


class _Item:
    """One parameter's view for a step: ``w`` is what the rule updates in
    place (the master, the parameter itself, or a float32 working copy of
    a low-precision parameter), ``g`` the gradient in ``w``'s dtype."""

    __slots__ = ("name", "p", "w", "g", "slots", "master")

    def __init__(self, name, p, g, slots):
        self.name, self.p, self.slots = name, p, slots
        self.master = slots.get("master")
        if self.master is not None:
            self.w = self.master
        elif is_low_precision(p):
            self.w = p.float()
        else:
            self.w = p
        self.g = g.to(self.w.dtype)


class Optimizer:
    """Base optimizer.

    Args mirror paddle.optimizer.Optimizer: ``learning_rate`` (float or
    LRScheduler), ``parameters`` (a mapping or sequence of parameters, for
    eager ``step()``), ``weight_decay`` (float → L2 added to the gradient,
    or an ``L1Decay``/``L2Decay``), ``grad_clip`` (one of the ClipGradBy*
    callables), ``multi_precision`` (float32 master weights for bf16/fp16
    parameters).
    """

    #: slots the rule keeps per parameter (besides ``master``)
    _slot_names: Sequence[str] = ()
    #: how the rule takes a SelectedRows gradient: "row", "lazy_flag" or
    #: "dense" (the module docstring)
    _sparse_mode = "dense"
    _lazy_mode = False

    def __init__(self, learning_rate: Union[float, LRScheduler] = 0.001,
                 parameters=None, weight_decay=None,
                 grad_clip: Optional[Callable] = None, name=None,
                 multi_precision: bool = False):
        self._learning_rate = learning_rate
        self._regularizer = None
        if isinstance(weight_decay, L2Decay):
            weight_decay = weight_decay.coeff
        elif isinstance(weight_decay, WeightDecayRegularizer):
            self._regularizer = weight_decay
            weight_decay = 0.0
        self._weight_decay = float(weight_decay) if weight_decay else 0.0
        self._grad_clip = grad_clip
        self._name = name
        self._multi_precision = bool(multi_precision)
        self._params: Optional["OrderedDict[str, torch.Tensor]"] = (
            _named(parameters) if parameters is not None else None)
        self._state: Optional[Dict[str, Any]] = None

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate.last_lr
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise InvalidArgumentError(
                "optimizer's learning rate is an LRScheduler; call its "
                "step() instead")
        self._learning_rate = float(value)

    @property
    def lr_scheduler(self):
        return (self._learning_rate
                if isinstance(self._learning_rate, LRScheduler) else None)

    # -- functional API ------------------------------------------------------
    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        """Slot state for a ``{name: tensor}`` parameter dict."""
        return {"count": 0,
                "slots": {name: self._init_slots(p.detach())
                          for name, p in params.items()}}

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        slots = {}
        if self._multi_precision and is_low_precision(p):
            slots["master"] = p.float()  # a copy: never aliases p
        acc = slots.get("master", p)
        dt = torch.float32 if is_low_precision(acc) else acc.dtype
        for s in self._slot_names:
            slots[s] = torch.zeros_like(acc, dtype=dt)
        return slots

    def _rows_only(self) -> bool:
        """Whether a SelectedRows gradient updates its rows only."""
        return self._sparse_mode == "row" or (
            self._sparse_mode == "lazy_flag" and self._lazy_mode)

    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Mapping[str, torch.Tensor], lr: Optional[float] = None):
        """Pure update (the JAX package's signature): returns
        ``(new_params, new_state)`` and leaves the inputs as they were.
        ``lr`` defaults to :meth:`get_lr`."""
        new_params = {k: p.detach().clone() for k, p in params.items()}
        new_state = _clone_tree(state)
        self._apply(grads, new_state, new_params, lr)
        return new_params, new_state

    def _apply(self, grads, state, params, lr=None,
               plan: Optional[StepPlan] = None):
        """One step IN PLACE on ``params`` and ``state``.  Parameters with
        no gradient (``None`` or absent) are left as they are.  ``plan``:
        the step's host half, already taken (a captured step's); else it
        is taken here with ``lr`` (default :meth:`get_lr`)."""
        if plan is None:
            lr = self.get_lr() if lr is None else float(lr)
            plan = self._plan(state, lr)
        plan.materialize(_device_of(params))
        self._run(grads, state, params, plan)

    def _plan(self, state, lr: float) -> StepPlan:
        """The host half of one step on ``state``: advance its counts,
        compute its scalars."""
        plan = StepPlan()
        self._host_step(state, lr, plan)
        return plan

    def _host_step(self, state, lr: float, plan: StepPlan):
        state["count"] += 1
        self._put_scalars(plan, lr, state["count"])

    def _put_scalars(self, plan: StepPlan, lr: float, count: int):
        """The scalars the rule reads at step ``count`` (the JAX rules'
        host arithmetic)."""
        plan.put("lr", lr)

    def _run(self, grads, state, params, plan: StepPlan):
        """The device half of a step."""
        grads = {k: g for k, g in grads.items() if g is not None}
        if self._grad_clip is not None:
            grads = self._grad_clip(grads)
        groups: Dict[tuple, list] = {}
        with torch.no_grad():
            for name, p in params.items():
                g = grads.get(name)
                if g is None:
                    continue
                if isinstance(g, SelectedRows):
                    if self._rows_only():
                        self._sparse_row_rule(p, g, state["slots"][name],
                                              plan, name)
                        continue
                    g = g.to_dense()
                it = _Item(name, p, g, state["slots"][name])
                groups.setdefault((it.w.device, it.w.dtype), []).append(it)
            for items in groups.values():
                self._step_group(items, plan)

    def _step_group(self, items, plan):
        ws = [it.w for it in items]
        gs = [it.g for it in items]
        decay = [i for i, it in enumerate(items)
                 if self._use_l2_decay(it.name)]
        if decay and (self._regularizer is not None or self._weight_decay):
            gs = list(gs)
            for i in decay:
                w = ws[i]
                pen = (self._regularizer(w).to(w.dtype)
                       if self._regularizer is not None
                       else self._weight_decay * w)
                gs[i] = gs[i] + pen
        slots = {s: [it.slots[s] for it in items] for s in self._slot_names}
        self._update(ws, gs, slots, plan)
        self._finish(items, plan)

    def _finish(self, items, plan):
        """Write each updated ``w`` back into its parameter (the master
        and the working copy are rounded to the parameter's dtype)."""
        back = [it for it in items if it.w is not it.p]
        if back:
            torch._foreach_copy_([it.p for it in back], [it.w for it in back])

    def _use_l2_decay(self, name: str) -> bool:
        return True

    def _sparse_row_rule(self, p, g: SelectedRows, slots, plan, name):
        """Touched-rows-only update, in place: gather the k merged rows of
        the parameter (or its master) and of every slot, run ``_update`` on
        them, scatter back.  Padding and out-of-range slots copy a valid
        slot (same id, same value: the same bits written twice); a
        gradient with no valid slot writes back what it read."""
        g = g.merged()
        if g.ids.shape[0] == 0:
            return
        ids, values, keep = safe_rows(g)
        master = slots.get("master")
        src = master if master is not None else p
        w_rows = src.index_select(0, ids)
        if master is None and is_low_precision(p):
            w_rows = w_rows.float()  # the working copy, as in _Item
        g_rows = values.to(w_rows.dtype)
        if self._use_l2_decay(name):
            if self._regularizer is not None:
                g_rows = g_rows + self._regularizer(w_rows).to(w_rows.dtype)
            elif self._weight_decay:
                g_rows = g_rows + self._weight_decay * w_rows
        old = {s: slots[s].index_select(0, ids) for s in self._slot_names}
        new = {s: v.clone() for s, v in old.items()}
        new_w = w_rows.clone()
        self._update([new_w], [g_rows], {s: [v] for s, v in new.items()},
                     plan)
        new_w = self._finish_rows(new_w, name, plan, master is not None,
                                  p.dtype)
        for s in self._slot_names:
            slots[s].index_copy_(0, ids, torch.where(keep, new[s], old[s]))
        new_w = torch.where(keep, new_w, w_rows)
        if master is not None:
            master.index_copy_(0, ids, new_w)
        p.index_copy_(0, ids, new_w.to(p.dtype))

    def _finish_rows(self, rows, name, plan, has_master, p_dtype):
        """The updated rows before they are written back (lazy AdamW
        decays them here)."""
        return rows

    def _update(self, ws, gs, slots, plan):
        """The rule over lists: update ``ws`` and the ``slots`` lists in
        place (by default :meth:`_update_one` on each parameter)."""
        for i, (w, g) in enumerate(zip(ws, gs)):
            self._update_one(w, g, {s: v[i] for s, v in slots.items()},
                             plan)

    def _update_one(self, w, g, slots, plan):
        """The rule on one parameter: update ``w`` and ``slots`` (``{name:
        tensor}``) in place."""
        raise NotImplementedError

    # -- eager API -----------------------------------------------------------
    def _bind(self, named_params: Mapping[str, torch.Tensor]):
        """Bind to a network's dotted-name parameters (``Model.prepare``
        does this for an optimizer built without ``parameters=``)."""
        self._params = OrderedDict(named_params)
        self._state = None

    def _bound(self) -> "OrderedDict[str, torch.Tensor]":
        if self._params is None:
            raise InvalidArgumentError(
                "optimizer was constructed without `parameters`; pass "
                "parameters= (or Model.prepare it) for eager step()")
        return OrderedDict((n, p) for n, p in self._params.items()
                           if p.requires_grad)

    def step(self, grads=None, _plan: Optional[StepPlan] = None):
        """Apply gradients to the bound parameters in place: their
        ``.grad`` (after ``loss.backward()``), or ``grads`` — a
        ``{name: grad}`` dict or a sequence aligned with the trainable
        parameters.  (``_plan``: the step's host half, taken beforehand by
        a graph runner.)"""
        params = self._bound()
        if grads is None:
            grads = {n: p.grad for n, p in params.items()}
        elif not isinstance(grads, Mapping):
            grads = list(grads)
            if len(grads) != len(params):
                raise InvalidArgumentError(
                    f"got {len(grads)} grads for {len(params)} trainable "
                    f"parameters")
            grads = dict(zip(params, grads))
        else:
            unknown = [k for k in grads if k not in params]
            if unknown:
                raise InvalidArgumentError(
                    f"grads for unknown parameters: {unknown[:5]}")
        self._apply(grads, self._ensure_state(), params, plan=_plan)

    def _ensure_state(self) -> Dict[str, Any]:
        """The state of the bound parameters, built on first use."""
        if self._state is None:
            self._state = self.init(self._bound())
        return self._state

    def clear_grad(self):
        """Drop the bound parameters' ``.grad``."""
        for p in (self._params or {}).values():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Graph mode (ref: fluid/optimizer.py minimize): bind this
        optimizer and the loss Variable to the loss's Program —
        ``static.Executor.run`` then takes the gradient of the recorded
        graph and applies this optimizer's step.  ``parameter_list`` /
        ``no_grad_set`` (Variables or names) narrow the parameters it
        updates.  Returns ``([], [(param, None), ...])`` like the 1.x
        (ops, params_grads) pair.  The optimizer may be built without
        ``parameters``: the Program's scope is what it updates."""
        from ..static.graph import Variable as _GraphVar

        if isinstance(loss, _GraphVar):
            prog = loss.program
            only = None
            if parameter_list is not None:
                only = {getattr(p, "name", p) for p in parameter_list}
            if no_grad_set:
                frozen = {getattr(p, "name", p) for p in no_grad_set}
                only = (only or set(prog.scope)) - frozen
            prog._bind_optimizer(self, loss.name, only)
            updated = [v for v in prog.all_parameters()
                       if only is None or v.name in only]
            return [], [(v, None) for v in updated]
        raise InvalidArgumentError(
            "minimize() outside graph mode: call loss.backward() and "
            "step() (or hapi.Model.prepare), or build a Program under "
            "fluid.program_guard and pass its loss Variable")

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self._state is not None:
            d["count"] = self._state["count"]
            for pname, slots in self._state["slots"].items():
                for sname, v in slots.items():
                    d[f"{pname}.{sname}"] = v
        if isinstance(self._learning_rate, LRScheduler):
            d["LR_Scheduler"] = self._learning_rate.state_dict()
        return d

    def set_state_dict(self, state: Mapping[str, Any]):
        """The inverse of :meth:`state_dict`: ``count``, one
        ``"<param>.<slot>"`` entry a slot (tensors, or the numpy leaves
        ``paddle_tpu_torch.load`` returns — the JAX package's layout, so
        its checkpoints resume here) and ``LR_Scheduler``.  The bound
        parameters' slots are built first where the optimizer has not
        stepped yet; each value is cast onto its slot's dtype and device
        (a slot the state has and this optimizer lacks is added in the
        value's dtype, as the JAX package adds it)."""
        state = dict(state)
        lr_state = state.pop("LR_Scheduler", None)
        if lr_state and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(lr_state)
        count = state.pop("count", None)
        if self._params is None:
            if state or count is not None:
                raise InvalidArgumentError(
                    "set_state_dict on an optimizer without bound "
                    "parameters would drop its slot state; pass "
                    "parameters= (or Model.prepare it) first")
            return
        params = self._bound()
        if self._state is None:
            self._state = self.init(params)
        if count is not None:
            self._state["count"] = int(np.asarray(count))
        with torch.no_grad():
            for key, v in state.items():
                pname, _, sname = key.rpartition(".")
                slots = self._state["slots"].get(pname)
                if slots is None:
                    continue
                v = numpy_to_tensor(v)
                cur = slots.get(sname)
                if cur is not None:
                    cur.copy_(v.to(device=cur.device, dtype=cur.dtype))
                else:
                    slots[sname] = v.to(params[pname].device).clone()

    @staticmethod
    def _state_dict_of(tree) -> Dict[str, Any]:
        """The flat :meth:`state_dict` form of a ``{"count", "slots"}``
        state tree (what ``Model.save`` writes)."""
        flat: Dict[str, Any] = {"count": tree["count"]}
        for pname, slots in tree["slots"].items():
            for sname, v in slots.items():
                flat[f"{pname}.{sname}"] = v
        return flat

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.get_lr()})"


class SGD(Optimizer):
    """param -= lr * grad; a SelectedRows gradient updates its rows only
    (the reference's sparse sgd kernel)."""

    _sparse_mode = "row"

    def _update(self, ws, gs, slots, plan):
        torch._foreach_sub_(ws, torch._foreach_mul(gs, plan.get(
            "lr", ws[0].dtype)))


class Momentum(Optimizer):
    """Heavy-ball / Nesterov momentum: velocity = mu·velocity + grad;
    param -= lr·velocity (nesterov: param -= (grad + mu·velocity)·lr); a
    SelectedRows gradient updates its rows only."""

    _slot_names = ("velocity",)
    _sparse_mode = "row"

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, ws, gs, slots, plan):
        vs = slots["velocity"]
        lr = plan.get("lr", ws[0].dtype)
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, gs)
        if self._nesterov:
            step = torch._foreach_add(gs, vs, alpha=self._momentum)
            torch._foreach_mul_(step, lr)
        else:
            step = torch._foreach_mul(vs, lr)
        torch._foreach_sub_(ws, step)


class Adam(Optimizer):
    """Adam with bias correction from the shared step count:
    ``m = b1·m + (1-b1)·g``, ``v = b2·v + (1-b2)·g²``,
    ``w -= lr·(m/(1-b1^t)) / (sqrt(v/(1-b2^t)) + eps)``.

    ``lazy_mode=True``: a SelectedRows gradient updates only the touched
    rows' parameters AND moments; otherwise it is densified and every
    row's moments decay."""

    _slot_names = ("moment1", "moment2")
    _sparse_mode = "lazy_flag"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = bool(lazy_mode)

    def _put_scalars(self, plan, lr, count):
        plan.put("lr", lr)
        # bias corrections in float32, as the JAX rule computes them
        plan.put("bc1", _bias_correction(self._beta1, count))
        plan.put("bc2", _bias_correction(self._beta2, count))

    def _update(self, ws, gs, slots, plan):
        b1, b2 = self._beta1, self._beta2
        dt = ws[0].dtype
        m, v = slots["moment1"], slots["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(gs, 1 - b1))
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, sq)
        mhat = torch._foreach_div(m, plan.get("bc1", dt))
        den = torch._foreach_div(v, plan.get("bc2", dt))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_mul_(mhat, plan.get("lr", dt))
        torch._foreach_div_(mhat, den)
        torch._foreach_sub_(ws, mhat)


class AdamW(Adam):
    """Adam with decoupled weight decay, applied to the parameter after
    the Adam step (``torch.optim.AdamW`` decays before it).
    ``apply_decay_param_fun(name) -> bool`` picks the decayed parameters
    by dotted name.  With ``lazy_mode=True`` a SelectedRows gradient
    decays the touched rows only: rows absent from the batch are left
    entirely as they were."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 apply_decay_param_fun=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        if isinstance(weight_decay, L2Decay):
            weight_decay = weight_decay.coeff
        elif isinstance(weight_decay, WeightDecayRegularizer):
            raise InvalidArgumentError(
                "AdamW's decay is decoupled (applied to the parameter, not "
                "the gradient) — only L2Decay/float coefficients are "
                "meaningful here; for L1 regularization use an Adam-family "
                "optimizer with weight_decay=L1Decay(...)")
        self._coeff = float(weight_decay)
        self._decay_fn = apply_decay_param_fun

    def _use_l2_decay(self, name):
        return False

    def _decays(self, name) -> bool:
        return bool(self._coeff) and (self._decay_fn is None
                                      or self._decay_fn(name))

    def _put_scalars(self, plan, lr, count):
        super()._put_scalars(plan, lr, count)
        plan.put("lr_coeff", lr * self._coeff)
        plan.put("decay", 1.0 - lr * self._coeff)

    def _finish_rows(self, rows, name, plan, has_master, p_dtype):
        if not self._decays(name):
            return rows
        if has_master or not is_low_precision(p_dtype):
            return rows * plan.get("decay", rows.dtype)
        # the JAX rule decays the parameter as stored (rounded), in f32
        return rows.to(p_dtype).float() * plan.get("decay")

    def _finish(self, items, plan):
        decayed = [it for it in items if self._decays(it.name)]
        masters = [it.master for it in decayed if it.master is not None]
        if masters:  # new = new - lr·coeff·new, on the master
            torch._foreach_sub_(masters, torch._foreach_mul(
                masters, plan.get("lr_coeff", masters[0].dtype)))
        super()._finish(items, plan)
        plain = [it.p for it in decayed if it.master is None]
        by_dtype: Dict[torch.dtype, list] = {}
        for p in plain:
            by_dtype.setdefault(p.dtype, []).append(p)
        for dt, ps in by_dtype.items():
            if is_low_precision(dt):
                # on the parameter as stored (rounded), in float32 math
                work = [p.float() for p in ps]
                torch._foreach_mul_(work, plan.get("decay"))
                torch._foreach_copy_(ps, work)
            else:
                torch._foreach_mul_(ps, plan.get("decay", dt))


class Adagrad(Optimizer):
    """``moment += g²; w -= lr·g / (sqrt(moment) + eps)``; the moment is
    float32 whatever the parameter's dtype and starts at
    ``initial_accumulator_value``.  A SelectedRows gradient updates its
    rows only."""

    _slot_names = ("moment",)
    _sparse_mode = "row"

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, p):
        slots = super()._init_slots(p)
        slots["moment"] = torch.full_like(slots["moment"], self._init_acc,
                                          dtype=torch.float32)
        return slots

    def _update_one(self, w, g, slots, plan):
        m = slots["moment"]
        m.add_(g.square())
        w.sub_(plan.get("lr", w.dtype) * g / (m.sqrt() + self._epsilon))


class Ftrl(Optimizer):
    """FTRL-proximal: a squared-gradient and a linear accumulator with an
    L1 soft threshold (``lr_power=-0.5`` is McMahan et al.'s schedule).  A
    SelectedRows gradient updates its rows only (the CTR optimizer of the
    reference's parameter servers)."""

    _slot_names = ("squared", "linear")
    _sparse_mode = "row"

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _update_one(self, w, g, slots, plan):
        sq, lin = slots["squared"], slots["linear"]
        g = g.to(sq.dtype)
        lr = plan.get("lr", g.dtype)
        wf = w.to(g.dtype)
        new_sq = sq + g.square()
        if self._lr_power == -0.5:
            sigma = (new_sq.sqrt() - sq.sqrt()) / lr
            y = new_sq.sqrt() / lr + 2.0 * self._l2
        else:
            p = -self._lr_power
            sigma = (new_sq.pow(p) - sq.pow(p)) / lr
            y = new_sq.pow(p) / lr + 2.0 * self._l2
        lin.add_(g - sigma * wf)
        x = torch.sign(lin) * self._l1 - lin
        new_w = torch.where(lin.abs() > self._l1, x / y,
                            torch.zeros_like(wf))
        sq.copy_(new_sq)
        w.copy_(new_w)


class Adamax(Optimizer):
    """The infinity-norm Adam: ``m = b1·m + (1-b1)·g``,
    ``u = max(b2·u, |g|)``, ``w -= (lr / (1-b1^t))·m / (u + eps)``."""

    _slot_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _put_scalars(self, plan, lr, count):
        plan.put("step", lr / _bias_correction(self._beta1, count))

    def _update_one(self, w, g, slots, plan):
        m, u = slots["moment"], slots["inf_norm"]
        m.mul_(self._beta1).add_((1 - self._beta1) * g)
        torch.maximum(self._beta2 * u, g.abs(), out=u)
        w.sub_(plan.get("step", w.dtype) * m / (u + self._epsilon))


class RMSProp(Optimizer):
    """RMSProp with optional centering and momentum:
    ``ms = rho·ms + (1-rho)·g²``, ``mom = momentum·mom + lr·g /
    sqrt(ms [- mg²] + eps)``, ``w -= mom``."""

    _slot_names = ("mean_square", "momentum_acc")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered
        if centered:
            self._slot_names = ("mean_square", "momentum_acc", "mean_grad")

    def _update_one(self, w, g, slots, plan):
        rho = self._rho
        ms = slots["mean_square"]
        ms.mul_(rho).add_((1 - rho) * g.square())
        if self._centered:
            mg = slots["mean_grad"]
            mg.mul_(rho).add_((1 - rho) * g)
            denom = (ms - mg.square() + self._epsilon).sqrt()
        else:
            denom = (ms + self._epsilon).sqrt()
        mom = slots["momentum_acc"]
        mom.mul_(self._momentum).add_(plan.get("lr", w.dtype) * g / denom)
        w.sub_(mom)


class Adadelta(Optimizer):
    """``asg = rho·asg + (1-rho)·g²``, ``upd = g·sqrt(asu + eps) /
    sqrt(asg + eps)``, ``asu = rho·asu + (1-rho)·upd²``,
    ``w -= lr·upd``."""

    _slot_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho, self._epsilon = rho, epsilon

    def _update_one(self, w, g, slots, plan):
        rho, eps = self._rho, self._epsilon
        asg, asu = slots["avg_squared_grad"], slots["avg_squared_update"]
        asg.mul_(rho).add_((1 - rho) * g.square())
        upd = g * (asu + eps).sqrt() / (asg + eps).sqrt()
        asu.mul_(rho).add_((1 - rho) * upd.square())
        w.sub_(plan.get("lr", w.dtype) * upd)


class Lamb(Optimizer):
    """LAMB: the Adam step ``r`` scaled per parameter by the trust ratio
    ``||w|| / ||r + wd·w||``; ``exclude_from_weight_decay_fn(name)`` exempts
    parameters from ``lamb_weight_decay``.  Whole-parameter norms: a
    SelectedRows gradient is densified."""

    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    _put_scalars = Adam._put_scalars

    def _step_group(self, items, plan):
        for it in items:
            wd = 0.0 if (self._exclude_fn and self._exclude_fn(it.name)) \
                else self._wd
            self._update_one(it.w, it.g, it.slots, plan, wd)
        self._finish(items, plan)

    def _update_one(self, w, g, slots, plan, wd=None):
        b1, b2 = self._beta1, self._beta2
        m, v = slots["moment1"], slots["moment2"]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        mhat = m / plan.get("bc1", w.dtype)
        vhat = v / plan.get("bc2", w.dtype)
        upd = mhat / (vhat.sqrt() + self._epsilon) + \
            (self._wd if wd is None else wd) * w
        w_norm = w.square().sum().sqrt()
        u_norm = upd.square().sum().sqrt()
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        w.sub_(plan.get("lr", w.dtype) * trust * upd)


class Lars(Momentum):
    """LARS on top of momentum: ``local_lr = coeff·||w|| / (||g|| +
    decay·||w|| + eps)``, ``v = mu·v + lr·local_lr·(g + decay·w)``,
    ``w -= v``; a parameter whose name contains a pattern of
    ``exclude_from_weight_decay`` gets no decay.  Whole-parameter norms: a
    SelectedRows gradient is densified."""

    _sparse_mode = "dense"

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, name=None,
                 exclude_from_weight_decay=None, epsilon=0,
                 multi_precision=False):
        super().__init__(learning_rate, momentum, parameters, False,
                         None, grad_clip, multi_precision, name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._exclude = exclude_from_weight_decay or []
        self._lars_eps = epsilon

    def _step_group(self, items, plan):
        for it in items:
            decay = 0.0 if any(pat in it.name for pat in self._exclude) \
                else self._lars_wd
            w, g, v = it.w, it.g, it.slots["velocity"]
            w_norm = w.square().sum().sqrt()
            g_norm = g.square().sum().sqrt()
            local_lr = torch.where(
                (w_norm > 0) & (g_norm > 0),
                self._lars_coeff * w_norm
                / (g_norm + decay * w_norm + self._lars_eps),
                torch.ones_like(w_norm))
            v.mul_(self._momentum).add_(
                plan.get("lr", w.dtype) * local_lr * (g + decay * w))
            w.sub_(v)
        self._finish(items, plan)
