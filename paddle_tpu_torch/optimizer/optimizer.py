"""Optimizers — port of ``paddle_tpu.optimizer.optimizer`` (the Optimizer
base, SGD, Momentum, Adam, AdamW).

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

Two surfaces, one rule: the functional ``init`` / ``update(grads, state,
params, lr=)`` of the JAX package (pure: returns new params and state),
and the eager ``step()`` over the parameters bound by ``parameters=`` or
by ``hapi.Model.prepare``, reading each parameter's ``.grad`` and
updating in place.  The per-parameter updates are grouped by device and
dtype into ``torch._foreach_*`` calls (plain PyTorch, a few launches per
group instead of ~10 per parameter).  Not ported yet (ROADMAP queue A):
the other optimizers, SelectedRows/``lazy_mode``, DGC.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..framework.dtype import is_low_precision, numpy_to_tensor
from ..framework.errors import InvalidArgumentError, UnimplementedError
from ..regularizer import L2Decay, WeightDecayRegularizer
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]


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

    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Mapping[str, torch.Tensor], lr: Optional[float] = None):
        """Pure update (the JAX package's signature): returns
        ``(new_params, new_state)`` and leaves the inputs as they were.
        ``lr`` defaults to :meth:`get_lr`."""
        new_params = {k: p.detach().clone() for k, p in params.items()}
        new_state = {"count": state["count"],
                     "slots": {k: {s: t.clone() for s, t in v.items()}
                               for k, v in state["slots"].items()}}
        self._apply(grads, new_state, new_params, lr)
        return new_params, new_state

    def _apply(self, grads, state, params, lr=None):
        """One step IN PLACE on ``params`` and ``state``.  Parameters with
        no gradient (``None`` or absent) are left as they are."""
        lr = self.get_lr() if lr is None else float(lr)
        grads = {k: g for k, g in grads.items() if g is not None}
        if self._grad_clip is not None:
            grads = self._grad_clip(grads)
        state["count"] += 1
        groups: Dict[tuple, list] = {}
        with torch.no_grad():
            for name, p in params.items():
                g = grads.get(name)
                if g is None:
                    continue
                it = _Item(name, p, g, state["slots"][name])
                groups.setdefault((it.w.device, it.w.dtype), []).append(it)
            for items in groups.values():
                self._step_group(items, lr, state["count"])

    def _step_group(self, items, lr, count):
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
        self._update(ws, gs, slots, lr, count)
        self._finish(items, lr)

    def _finish(self, items, lr):
        """Write each updated ``w`` back into its parameter (the master
        and the working copy are rounded to the parameter's dtype)."""
        back = [it for it in items if it.w is not it.p]
        if back:
            torch._foreach_copy_([it.p for it in back], [it.w for it in back])

    def _use_l2_decay(self, name: str) -> bool:
        return True

    def _update(self, ws, gs, slots, lr, count):
        """The rule over lists: update ``ws`` and the ``slots`` lists in
        place."""
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

    def step(self, grads=None):
        """Apply gradients to the bound parameters in place: their
        ``.grad`` (after ``loss.backward()``), or ``grads`` — a
        ``{name: grad}`` dict or a sequence aligned with the trainable
        parameters."""
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
        if self._state is None:
            self._state = self.init(params)
        self._apply(grads, self._state, params)

    def clear_grad(self):
        """Drop the bound parameters' ``.grad``."""
        for p in (self._params or {}).values():
            p.grad = None

    clear_gradients = clear_grad

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

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.get_lr()})"


class SGD(Optimizer):
    """param -= lr * grad."""

    def _update(self, ws, gs, slots, lr, count):
        torch._foreach_add_(ws, gs, alpha=-lr)


class Momentum(Optimizer):
    """Heavy-ball / Nesterov momentum: velocity = mu·velocity + grad;
    param -= lr·velocity (nesterov: param -= (grad + mu·velocity)·lr)."""

    _slot_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, ws, gs, slots, lr, count):
        vs = slots["velocity"]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, gs)
        if self._nesterov:
            step = torch._foreach_add(gs, vs, alpha=self._momentum)
            torch._foreach_mul_(step, lr)
            torch._foreach_sub_(ws, step)
        else:
            torch._foreach_add_(ws, vs, alpha=-lr)


class Adam(Optimizer):
    """Adam with bias correction from the shared step count:
    ``m = b1·m + (1-b1)·g``, ``v = b2·v + (1-b2)·g²``,
    ``w -= lr·(m/(1-b1^t)) / (sqrt(v/(1-b2^t)) + eps)``."""

    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if lazy_mode:
            raise UnimplementedError(
                "Adam(lazy_mode=True) updates SelectedRows rows only; "
                "sparse gradients are not ported yet (ROADMAP queue A, "
                "training step)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update(self, ws, gs, slots, lr, count):
        b1, b2 = self._beta1, self._beta2
        m, v = slots["moment1"], slots["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(gs, 1 - b1))
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, sq)
        # bias corrections in float32, as the JAX rule computes them
        t = np.float32(count)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        mhat = torch._foreach_div(m, bc1)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_mul_(mhat, lr)
        torch._foreach_div_(mhat, den)
        torch._foreach_sub_(ws, mhat)


class AdamW(Adam):
    """Adam with decoupled weight decay, applied to the parameter after
    the Adam step (``torch.optim.AdamW`` decays before it).
    ``apply_decay_param_fun(name) -> bool`` picks the decayed parameters
    by dotted name."""

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

    def _finish(self, items, lr):
        decayed = [it for it in items if self._coeff and (
            self._decay_fn is None or self._decay_fn(it.name))]
        masters = [it.master for it in decayed if it.master is not None]
        if masters:  # new = new - lr·coeff·new, on the master
            torch._foreach_add_(masters, masters, alpha=-lr * self._coeff)
        super()._finish(items, lr)
        plain = [it.p for it in decayed if it.master is None]
        if plain:  # on the parameter as stored (rounded), in float32 math
            torch._foreach_mul_(plain, 1.0 - lr * self._coeff)
