"""Weight-averaging optimizers: ExponentialMovingAverage, ModelAverage,
Lookahead (port of ``paddle_tpu.optimizer.averaging``).

EMA and ModelAverage keep float32 shadow sums of a network's parameters
(update after each step; ``apply()`` swaps the average in for an
evaluation and restores the weights after it).  Lookahead wraps any
optimizer: its slow weights live in the state beside the inner state, so
the functional ``update`` and the eager ``step()`` both work, as in the
JAX package.  Parameters are updated in place: ``apply()`` copies into
them, and their identity (what an optimizer is bound to) never changes.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from ..framework.dtype import is_low_precision, numpy_to_tensor
from ..framework.errors import InvalidArgumentError
from .optimizer import Optimizer

__all__ = ["ExponentialMovingAverage", "ModelAverage", "Lookahead"]


def _params_of(parameters):
    if isinstance(parameters, torch.nn.Module):
        return [p for _, p in parameters.named_parameters()]
    params = list(parameters or [])
    if not params or not all(isinstance(p, torch.Tensor) for p in params):
        raise InvalidArgumentError(
            "pass a Layer or a list of parameters (layer.parameters())")
    return params


class _Swap:
    """``apply()`` / ``restore()`` over a list of parameters."""

    def _swap_in(self, values):
        with torch.no_grad():
            self._backup = [p.detach().clone() for p in self._params]
            for p, v in zip(self._params, values):
                p.copy_(v)

    def restore(self):
        if self._backup is not None:
            with torch.no_grad():
                for p, v in zip(self._params, self._backup):
                    p.copy_(v)
            self._backup = None


class ExponentialMovingAverage(_Swap):
    """EMA of the parameters:

    >>> ema = ExponentialMovingAverage(net, decay=0.999)
    >>> for batch: train_step(); ema.update()
    >>> with ema.apply():   # the parameters are the bias-corrected EMA
    ...     evaluate()

    ``thres_steps=True`` ramps the decay up as ``min(decay, (1 + t) / (10 +
    t))``; the bias correction divides by ``1 - prod(decays)``."""

    def __init__(self, parameters, decay: float = 0.999,
                 thres_steps: bool = False, name=None):
        if not (0.0 <= decay < 1.0):
            raise InvalidArgumentError("decay must be in [0, 1)")
        self._params = _params_of(parameters)
        self._decay = float(decay)
        self._thres = bool(thres_steps)
        self._step = 0
        self._shadow = [torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for p in self._params]
        self._decay_prod = 1.0
        self._backup = None

    def update(self):
        """Fold the current weights into the shadow (once a step)."""
        self._step += 1
        d = self._decay
        if self._thres:
            d = min(d, (1.0 + self._step) / (10.0 + self._step))
        self._decay_prod *= d
        with torch.no_grad():
            for s, p in zip(self._shadow, self._params):
                s.mul_(d).add_((1.0 - d) * p.detach().float())

    def _corrected(self):
        corr = (1.0 - self._decay_prod) or 1.0
        return [(s / corr).to(p.dtype)
                for s, p in zip(self._shadow, self._params)]

    @contextlib.contextmanager
    def apply(self, need_restore: bool = True):
        if self._step == 0:
            raise InvalidArgumentError("apply() before any update()")
        self._swap_in(self._corrected())
        try:
            yield self
        finally:
            if need_restore:
                self.restore()


class ModelAverage(_Swap):
    """Windowed average of the parameters: sums in rotating windows (the
    reference's sum_1 / sum_2 / sum_3), so the applied average covers
    about the last ``average_window_rate`` of the updates, clamped to
    ``[min_average_window, max_average_window]``."""

    def __init__(self, parameters, average_window_rate: float = 0.15,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name=None):
        self._params = _params_of(parameters)
        self.rate = float(average_window_rate)
        self.min_window = int(min_average_window)
        self.max_window = int(max_average_window)
        self._sum1, self._sum2, self._sum3 = (self._zeros() for _ in range(3))
        self._num1 = self._num2 = self._num3 = 0
        self._updates = 0
        self._backup = None

    def _zeros(self):
        return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in self._params]

    def update(self):
        self._updates += 1
        self._num1 += 1
        with torch.no_grad():
            for s, p in zip(self._sum1, self._params):
                s.add_(p.detach().float())
        if (self._num1 >= self.max_window
                or self._num1 >= max(self.rate * self._updates,
                                     self.min_window)):
            # rotate: drop the oldest window, start a fresh one
            self._sum3, self._num3 = self._sum2, self._num2
            self._sum2, self._num2 = self._sum1, self._num1
            self._sum1, self._num1 = self._zeros(), 0

    @contextlib.contextmanager
    def apply(self, need_restore: bool = True):
        total = self._num1 + self._num2 + self._num3
        if total == 0:
            raise InvalidArgumentError("apply() before any update()")
        self._swap_in([((s1 + s2 + s3) / total).to(p.dtype)
                       for p, s1, s2, s3 in zip(self._params, self._sum1,
                                                self._sum2, self._sum3)])
        try:
            yield self
        finally:
            if need_restore:
                self.restore()


class Lookahead(Optimizer):
    """Lookahead (k steps forward, one back) over any inner optimizer: every
    ``k``-th step the slow weights move ``alpha`` of the way to the fast
    ones (the inner optimizer's float32 master where it keeps one) and the
    fast weights — and that master — are reset to them.  State:
    ``{"inner": inner state, "slow": {name: tensor}, "count": int}``."""

    def __init__(self, inner_optimizer: Optimizer, alpha: float = 0.5,
                 k: int = 5):
        if not isinstance(inner_optimizer, Optimizer):
            raise InvalidArgumentError("inner_optimizer must be an Optimizer")
        if not (0.0 < alpha <= 1.0):
            raise InvalidArgumentError("alpha in (0, 1]")
        if k < 1:
            raise InvalidArgumentError("k must be >= 1")
        self.inner = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        super().__init__(learning_rate=inner_optimizer._learning_rate,
                         parameters=inner_optimizer._params,
                         grad_clip=None,  # the inner optimizer clips
                         multi_precision=inner_optimizer._multi_precision)

    def get_lr(self):
        return self.inner.get_lr()

    def set_lr(self, value):
        self.inner.set_lr(value)

    @property
    def lr_scheduler(self):
        return self.inner.lr_scheduler

    def _bind(self, named_params):
        named_params = dict(named_params)
        super()._bind(named_params)
        self.inner._bind(named_params)

    def init(self, params) -> Dict[str, Any]:
        # float32 slow weights for low-precision parameters: the k-step
        # interpolation must not round through bf16
        return {"inner": self.inner.init(params),
                "slow": {n: (p.detach().float() if is_low_precision(p)
                             else p.detach().clone())
                         for n, p in params.items()},
                "count": 0}

    def _host_step(self, state, lr, plan):
        self.inner._host_step(state["inner"], lr, plan)
        state["count"] += 1
        # the sync step is a branch of the plan: a captured graph holds it
        plan.branch(self, state["count"] % self.k == 0)

    def _run(self, grads, state, params, plan):
        self.inner._run(grads, state["inner"], params, plan)
        if not plan.taken(self):
            return
        with torch.no_grad():
            for n, p in params.items():
                slow = state["slow"][n]
                master = state["inner"]["slots"].get(n, {}).get("master")
                fast = master if master is not None else p
                slow.add_(self.alpha * (fast.to(slow.dtype) - slow))
                p.copy_(slow)
                if master is not None:
                    # else the next inner step resumes the fast trajectory
                    master.copy_(slow)

    # -- state: not the base {"count", "slots"} layout -----------------------
    def state_dict(self):
        d: Dict[str, Any] = {}
        if self._state is not None:
            d["count"] = self._state["count"]
            d["slow"] = dict(self._state["slow"])
            saved, self.inner._state = self.inner._state, self._state["inner"]
            try:
                d["inner"] = self.inner.state_dict()
            finally:
                self.inner._state = saved
        if self.lr_scheduler is not None:
            d["LR_Scheduler"] = self.lr_scheduler.state_dict()
        return d

    def set_state_dict(self, state):
        state = dict(state)
        lr_state = state.pop("LR_Scheduler", None)
        if lr_state and self.lr_scheduler is not None:
            self.lr_scheduler.set_state_dict(lr_state)
        if not state:
            return
        if self._params is None:
            raise InvalidArgumentError(
                "set_state_dict on a Lookahead without bound parameters; "
                "pass parameters= (or Model.prepare it) first")
        params = self._bound()
        if self._state is None:
            self._state = self.init(params)
        st = self._state
        if "count" in state:
            st["count"] = int(state["count"])
        with torch.no_grad():
            for n, v in dict(state.get("slow", {})).items():
                if n in st["slow"]:
                    st["slow"][n].copy_(numpy_to_tensor(v).to(
                        st["slow"][n].device, st["slow"][n].dtype))
        inner_sd = state.get("inner")
        if inner_sd:
            saved, self.inner._state = self.inner._state, st["inner"]
            try:
                self.inner.set_state_dict(inner_sd)
                st["inner"] = self.inner._state
            finally:
                self.inner._state = saved

    def _state_dict_of(self, tree) -> Dict[str, Any]:
        return {"count": tree["count"], "slow": tree["slow"],
                "inner": self.inner._state_dict_of(tree["inner"])}

    def __repr__(self):
        return f"Lookahead(k={self.k}, alpha={self.alpha}, inner={self.inner!r})"
