"""Gradient merge: k-step gradient accumulation (port of
``paddle_tpu.optimizer.gradient_merge``).

``GradientMergeOptimizer(inner, k_steps, avg=True)`` adds each step's
gradients into a float32 ``gm_acc`` slot beside the inner optimizer's
slots and applies the inner optimizer every ``k_steps``-th step to the
sum (the mean with ``avg``); a micro-step counter lives under the
pseudo-parameter ``"__gradient_merge__"`` of the ``{"count", "slots"}``
state, as in the JAX package, so ``state_dict`` / ``Model.save`` keep
their layout.  A SelectedRows gradient is refused (the JAX rule cannot add
one to its accumulator either).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..framework.errors import InvalidArgumentError
from ..framework.selected_rows import SelectedRows
from .optimizer import Optimizer

__all__ = ["GradientMergeOptimizer"]

_GM_KEY = "__gradient_merge__"


class GradientMergeOptimizer(Optimizer):
    def __init__(self, inner: Optimizer, k_steps: int = 1, avg: bool = True):
        if k_steps < 1:
            raise InvalidArgumentError(f"k_steps must be >= 1, got {k_steps}")
        self._inner = inner
        self._k = int(k_steps)
        self._avg = bool(avg)
        super().__init__(inner._learning_rate, inner._params, None, None,
                         inner._name, inner._multi_precision)

    def get_lr(self):
        return self._inner.get_lr()

    def set_lr(self, value):
        self._inner.set_lr(value)

    @property
    def lr_scheduler(self):
        return self._inner.lr_scheduler

    @property
    def k_steps(self):
        return self._k

    def init(self, params) -> Dict[str, Any]:
        state = self._inner.init(params)
        slots = {name: {**state["slots"][name],
                        "gm_acc": torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)}
                 for name, p in params.items()}
        slots[_GM_KEY] = {"step": torch.zeros((), dtype=torch.int32)}
        return {"count": state["count"], "slots": slots}

    def _host_step(self, state, lr, plan):
        step = state["slots"][_GM_KEY]["step"]  # a host tensor
        step += 1
        # the apply step is a branch of the plan: a captured graph holds it
        if plan.branch(self, int(step) % self._k == 0):
            inner = {"count": state["count"]}
            self._inner._host_step(inner, lr, plan)
            state["count"] = inner["count"]

    def _run(self, grads, state, params, plan):
        slots = state["slots"]
        stepped = [n for n in params if grads.get(n) is not None]
        with torch.no_grad():
            for name in stepped:
                g = grads[name]
                if isinstance(g, SelectedRows):
                    raise InvalidArgumentError(
                        f"GradientMergeOptimizer: {name} has a SelectedRows "
                        f"gradient (Embedding(sparse=True)); accumulate "
                        f"dense gradients (sparse=False)")
                slots[name]["gm_acc"].add_(g.float())
        if not plan.taken(self):
            return
        scale = 1.0 / self._k if self._avg else 1.0
        # the parameters with a gradient this step, as the JAX rule
        merged = {n: slots[n]["gm_acc"] * scale for n in stepped}
        inner = {"count": state["count"],
                 "slots": {n: {s: v for s, v in slots[n].items()
                               if s != "gm_acc"} for n in params}}
        self._inner._run(merged, inner, params, plan)
        for n in params:
            slots[n]["gm_acc"].zero_()

    def __repr__(self):
        return (f"GradientMergeOptimizer(k_steps={self._k}, "
                f"inner={self._inner!r})")
