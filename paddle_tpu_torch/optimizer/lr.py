"""Learning-rate schedulers (port of ``paddle_tpu.optimizer.lr``).

Parity: paddle.optimizer.lr (reference: python/paddle/optimizer/lr.py —
LRScheduler base + NoamDecay/PiecewiseDecay/.../ReduceOnPlateau).

All host-side arithmetic: ``sched.step()`` advances the schedule,
``sched.get_lr()`` (or ``sched()``, ``sched.last_lr``) reads it, and the
bound optimizer reads ``last_lr`` as a Python float each step.  The JAX
package's in-graph ``value_at(step)`` has no counterpart: PyTorch runs
eagerly, so nothing is traced.
"""
from __future__ import annotations

import bisect
import math
from typing import Callable, Optional, Sequence

__all__ = [
    "LRScheduler",
    "NoamDecay",
    "PiecewiseDecay",
    "NaturalExpDecay",
    "InverseTimeDecay",
    "PolynomialDecay",
    "LinearWarmup",
    "ExponentialDecay",
    "MultiStepDecay",
    "StepDecay",
    "LambdaDecay",
    "ReduceOnPlateau",
    "CosineAnnealingDecay",
]


class LRScheduler:
    """Base class. Subclasses implement ``get_lr()`` from
    ``self.last_epoch``."""

    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1, verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()  # prime to epoch 0, like the reference

    def get_lr(self) -> float:
        raise NotImplementedError

    def __call__(self) -> float:
        return self.last_lr

    def step(self, epoch: Optional[int] = None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = int(epoch)
        self.last_lr = float(self.get_lr())
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    # Persist only the schedule *position* (paddle parity: lr.py keeps
    # last_epoch/last_lr) — hyperparameters belong to the constructor, so a
    # checkpoint never silently reverts a re-configured schedule.

    _state_keys = ("last_epoch", "last_lr")

    def state_dict(self):
        return {k: self.__dict__[k] for k in self._state_keys if k in self.__dict__}

    def set_state_dict(self, state):
        for k in self._state_keys:
            if k in state:
                self.__dict__[k] = state[k]

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    """lr = lr0 * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LRScheduler):

    def __init__(self, boundaries: Sequence[int], values: Sequence[float], last_epoch=-1, verbose=False):
        assert len(values) == len(boundaries) + 1
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        return self.values[bisect.bisect_right(self.boundaries, self.last_epoch)]


class NaturalExpDecay(LRScheduler):

    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):

    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):

    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * max(div, 1)
        else:
            step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    """Linear ramp to warm lr, then delegate to an inner scheduler/float."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1, verbose=False):
        self.inner = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = end_lr if isinstance(learning_rate, (int, float)) else learning_rate.base_lr
        super().__init__(float(base), last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / self.warmup_steps + self.start_lr
        if isinstance(self.inner, LRScheduler):
            return self.inner.last_lr
        return float(self.inner)

    def step(self, epoch=None):
        if isinstance(self.inner, LRScheduler) and self.last_epoch >= self.warmup_steps:
            self.inner.step(epoch)
        super().step(epoch)

    def state_dict(self):
        d = super().state_dict()
        if isinstance(self.inner, LRScheduler):
            d["inner"] = self.inner.state_dict()
        return d

    def set_state_dict(self, state):
        state = dict(state)
        inner = state.pop("inner", None)
        super().set_state_dict(state)
        if inner is not None and isinstance(self.inner, LRScheduler):
            self.inner.set_state_dict(inner)


class ExponentialDecay(LRScheduler):

    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):

    def __init__(self, learning_rate, milestones: Sequence[int], gamma=0.1, last_epoch=-1, verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = bisect.bisect_right(self.milestones, self.last_epoch)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):

    def __init__(self, learning_rate, step_size: int, gamma=0.1, last_epoch=-1, verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):

    def __init__(self, learning_rate, lr_lambda: Callable[[int], float], last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        d = super().state_dict()
        d.pop("lr_lambda", None)
        return d


class CosineAnnealingDecay(LRScheduler):

    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (
            self.eta_min
            + (self.base_lr - self.eta_min)
            * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
        )


class ReduceOnPlateau(LRScheduler):
    """Shrink lr when a monitored metric stops improving (eager-only —
    inherently data-dependent)."""

    _state_keys = (
        "last_epoch", "last_lr", "best", "num_bad_epochs", "cooldown_counter"
    )

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        assert mode in ("min", "max") and threshold_mode in ("rel", "abs")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.cooldown_counter = 0
        self.best = None
        self.num_bad_epochs = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def _better(self, a, b):
        if b is None:
            return True
        if self.mode == "min":
            thr = b * (1 - self.threshold) if self.threshold_mode == "rel" else b - self.threshold
            return a < thr
        thr = b * (1 + self.threshold) if self.threshold_mode == "rel" else b + self.threshold
        return a > thr

    def step(self, metrics=None, epoch=None):
        if metrics is None:  # priming call from base ctor semantics
            return
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        m = float(metrics)
        if self._better(m, self.best):
            self.best = m
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
                if self.verbose:
                    print(f"Epoch {self.last_epoch}: reducing lr to {new_lr}")
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
