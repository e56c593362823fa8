"""Deadline-aware retry with exponential backoff and seeded jitter (port
of ``paddle_tpu.resilience.retry``).

:class:`RetryPolicy` is the framework's one retry primitive; its defaults
come from ``FLAGS_transient_max_retries`` / ``FLAGS_retry_backoff_ms``.
:func:`mark_warm` is called by a serving engine after ``warmup()``: from
then on, circuit re-opens count as hot-path flaps
(``CircuitBreaker`` ``opens_after_warm``).
"""
from __future__ import annotations

import time
from random import Random
from typing import Callable, Optional

from ..framework.errors import InvalidArgumentError, is_transient
from ..framework.flags import flag

__all__ = ["RetryPolicy", "mark_warm", "is_warm"]

_warm = False


def mark_warm() -> None:
    """Serving engines call this after ``warmup()``."""
    global _warm
    _warm = True


def is_warm() -> bool:
    return _warm


class RetryPolicy:
    """Bounded retry of transient failures (:func:`errors.is_transient`).

    ``max_attempts`` total calls (1 = no retry); between attempts sleeps
    ``backoff_ms * multiplier**i`` capped at ``max_backoff_ms``, scaled by
    a jitter factor in ``[1-jitter, 1+jitter]`` from a policy-owned
    ``random.Random(seed)``.  ``deadline_ms`` bounds the whole call
    including backoff: a retry whose sleep would cross it is abandoned and
    the last error raised.  ``sleep``/``clock`` are injectable for tests.
    """

    def __init__(self, max_attempts: Optional[int] = None,
                 backoff_ms: Optional[float] = None, multiplier: float = 2.0,
                 max_backoff_ms: Optional[float] = None, jitter: float = 0.25,
                 seed: int = 0, deadline_ms: Optional[float] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "retry"):
        self.max_attempts = int(max_attempts if max_attempts is not None
                                else flag("transient_max_retries"))
        if self.max_attempts < 1:
            raise InvalidArgumentError("max_attempts must be >= 1")
        self.backoff_ms = float(backoff_ms if backoff_ms is not None
                                else flag("retry_backoff_ms"))
        self.multiplier = float(multiplier)
        self.max_backoff_ms = float(max_backoff_ms if max_backoff_ms
                                    is not None else 20 * self.backoff_ms)
        if not 0.0 <= jitter < 1.0:
            raise InvalidArgumentError("jitter must be in [0, 1)")
        self.jitter = float(jitter)
        self.deadline_ms = (float(deadline_ms) if deadline_ms is not None
                            else None)
        self._sleep = sleep
        self._clock = clock
        self._rng = Random(int(seed))
        self.name = name

    @classmethod
    def from_flags(cls, name: str = "retry", **overrides) -> "RetryPolicy":
        """The flag-configured default policy (the legacy serving
        scheduler's runner retries through one)."""
        return cls(name=name, **overrides)

    def delay_s(self, retry_index: int) -> float:
        """Backoff before the ``retry_index``-th retry (0-based), in
        seconds, consuming one jitter draw."""
        base = min(self.backoff_ms * self.multiplier ** retry_index,
                   self.max_backoff_ms)
        factor = 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return base * factor / 1e3

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying transient failures; raises
        the last error when attempts, the deadline or the classifier say
        stop."""
        return self._call(self.deadline_ms, fn, args, kwargs)

    def call_deadline(self, deadline_ms: Optional[float], fn: Callable,
                      *args, **kwargs):
        """:meth:`call` bounded also by a caller's latency budget (the
        tightest request deadline of a serving batch): the tighter of
        ``deadline_ms`` and the policy's own deadline holds."""
        if deadline_ms is None:
            effective = self.deadline_ms
        elif self.deadline_ms is None:
            effective = float(deadline_ms)
        else:
            effective = min(float(deadline_ms), self.deadline_ms)
        return self._call(effective, fn, args, kwargs)

    def _call(self, deadline_ms: Optional[float], fn: Callable, args,
              kwargs):
        deadline = (self._clock() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                if not is_transient(e) or attempt >= self.max_attempts:
                    raise
                delay = self.delay_s(attempt - 1)
                if deadline is not None and self._clock() + delay > deadline:
                    raise
                self._sleep(delay)
