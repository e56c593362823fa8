"""Per-key circuit breaker for the serving layer (port of
``paddle_tpu.resilience.circuit``).

After the failure rate over a sliding window crosses a threshold, a key's
circuit OPENS and work for it is deferred; after a cool-down it goes
HALF_OPEN and admits a limited number of probes — all succeeding closes
it, any failing re-opens it::

    CLOSED --(failure rate >= threshold over full window)--> OPEN
    OPEN   --(cooldown elapsed)--> HALF_OPEN
    HALF_OPEN --(all probes succeed)--> CLOSED
    HALF_OPEN --(any probe fails)--> OPEN
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ..framework.errors import InvalidArgumentError
from ..framework.flags import flag
from .retry import is_warm

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _KeyState:
    __slots__ = ("state", "outcomes", "opened_at", "probes_left",
                 "probe_successes", "opens", "opens_after_warm", "sheds",
                 "failures", "successes")

    def __init__(self, window: int):
        self.state = CLOSED
        self.outcomes: deque = deque(maxlen=window)  # True = success
        self.opened_at = 0.0
        self.probes_left = 0
        self.probe_successes = 0
        self.opens = 0
        self.opens_after_warm = 0
        self.sheds = 0
        self.failures = 0
        self.successes = 0


class CircuitBreaker:
    """Failure-rate circuit breaker over hashable keys (the paged engine
    uses the single key 0).  Call :meth:`allow` before the work; report
    the outcome with :meth:`record_success` / :meth:`record_failure`.
    Thread-safe; defaults come from the ``FLAGS_circuit_*`` flags."""

    def __init__(self, name: str = "circuit", *,
                 failure_threshold: Optional[float] = None,
                 window: Optional[int] = None,
                 cooldown_ms: Optional[float] = None,
                 half_open_probes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = float(
            failure_threshold if failure_threshold is not None
            else flag("circuit_failure_threshold"))
        if not 0.0 < self.failure_threshold <= 1.0:
            raise InvalidArgumentError(
                "circuit failure_threshold must be in (0, 1]")
        self.window = int(window if window is not None
                          else flag("circuit_window"))
        if self.window < 1:
            raise InvalidArgumentError("circuit window must be >= 1")
        self.cooldown_s = float(cooldown_ms if cooldown_ms is not None
                                else flag("circuit_cooldown_ms")) / 1e3
        self.half_open_probes = int(
            half_open_probes if half_open_probes is not None
            else flag("circuit_half_open_probes"))
        if self.half_open_probes < 1:
            raise InvalidArgumentError("half_open_probes must be >= 1")
        self._clock = clock
        self._lock = threading.Lock()
        self._keys: Dict[object, _KeyState] = {}

    def _key(self, key) -> _KeyState:
        ks = self._keys.get(key)
        if ks is None:
            ks = self._keys[key] = _KeyState(self.window)
        return ks

    def allow(self, key) -> bool:
        """May work for ``key`` proceed?  An OPEN circuit whose cooldown
        has elapsed turns HALF_OPEN here and admits probes."""
        with self._lock:
            ks = self._key(key)
            if ks.state == CLOSED:
                return True
            if ks.state == OPEN:
                if self._clock() - ks.opened_at < self.cooldown_s:
                    ks.sheds += 1
                    return False
                ks.state = HALF_OPEN
                ks.probes_left = self.half_open_probes
                ks.probe_successes = 0
            if ks.probes_left > 0:
                ks.probes_left -= 1
                return True
            ks.sheds += 1
            return False

    def record_success(self, key) -> None:
        with self._lock:
            ks = self._key(key)
            ks.successes += 1
            if ks.state == HALF_OPEN:
                ks.probe_successes += 1
                if ks.probe_successes >= self.half_open_probes:
                    ks.state = CLOSED
                    ks.outcomes.clear()
                return
            if ks.state == CLOSED:
                ks.outcomes.append(True)

    def record_failure(self, key) -> None:
        with self._lock:
            ks = self._key(key)
            ks.failures += 1
            if ks.state == HALF_OPEN:
                self._open(ks)  # a failed probe re-opens immediately
                return
            if ks.state != CLOSED:
                return
            ks.outcomes.append(False)
            if len(ks.outcomes) < self.window:
                return  # never judge a partial window
            if ks.outcomes.count(False) / len(ks.outcomes) >= \
                    self.failure_threshold:
                self._open(ks)

    def _open(self, ks: _KeyState) -> None:
        ks.state = OPEN
        ks.opened_at = self._clock()
        ks.opens += 1
        if is_warm():
            ks.opens_after_warm += 1
        ks.outcomes.clear()

    def state(self, key) -> str:
        with self._lock:
            ks = self._keys.get(key)
            return ks.state if ks is not None else CLOSED

    def stats(self) -> dict:
        """Aggregate + per-key counters (keys stringified)."""
        with self._lock:
            per_key = {
                str(k): {"state": ks.state, "opens": ks.opens,
                         "opens_after_warm": ks.opens_after_warm,
                         "sheds": ks.sheds, "failures": ks.failures,
                         "successes": ks.successes}
                for k, ks in self._keys.items()}
        agg = {f: sum(d[f] for d in per_key.values())
               for f in ("opens", "opens_after_warm", "sheds", "failures",
                         "successes")}
        agg["open_keys"] = sum(1 for d in per_key.values()
                               if d["state"] != CLOSED)
        agg["keys"] = per_key
        return agg
