"""Deterministic fault injection — named fault points driven by a plan
(port of ``paddle_tpu.resilience.faults``).

Recovery code that is never exercised is broken code.  The serving loop
calls :func:`fault_point` at its device-dispatch seam
(``"serving.decode"``); a :class:`FaultPlan` decides, deterministically,
which calls fail and how::

    plan = FaultPlan.parse("site=serving.decode,nth=1")
    with plan:
        engine.generate(prompt, 8)   # first dispatch raises, loop restarts
    plan.stats()                     # {'serving.decode': {'calls': .., 'fired': 1}}

With no plan installed (the default) :func:`fault_point` is a single
module-global falsy check.  ``nth``/``every`` fire on exact per-site call
counts; ``p`` rules draw from a rule-owned ``random.Random(seed)``, so the
same seed and call sequence reproduce the same firing pattern.  The JAX
package's ``latency_ms`` rules and ``FLAGS_fault_plan`` are not ported yet.
"""
from __future__ import annotations

import builtins
import threading
from random import Random
from typing import Dict, List, Optional

from ..framework import errors as _errors
from ..framework.errors import InvalidArgumentError

__all__ = ["FaultRule", "FaultPlan", "fault_point", "install", "remove"]

#: the one installed plan; ``None`` keeps fault_point on its no-op path
_plan: Optional["FaultPlan"] = None


def fault_point(site: str) -> None:
    """Hook on the failure-injection seams: no-op unless an installed
    :class:`FaultPlan` has a rule for ``site``."""
    plan = _plan
    if plan is None:
        return
    plan._hit(site)


def install(plan: "FaultPlan") -> "FaultPlan":
    """Make ``plan`` the process-wide fault plan (replacing any other)."""
    global _plan
    _plan = plan
    return plan


def remove() -> None:
    global _plan
    _plan = None


def _resolve_error(name: str):
    cls = getattr(_errors, name, None) or getattr(builtins, name, None)
    if cls is None or not (isinstance(cls, type)
                           and issubclass(cls, BaseException)):
        raise InvalidArgumentError(
            f"fault plan error class {name!r} is not an exception in "
            f"framework.errors or builtins")
    return cls


class FaultRule:
    """One firing rule for one site.  Exactly one trigger: ``nth`` (fire
    on the Nth call, once), ``every`` (every Nth call) or ``p`` + ``seed``
    (seeded per-call probability).  ``times`` caps total fires.  Firing
    raises ``error`` (a class name from ``framework.errors`` or
    builtins)."""

    def __init__(self, site: str, *, nth: Optional[int] = None,
                 every: Optional[int] = None, p: Optional[float] = None,
                 seed: int = 0, times: Optional[int] = None,
                 error: str = "TransientDeviceError"):
        if not site:
            raise InvalidArgumentError("fault rule needs a site=")
        triggers = sum(x is not None for x in (nth, every, p))
        if triggers != 1:
            raise InvalidArgumentError(
                f"fault rule for {site!r} needs exactly one of nth=, "
                f"every=, p= (got {triggers})")
        if p is not None and not 0.0 <= p <= 1.0:
            raise InvalidArgumentError(f"p must be in [0, 1], got {p}")
        self.site = site
        self.nth = int(nth) if nth is not None else None
        self.every = int(every) if every is not None else None
        self.p = float(p) if p is not None else None
        self.times = int(times) if times is not None else None
        self.error_cls = _resolve_error(error)
        self._rng = Random(int(seed))
        self.fired = 0

    def should_fire(self, call_index: int) -> bool:
        """``call_index`` is 1-based per site.  Probabilistic rules draw
        exactly one variate per call, fire or not."""
        if self.p is not None:
            draw = self._rng.random() < self.p
        elif self.nth is not None:
            draw = call_index == self.nth
        else:
            draw = call_index % self.every == 0
        return draw and (self.times is None or self.fired < self.times)

    def fire(self, call_index: int) -> None:
        self.fired += 1
        raise self.error_cls(
            f"injected fault at {self.site!r} (call {call_index}, "
            f"fire {self.fired})")


class FaultPlan:
    """A set of :class:`FaultRule`\\ s plus per-site call counters; the
    decision happens under one lock, the action (sleep/raise) outside."""

    def __init__(self, rules: List[FaultRule]):
        self.rules = list(rules)
        self._by_site: Dict[str, List[FaultRule]] = {}
        for r in self.rules:
            self._by_site.setdefault(r.site, []).append(r)
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse ``site=..,nth=..;site=..,p=..,seed=..`` rule lists."""
        rules = []
        for chunk in spec.split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            kw: Dict[str, str] = {}
            for field in chunk.split(","):
                if "=" not in field:
                    raise InvalidArgumentError(
                        f"fault plan field {field!r} is not key=value "
                        f"(in {chunk!r})")
                k, v = field.split("=", 1)
                kw[k.strip()] = v.strip()
            site = kw.pop("site", "")
            num = {k: float(v) if k == "p" else int(v)
                   for k, v in kw.items() if k != "error"}
            if "error" in kw:
                num["error"] = kw["error"]
            rules.append(FaultRule(site, **num))
        if not rules:
            raise InvalidArgumentError(
                f"fault plan {spec!r} contains no rules")
        return cls(rules)

    def _hit(self, site: str) -> None:
        with self._lock:
            rules = self._by_site.get(site)
            if rules is None:
                return
            self._calls[site] = idx = self._calls.get(site, 0) + 1
            to_fire = [r for r in rules if r.should_fire(idx)]
        for r in to_fire:
            r.fire(idx)

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {site: {"calls": self._calls.get(site, 0),
                           "fired": sum(r.fired for r in rules)}
                    for site, rules in self._by_site.items()}

    def __enter__(self) -> "FaultPlan":
        return install(self)

    def __exit__(self, *exc) -> None:
        if _plan is self:
            remove()
