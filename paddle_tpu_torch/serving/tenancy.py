"""Multi-tenant admission control for the continuous-batching engine
(port of ``paddle_tpu.serving.tenancy``; host-only, a copy of the JAX
module's logic).

:class:`TenantScheduler` sits in front of the paged decode loop's
admission pass (``GenerationEngine(tenancy=...)``) and answers one
question per step: of the requests waiting right now, which may enter
free slots, and in what order?  Two mechanisms compose:

* **weighted-fair ordering** — stride scheduling over tenants: each
  tenant carries a pass value advanced by ``stride = K / weight`` per
  admitted token of work, and the waiting tenant with the smallest pass
  goes first.  A tenant with weight 2 gets twice the admission
  throughput of a weight-1 tenant under contention, yet an idle
  tenant's pass is re-synced on arrival so it cannot hoard credit.
* **token budgets** — an optional per-tenant bucket (capacity +
  optional refill rate).  An empty bucket defers the tenant's waiting
  requests (throttling, not starvation) and preempts its live slots
  through the deterministic paged preemption path, so a flooding tenant
  is capped at its budget while greedy decode regenerates its evicted
  work bit-identically later.

Per-tenant SLO objectives (:meth:`TenantScheduler.slo_objectives`) need
the observability slice's ``Objective`` and raise until it is ported
(ROADMAP queue A, item 7).  Nothing here touches the device.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

from ..framework.errors import InvalidArgumentError, UnimplementedError
from ..framework.locking import OrderedLock

__all__ = ["TenantSpec", "TenantScheduler"]

#: stride constant (the classic 2^20-ish "big K"; exact value is
#: irrelevant — only stride ratios matter)
_STRIDE_K = float(1 << 20)


class TenantSpec(NamedTuple):
    """One tenant's contract.

    ``weight`` scales the tenant's share of admission throughput under
    contention.  ``token_budget`` caps generated tokens (``None`` =
    unlimited); ``refill_per_s`` optionally refills the bucket (``None``
    = a hard one-shot budget, the smoke gate's flooder cap).
    ``adapter_id`` is the LoRA table slot requests default to (``-1`` =
    base model).  ``slo_ms`` optionally declares a p99 latency SLO (kept
    for the JAX signature; :meth:`TenantScheduler.slo_objectives` is not
    ported yet)."""

    name: str
    weight: float = 1.0
    token_budget: Optional[int] = None
    refill_per_s: Optional[float] = None
    adapter_id: int = -1
    slo_ms: Optional[float] = None


class _TenantState:
    __slots__ = ("spec", "pass_v", "level", "last_refill", "admitted",
                 "charged", "starved_steps", "preempted")

    def __init__(self, spec: TenantSpec, pass_v: float):
        self.spec = spec
        self.pass_v = pass_v
        self.level = (float(spec.token_budget)
                      if spec.token_budget is not None else None)
        self.last_refill = time.monotonic()
        self.admitted = 0
        self.charged = 0
        self.starved_steps = 0
        self.preempted = 0


class TenantScheduler:
    """Weighted-fair, budget-enforcing admission order over tenants."""

    def __init__(self, tenants: Sequence[TenantSpec] = ()):
        self._lock = OrderedLock("TenantScheduler._lock")
        self._tenants: Dict[str, _TenantState] = {}
        for spec in tenants:
            self.register(spec)

    # -- registry ------------------------------------------------------------
    def register(self, spec: TenantSpec) -> None:
        """Add (or replace) a tenant.  A new tenant starts at the
        current minimum pass so it competes fairly from its first
        request instead of draining accumulated credit."""
        if isinstance(spec, str):
            spec = TenantSpec(spec)
        if not spec.name:
            raise InvalidArgumentError("tenant name must be non-empty")
        if spec.weight <= 0:
            raise InvalidArgumentError(
                f"tenant {spec.name!r}: weight must be > 0, got "
                f"{spec.weight}")
        if spec.token_budget is not None and spec.token_budget < 1:
            raise InvalidArgumentError(
                f"tenant {spec.name!r}: token_budget must be >= 1, got "
                f"{spec.token_budget}")
        with self._lock:
            base = min((t.pass_v for t in self._tenants.values()),
                       default=0.0)
            self._tenants[spec.name] = _TenantState(spec, base)

    def spec(self, tenant: str) -> TenantSpec:
        with self._lock:
            return self._state(tenant).spec

    def adapter_id(self, tenant: str) -> int:
        """The LoRA table slot ``tenant``'s requests default to."""
        with self._lock:
            return int(self._state(tenant).spec.adapter_id)

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            raise InvalidArgumentError(
                f"unknown tenant {tenant!r} — register a TenantSpec first")
        return st

    # -- budgets -------------------------------------------------------------
    def _refill_locked(self, st: _TenantState) -> None:
        now = time.monotonic()
        if (st.level is not None and st.spec.refill_per_s
                and st.spec.token_budget is not None):
            st.level = min(
                st.level + (now - st.last_refill) * st.spec.refill_per_s,
                float(st.spec.token_budget))
        st.last_refill = now

    def charge(self, tenant: str, tokens: int) -> None:
        """Debit ``tokens`` generated tokens from the tenant's bucket
        and advance its stride pass (cost-proportional fairness)."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return
            self._refill_locked(st)
            st.charged += int(tokens)
            if st.level is not None:
                st.level -= float(tokens)
            st.pass_v += (_STRIDE_K / st.spec.weight) * float(tokens)

    def is_throttled(self, tenant: Optional[str]) -> bool:
        """True when the tenant's bucket is empty (its waiting requests
        defer and its live slots are preemption candidates).  Unknown or
        untagged tenants are never throttled."""
        if tenant is None:
            return False
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None or st.level is None:
                return False
            self._refill_locked(st)
            return st.level <= 0.0

    def over_budget(self) -> List[str]:
        """Tenants whose bucket is currently empty."""
        out = []
        with self._lock:
            for name, st in self._tenants.items():
                if st.level is None:
                    continue
                self._refill_locked(st)
                if st.level <= 0.0:
                    out.append(name)
        return out

    # -- admission ordering --------------------------------------------------
    def schedule(self, items: List, *,
                 tenant_of: Callable[[object], Optional[str]],
                 cost_of: Optional[Callable[[object], int]] = None
                 ) -> Tuple[List, List]:
        """Order the waiting ``items`` for admission.

        Returns ``(admissible, deferred)``: ``admissible`` holds every
        item whose tenant is in budget (plus all untagged items),
        interleaved by stride order — repeatedly pick the in-budget
        tenant with the smallest pass value (ties break by name for
        determinism), emit its OLDEST waiting item, and advance its
        pass by ``stride * cost``.  Per-tenant FIFO is preserved by
        construction; ``deferred`` holds the over-budget tenants'
        items in their original order.  The pass advances made here are
        provisional ordering pressure — the real cost lands via
        :meth:`charge` as tokens are generated — and use the declared
        ``cost_of`` (the request's token budget) so one big request
        does not out-compete many small ones."""
        if not items:
            return [], []
        with self._lock:
            queues: Dict[Optional[str], List] = {}
            order: List[Optional[str]] = []
            for it in items:
                tn = tenant_of(it)
                if tn is not None and tn not in self._tenants:
                    tn = None  # untagged: FCFS ahead of the stride pick
                if tn not in queues:
                    queues[tn] = []
                    order.append(tn)
                queues[tn].append(it)
            deferred: List = []
            for tn in list(order):
                if tn is None:
                    continue
                st = self._tenants[tn]
                if st.level is not None:
                    self._refill_locked(st)
                    if st.level <= 0.0:
                        deferred.extend(queues.pop(tn))
                        order.remove(tn)
            admissible: List = list(queues.pop(None, []))
            # re-sync an idle tenant's pass so absence never banks credit
            active = [tn for tn in order if tn is not None]
            if active:
                base = min(self._tenants[tn].pass_v for tn in active)
                for tn in active:
                    st = self._tenants[tn]
                    if not queues[tn]:
                        continue
                    st.pass_v = max(st.pass_v, base)
            while active:
                tn = min(active,
                         key=lambda t: (self._tenants[t].pass_v, t))
                st = self._tenants[tn]
                it = queues[tn].pop(0)
                cost = max(int(cost_of(it)) if cost_of is not None else 1, 1)
                st.pass_v += (_STRIDE_K / st.spec.weight) * float(cost)
                admissible.append(it)
                if not queues[tn]:
                    active.remove(tn)
            return admissible, deferred

    # -- engine feedback -----------------------------------------------------
    def note_admitted(self, tenant: Optional[str]) -> None:
        if tenant is None:
            return
        with self._lock:
            st = self._tenants.get(tenant)
            if st is not None:
                st.admitted += 1

    def note_starved(self, tenant: Optional[str]) -> None:
        """One post-warmup step in which this IN-budget tenant waited
        with free slots available (the JAX package's rule S607 reads it)."""
        if tenant is None:
            return
        with self._lock:
            st = self._tenants.get(tenant)
            if st is not None:
                st.starved_steps += 1

    def note_preempted(self, tenant: Optional[str], n: int = 1) -> None:
        if tenant is None:
            return
        with self._lock:
            st = self._tenants.get(tenant)
            if st is not None:
                st.preempted += int(n)

    # -- observability -------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant state (the JAX engine publishes it with per-tenant
        queue depths on its event bus, which the port does not have yet)."""
        out: Dict[str, dict] = {}
        with self._lock:
            for name, st in self._tenants.items():
                if st.level is not None:
                    self._refill_locked(st)
                out[name] = {
                    "weight": st.spec.weight,
                    "admitted": st.admitted,
                    "tokens": st.charged,
                    "budget_level": (float(st.level)
                                     if st.level is not None else None),
                    "over_budget": bool(st.level is not None
                                        and st.level <= 0.0),
                    "starved_after_warm": st.starved_steps,
                    "preempted": st.preempted,
                    "adapter_id": st.spec.adapter_id,
                }
        return out

    def slo_objectives(self, engine: str) -> list:
        """One latency ``Objective`` per tenant that declared ``slo_ms``,
        in the JAX package, against the ``(engine, tenant)``-labeled tenant
        histogram.  Both live in the observability slice, which the port
        does not have yet: raises ``UnimplementedError``."""
        raise UnimplementedError(
            "TenantScheduler.slo_objectives needs observability.slo."
            "Objective and the tenant latency histogram, not ported yet "
            "(ROADMAP queue A, item 7: control plane and operations)")
