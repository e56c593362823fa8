"""Serving counters, gauges and latency quantiles (port of
``paddle_tpu.serving.metrics``).

Every engine owns a :class:`ServingMetrics`; :meth:`~ServingMetrics.snapshot`
is what ``GenerationEngine.stats()`` returns.  Snapshot keys:
``requests, completed, shed, expired, errors, bucket_misses, batches,
tokens, queue_depth, batch_occupancy, mean_ms, p50_ms, p99_ms, queue_p50_ms,
queue_p99_ms, execute_p50_ms, execute_p99_ms, tokens_per_s`` plus the
slot-scheduler family (``SLOT_COUNTERS``), the page-accounting family
(``PAGED_COUNTERS``) and the gauges the decode loop sets
(``slot_occupancy``, ``slots_free``, ``queue_age_ms``, ``decode_step_ms``,
``kv_pages_free``, ``kv_pages_shared``, ``kv_pages_leaked``).  Engines
serving MoE models (``GPTConfig.moe_experts > 0``) add the expert-routing
family (``MOE_COUNTERS`` + the ``moe_overflow_frac`` /
``moe_dead_experts`` gauges); a dense engine publishes no ``moe_*`` key.
Paged engines add the hand-off family (``HANDOFF_COUNTERS``), and every
engine counts ``weight_swaps`` (``swap_weights`` / ``reload_weights``).
The worker-mode batcher (legacy scheduler) records each batch through
:meth:`~ServingMetrics.observe_batch` and counts ``circuit_shed``.
Engines over a LoRA model add ``LORA_COUNTERS``, engines with a
``TenantScheduler`` ``TENANCY_COUNTERS``.
Publishing snapshots on an event bus and the Prometheus bridge come with
the observability slice.
"""
from __future__ import annotations

import collections
import math
from typing import Deque, Dict, Sequence

from ..framework.locking import OrderedLock

__all__ = ["ServingMetrics", "SLOT_COUNTERS", "PAGED_COUNTERS",
           "HANDOFF_COUNTERS", "MOE_COUNTERS", "LORA_COUNTERS",
           "TENANCY_COUNTERS"]

#: counter keys every snapshot carries (zero-initialized)
_COUNTERS = ("requests", "completed", "shed", "expired", "errors",
             "bucket_misses", "batches", "tokens", "circuit_shed",
             "drain_timeout", "weight_swaps")

#: slot-scheduler counters (continuous batching; see ``extra_counters``)
SLOT_COUNTERS = ("admitted", "evicted", "decode_steps", "restarts",
                 "starved_steps", "starved_steps_after_warm")

#: page-accounting counters (paged KV mode; see ``extra_counters``)
PAGED_COUNTERS = ("cow_copies", "spec_drafted", "spec_accepted",
                  "preempted")

#: prefill/decode hand-off counters (paged KV mode): hand-offs a
#: prefill-role engine exported (``handoffs_out``) and a decode-role engine
#: adopted (``handoffs_in``)
HANDOFF_COUNTERS = ("handoffs_out", "handoffs_in")

#: expert-routing counters (MoE models; see ``extra_counters``): routed /
#: capacity-dropped token totals plus post-warmup sampled / overflow step
#: counts.  With the ``moe_overflow_frac`` and ``moe_dead_experts`` gauges
#: they are the signal of sustained expert overflow or of experts that
#: never receive a token (the JAX package's rule S606 reads them).
MOE_COUNTERS = ("moe_routed_tokens", "moe_dropped_tokens",
                "moe_sampled_steps_after_warm",
                "moe_overflow_steps_after_warm")

#: batched multi-LoRA counters (``GPTConfig.lora_capacity > 0``): adapter
#: table hot edits through ``install_adapter`` / ``remove_adapter``
LORA_COUNTERS = ("adapter_installs", "adapter_removals")

#: multi-tenant scheduler counters (``GenerationEngine(tenancy=...)``):
#: slots preempted because their tenant ran over its token budget
#: (``tenant_preempted``), steps where every waiting request belonged to an
#: over-budget tenant (``tenant_throttled_steps`` — throttling by design,
#: kept apart from starvation), and post-warmup steps where an IN-budget
#: tenant waited with slots free (``tenant_starved_steps_after_warm``, the
#: JAX package's rule S607 signal)
TENANCY_COUNTERS = ("tenant_preempted", "tenant_throttled_steps",
                    "tenant_starved_steps_after_warm")


def _quantile(sorted_vals, q: float) -> float:
    """Nearest-rank quantile, ceil rank convention (element
    ``ceil(q*n)``, 1-based)."""
    n = len(sorted_vals)
    if not n:
        return 0.0
    i = min(max(math.ceil(q * n) - 1, 0), n - 1)
    return float(sorted_vals[i])


class ServingMetrics:
    """Thread-safe counters, gauges, and a bounded latency reservoir."""

    def __init__(self, name: str = "serving#0", window: int = 512,
                 extra_counters: Sequence[str] = ()):
        self.name = name
        self._lock = OrderedLock("ServingMetrics._lock")
        self._counters: Dict[str, int] = {
            k: 0 for k in (*_COUNTERS, *extra_counters)}
        self._latency_ms: Deque[float] = collections.deque(maxlen=window)
        self._occupancy: Deque[float] = collections.deque(maxlen=window)
        self._queue_ms: Deque[float] = collections.deque(maxlen=window)
        self._execute_ms: Deque[float] = collections.deque(maxlen=window)
        self._queue_depth = 0
        self._token_time_s = 0.0
        self._gauges: Dict[str, float] = {}

    def incr(self, key: str, n: int = 1):
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def set_counter(self, key: str, value: int):
        with self._lock:
            self._counters[key] = int(value)

    def set_queue_depth(self, depth: int):
        with self._lock:
            self._queue_depth = int(depth)

    def set_gauge(self, key: str, value: float):
        """Latest-value gauge folded into every snapshot."""
        with self._lock:
            self._gauges[key] = float(value)

    def observe_occupancy(self, frac: float):
        """One occupancy sample (0..1) for the ``batch_occupancy`` mean."""
        with self._lock:
            self._occupancy.append(float(frac))

    def observe_batch(self, size: int, capacity: int, queue_depth: int):
        """One batch of the worker-mode batcher: ``size`` requests
        completed in a batch of ``capacity`` rows."""
        with self._lock:
            self._counters["batches"] += 1
            self._counters["completed"] += size
            self._occupancy.append(size / max(capacity, 1))
            self._queue_depth = int(queue_depth)

    def observe_latency_ms(self, ms: float):
        with self._lock:
            self._latency_ms.append(float(ms))

    def observe_tenant(self, tenant: str, ms: float, tokens: int):
        """Per-tenant completion observation.  In the JAX package it feeds
        the ``(engine, tenant)``-labeled latency histogram and token
        counter of the observability registry, behind its label-cardinality
        cap, and does nothing while observability is off.  The port has no
        observability registry yet (ROADMAP queue A, item 7), so it does
        what the JAX method does when observability is off: nothing."""
        return None

    def observe_tokens(self, n: int, seconds: float):
        with self._lock:
            self._counters["tokens"] += int(n)
            self._token_time_s += float(seconds)

    def observe_span(self, queue_ms: float, execute_ms: float):
        """Per-request breakdown: time queued vs time executing."""
        with self._lock:
            self._queue_ms.append(float(queue_ms))
            self._execute_ms.append(float(execute_ms))

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latency_ms)
            occ = list(self._occupancy)
            qms = sorted(self._queue_ms)
            xms = sorted(self._execute_ms)
            snap = dict(self._counters)
            snap.update(self._gauges)
            snap["queue_depth"] = self._queue_depth
            snap["batch_occupancy"] = (sum(occ) / len(occ)) if occ else 0.0
            snap["mean_ms"] = (sum(lat) / len(lat)) if lat else 0.0
            snap["p50_ms"] = _quantile(lat, 0.50)
            snap["p99_ms"] = _quantile(lat, 0.99)
            snap["queue_p50_ms"] = _quantile(qms, 0.50)
            snap["queue_p99_ms"] = _quantile(qms, 0.99)
            snap["execute_p50_ms"] = _quantile(xms, 0.50)
            snap["execute_p99_ms"] = _quantile(xms, 0.99)
            snap["tokens_per_s"] = (snap["tokens"] / self._token_time_s
                                    if self._token_time_s > 0 else 0.0)
        return snap
