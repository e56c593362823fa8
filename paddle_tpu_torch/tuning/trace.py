"""Deterministic request traces for serving-config measured search (a
copy of ``paddle_tpu/tuning/trace.py``; the module is host-only numpy).

A serving dial (bucket set, slot count, batching delay, KV page size,
speculative k) can only be compared fairly when every candidate serves
the IDENTICAL workload: same prompts, same output lengths, same
submission order.  This module is that workload as a value:

* :class:`RequestTrace` — an ordered list of ``(prompt_ids, max_new)``
  requests with a stable content digest (:meth:`RequestTrace.key`) that
  lands in the measured-search cache key, so a tuned winner is bound to
  the trace it was measured on;
* :meth:`RequestTrace.synthetic` — the fixed-seed mixed-length sweep
  ``bench.py`` has always used (RandomState(17), prompts 4..48, outputs
  4..64), reproduced draw-for-draw so benches before and after this
  module see bit-identical requests;
* :class:`TraceRecorder` — capture live submissions (wrap an engine's
  ``submit``) and save them for offline tuning against production
  shapes;
* :func:`replay` — drive one engine through a trace and return the
  throughput/latency numbers the tuner scores.
"""
from __future__ import annotations

import hashlib
import json
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..framework.errors import InvalidArgumentError

__all__ = ["RequestTrace", "TraceRecorder", "replay"]


class RequestTrace:
    """An ordered, immutable-by-convention request workload: each entry
    is ``(prompt_ids: np.int32[L], max_new: int)``."""

    def __init__(self, entries: Sequence[Tuple[np.ndarray, int]], *,
                 name: str = "trace", seed: Optional[int] = None):
        self.entries: List[Tuple[np.ndarray, int]] = [
            (np.asarray(p, dtype=np.int32), int(n)) for p, n in entries]
        self.name = name
        self.seed = seed

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    @property
    def total_new_tokens(self) -> int:
        return sum(n for _, n in self.entries)

    # -- synthesis -----------------------------------------------------------
    @classmethod
    def synthetic(cls, n: int = 48, *, seed: int = 17, vocab: int = 8192,
                  prompt_range: Tuple[int, int] = (4, 49),
                  new_range: Tuple[int, int] = (4, 65)) -> "RequestTrace":
        """The fixed-seed mixed-length sweep: ragged on both axes, the
        spread a run-batch-to-completion scheduler pays head-of-line
        blocking on.  Draw order matches the historical ``bench.py``
        inline generation exactly (lengths first, then output counts,
        then per-request tokens), so default-args output is bit-identical
        to every recorded bench number."""
        rng = np.random.RandomState(seed)
        lens = rng.randint(prompt_range[0], prompt_range[1], size=n)
        news = rng.randint(new_range[0], new_range[1], size=n)
        entries = [(rng.randint(1, vocab, size=int(L)).astype(np.int32),
                    int(m)) for L, m in zip(lens, news)]
        return cls(entries, name=f"synthetic-s{seed}-n{n}", seed=seed)

    # -- identity ------------------------------------------------------------
    def key(self) -> str:
        """Stable content digest for measured-search cache keys: a tuned
        serving config is only a cache hit against the same workload."""
        h = hashlib.sha256()
        for p, n in self.entries:
            h.update(p.tobytes())
            h.update(int(n).to_bytes(4, "little"))
        return f"{self.name}.{h.hexdigest()[:12]}"

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        data = {"version": 1, "name": self.name, "seed": self.seed,
                "requests": [{"prompt": p.tolist(), "max_new": n}
                             for p, n in self.entries]}
        with open(path, "w") as f:
            json.dump(data, f, indent=0)

    @classmethod
    def load(cls, path: str) -> "RequestTrace":
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) or "requests" not in data:
            raise InvalidArgumentError(f"not a request trace: {path}")
        return cls([(np.asarray(r["prompt"], np.int32), int(r["max_new"]))
                    for r in data["requests"]],
                   name=data.get("name", "trace"), seed=data.get("seed"))


class TraceRecorder:
    """Capture live request arrivals for offline tuning: call
    :meth:`record` from the serving front door (or wrap ``submit``),
    then :meth:`trace`/:meth:`save` the workload."""

    def __init__(self, name: str = "recorded", limit: int = 10000):
        self.name = name
        self.limit = int(limit)
        self._entries: List[Tuple[np.ndarray, int]] = []

    def record(self, prompt_ids, max_new: int) -> None:
        if len(self._entries) < self.limit:
            self._entries.append(
                (np.asarray(prompt_ids, np.int32), int(max_new)))

    def wrap(self, submit):
        """``engine.submit = recorder.wrap(engine.submit)`` — record each
        request on its way in, pass through untouched."""

        def wrapped(prompt_ids, max_new, *a, **kw):
            self.record(prompt_ids, max_new)
            return submit(prompt_ids, max_new, *a, **kw)

        return wrapped

    def __len__(self) -> int:
        return len(self._entries)

    def trace(self) -> RequestTrace:
        return RequestTrace(self._entries, name=self.name)

    def save(self, path: str) -> None:
        self.trace().save(path)


def replay(engine, trace: RequestTrace, *, timeout: float = 600.0) -> dict:
    """Drive ``engine`` (a ``GenerationEngine``-shaped object: ``submit``
    returning a future whose result is the generated token list) through
    the trace in order, all requests in flight at once, and return the
    numbers the serving-space tuner scores: tokens/s end-to-end plus the
    per-request latency distribution."""
    lat: List[float] = []
    futs = []
    t0 = time.perf_counter()
    for prompt, max_new in trace:
        ts = time.perf_counter()
        f = engine.submit(prompt, max_new)
        f.add_done_callback(
            lambda _, ts=ts: lat.append(time.perf_counter() - ts))
        futs.append(f)
    tokens = sum(len(f.result(timeout)) for f in futs)
    seconds = time.perf_counter() - t0
    expected = trace.total_new_tokens
    if tokens != expected:
        raise InvalidArgumentError(
            f"trace replay produced {tokens} tokens, expected {expected}")
    lat_ms = np.asarray(sorted(lat)) * 1e3
    return {
        "tokens": tokens,
        "seconds": round(seconds, 4),
        "tokens_per_sec": round(tokens / max(seconds, 1e-9), 2),
        "mean_ms": round(float(lat_ms.mean()), 2),
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 2),
        "requests": len(trace),
    }
