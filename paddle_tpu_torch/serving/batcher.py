"""Request queue + micro-batcher (port of
``paddle_tpu.serving.batcher.MicroBatcher``).

Callers :meth:`~MicroBatcher.submit` requests and get
``concurrent.futures.Future``\\ s back.  Two modes:

* **worker mode** (a ``runner``): one worker thread owns the device and
  groups same-bucket requests into batches of up to ``max_batch_size``
  (``capacity(bucket)`` when given), waiting at most
  ``max_queue_delay_ms`` past the oldest request's arrival — the legacy
  run-batch-to-completion generation scheduler runs under it;
* **pull mode** (no runner): no thread; a consumer loop that owns the
  device (the continuous decode loops) :meth:`~MicroBatcher.poll`\\ s
  requests FCFS across buckets.

Robustness contract, both modes:

* **bounded queue** — past ``max_queue_depth`` pending requests, submit
  sheds the load immediately (``UnavailableError``);
* **deadlines** — a request whose ``deadline_ms`` elapses while queued
  fails with ``ExecutionTimeoutError`` before it takes a slot; the worker
  (or ``poll`` / ``sweep``) enforces them even with no new traffic;
* **graceful drain** — ``close(drain=True)`` stops admissions and serves
  everything queued; ``drain=False`` fails the queue instead;
* a runner exception fails only that batch's futures, never the worker;
* **transient retry** — an optional ``resilience.RetryPolicy`` re-runs a
  batch whose runner failed transiently, its backoff bounded by the
  batch's tightest deadline;
* **circuit breaking** — an optional per-bucket
  ``resilience.CircuitBreaker``: while a bucket's circuit is open its
  batches shed with ``UnavailableError`` (``circuit_shed``).

The JAX batcher's tracing spans and event-bus snapshots come with the
observability slice.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..framework.errors import ExecutionTimeoutError, UnavailableError
from ..framework.locking import OrderedCondition
from ..resilience.faults import fault_point
from .metrics import ServingMetrics

__all__ = ["Request", "MicroBatcher"]


class Request:
    """One queued inference request."""

    __slots__ = ("inputs", "bucket", "future", "enqueue_t", "deadline_t",
                 "meta")

    def __init__(self, inputs: Sequence, bucket: int,
                 deadline_ms: Optional[float] = None, meta=None):
        self.inputs = inputs
        self.bucket = bucket
        self.future: Future = Future()
        self.enqueue_t = time.monotonic()
        self.deadline_t = (self.enqueue_t + deadline_ms / 1e3
                           if deadline_ms is not None else None)
        self.meta = meta


class MicroBatcher:
    """Bucket-grouping batcher.

    ``router(inputs) -> int`` assigns a bucket key (raise to reject at
    submit time); ``runner(bucket, requests) -> list`` executes one batch
    and returns one result per request, in order; ``capacity(bucket) ->
    int`` bounds the batch size per bucket (default: ``max_batch_size``).
    Without a runner (or with ``pull=True``) no worker runs: the consumer
    calls :meth:`poll` to take requests oldest-first across buckets,
    :meth:`sweep` to enforce deadlines while its slots are full, and
    :meth:`consumer_done` when it exits so :meth:`close` can return.
    """

    def __init__(self, router: Callable[[Sequence], int],
                 runner: Optional[Callable[[int, List[Request]],
                                           List[Any]]] = None,
                 *, max_batch_size: int = 8, max_queue_delay_ms: float = 5.0,
                 max_queue_depth: int = 256,
                 capacity: Optional[Callable[[int], int]] = None,
                 metrics: Optional[ServingMetrics] = None,
                 breaker=None, retry=None, pull: Optional[bool] = None,
                 name: str = "serving#0"):
        if max_batch_size < 1 or max_queue_depth < 1:
            raise UnavailableError(
                "max_batch_size and max_queue_depth must be >= 1")
        pull = runner is None if pull is None else bool(pull)
        if runner is None and not pull:
            raise UnavailableError("worker mode needs a runner")
        self._router = router
        self._runner = runner
        self._max_batch = int(max_batch_size)
        self._delay_s = float(max_queue_delay_ms) / 1e3
        self._max_depth = int(max_queue_depth)
        self._capacity = capacity or (lambda bucket: self._max_batch)
        self._breaker = breaker  # resilience.CircuitBreaker, keyed by bucket
        self._retry = retry      # resilience.RetryPolicy for the runner
        self.metrics = metrics or ServingMetrics(name)
        self._cv = OrderedCondition(name="MicroBatcher._cv")
        # bucket → FIFO of requests
        self._pending: Dict[int, deque] = OrderedDict()
        self._depth = 0
        self._closing = False
        self._drain = True
        self._pull_done = threading.Event()
        if pull:
            self._worker = None
        else:
            self._worker = threading.Thread(
                target=self._loop, name=f"{name}-batcher", daemon=True)
            self._worker.start()

    # -- admission -----------------------------------------------------------
    def submit(self, inputs: Sequence, deadline_ms: Optional[float] = None,
               meta=None) -> Future:
        """Enqueue one request; returns its Future.  Sheds (raises
        ``UnavailableError``) when the queue is full or closing."""
        bucket = self._router(inputs)  # may raise (e.g. bucket miss)
        with self._cv:
            if self._closing:
                raise UnavailableError(f"{self.metrics.name}: shutting down")
            self.metrics.incr("requests")
            if self._depth >= self._max_depth:
                self.metrics.incr("shed")
                self.metrics.set_queue_depth(self._depth)
                raise UnavailableError(
                    f"{self.metrics.name}: queue depth {self._depth} at "
                    f"limit {self._max_depth} — load shed (retry with "
                    f"backoff)")
            req = Request(inputs, bucket, deadline_ms, meta)
            self._pending.setdefault(bucket, deque()).append(req)
            self._depth += 1
            self._cv.notify()
        return req.future

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return self._depth

    @property
    def closing(self) -> bool:
        with self._cv:
            return self._closing

    @property
    def drain_on_close(self) -> bool:
        with self._cv:
            return self._drain

    def oldest_wait_ms(self) -> float:
        """Age of the oldest queued request (0 when the queue is empty)."""
        with self._cv:
            t = None
            for dq in self._pending.values():
                if dq and (t is None or dq[0].enqueue_t < t):
                    t = dq[0].enqueue_t
        return 0.0 if t is None else (time.monotonic() - t) * 1e3

    # -- consumer side -------------------------------------------------------
    def poll(self, max_n: int, wait_s: float = 0.0) -> List[Request]:
        """Remove and return up to ``max_n`` queued requests, oldest-first
        ACROSS buckets, after failing any whose deadline passed.  Blocks up
        to ``wait_s`` while the queue is empty.  On ``close(drain=False)``
        every queued request is failed instead of returned."""
        deadline = time.monotonic() + max(float(wait_s), 0.0)
        while True:
            dropped: List[Request] = []
            with self._cv:
                expired = self._take_expired_locked()
                if self._closing and not self._drain:
                    dropped = [r for dq in self._pending.values() for r in dq]
                    self._pending.clear()
                    self._depth = 0
                batch: List[Request] = []
                while len(batch) < max_n and self._depth > 0:
                    b = self._oldest_bucket()
                    dq = self._pending[b]
                    batch.append(dq.popleft())
                    if not dq:
                        del self._pending[b]
                    self._depth -= 1
                if (not batch and not expired and not dropped
                        and not self._closing):
                    remaining = deadline - time.monotonic()
                    if remaining > 0:
                        # <=50ms slices keep deadline sweeps timely
                        self._cv.wait(min(remaining, 0.05))
                        continue
            self._fail_expired(expired)
            if dropped:
                err = UnavailableError(
                    f"{self.metrics.name}: dropped at shutdown "
                    f"(drain=False)")
                for r in dropped:
                    if not r.future.done():
                        r.future.set_exception(err)
            return batch

    def sweep(self):
        """Deadline sweep only — for the consumer while its slots are
        full and it therefore isn't polling."""
        with self._cv:
            expired = self._take_expired_locked()
        self._fail_expired(expired)

    def consumer_done(self):
        """The consumer loop has exited (queue drained or dropped)."""
        self._pull_done.set()

    def _oldest_bucket(self):
        best, best_t = None, None
        for b, dq in self._pending.items():
            if dq and (best_t is None or dq[0].enqueue_t < best_t):
                best, best_t = b, dq[0].enqueue_t
        return best

    def _take_expired_locked(self) -> List[Request]:
        """Remove every queued request whose deadline has passed (caller
        holds ``_cv``)."""
        now = time.monotonic()
        expired: List[Request] = []
        for b in list(self._pending):
            dq = self._pending[b]
            if not any(r.deadline_t is not None and now > r.deadline_t
                       for r in dq):
                continue
            keep = deque()
            for r in dq:
                if r.deadline_t is not None and now > r.deadline_t:
                    expired.append(r)
                else:
                    keep.append(r)
            if keep:
                self._pending[b] = keep
            else:
                del self._pending[b]
        self._depth -= len(expired)
        return expired

    def _fail_expired(self, expired: List[Request]):
        now = time.monotonic()
        for r in expired:
            self.metrics.incr("expired")
            r.future.set_exception(ExecutionTimeoutError(
                f"{self.metrics.name}: deadline exceeded after "
                f"{(now - r.enqueue_t) * 1e3:.1f}ms in queue"))

    # -- worker mode ---------------------------------------------------------
    def _loop(self):
        while True:
            batch = None
            with self._cv:
                expired = self._take_expired_locked()
                if self._depth == 0 and self._closing and not expired:
                    return
                if self._depth == 0:
                    if not expired and not self._closing:
                        self._cv.wait(0.05)
                else:
                    bucket = self._oldest_bucket()
                    dq = self._pending[bucket]
                    cap = max(1, int(self._capacity(bucket)))
                    wait = ((dq[0].enqueue_t + self._delay_s)
                            - time.monotonic())
                    if len(dq) < cap and wait > 0 and not self._closing:
                        self._cv.wait(min(wait, 0.05))
                    else:
                        batch = [dq.popleft()
                                 for _ in range(min(cap, len(dq)))]
                        if not dq:
                            del self._pending[bucket]
                        self._depth -= len(batch)
                        depth = self._depth
                        drain = self._drain
            self._fail_expired(expired)
            if batch is None:
                continue
            if self._closing and not drain:
                for r in batch:
                    r.future.set_exception(
                        UnavailableError(f"{self.metrics.name}: dropped at "
                                         "shutdown (drain=False)"))
                continue
            self._dispatch(bucket, batch, cap, depth)

    def _dispatch(self, bucket: int, batch: List[Request], cap: int,
                  depth: int):
        now = time.monotonic()
        live = []
        for r in batch:
            if r.deadline_t is not None and now > r.deadline_t:
                self.metrics.incr("expired")
                r.future.set_exception(ExecutionTimeoutError(
                    f"{self.metrics.name}: deadline exceeded after "
                    f"{(now - r.enqueue_t) * 1e3:.1f}ms in queue"))
            else:
                live.append(r)
        if not live:
            return
        if self._breaker is not None and not self._breaker.allow(bucket):
            # open circuit: shed without burning a device slot
            self.metrics.incr("circuit_shed", len(live))
            err = UnavailableError(
                f"{self.metrics.name}: circuit open for bucket {bucket} — "
                f"load shed (retry with backoff)")
            for r in live:
                r.future.set_exception(err)
            return

        def _run_once():
            fault_point("serving.runner")
            results = self._runner(bucket, live)
            if len(results) != len(live):
                raise UnavailableError(
                    f"runner returned {len(results)} results for "
                    f"{len(live)} requests")
            return results

        t_exec = time.monotonic()
        try:
            if self._retry is not None:
                # backoff never blows through the batch's tightest deadline
                dls = [r.deadline_t for r in live if r.deadline_t is not None]
                if dls:
                    remaining_ms = max((min(dls) - t_exec) * 1e3, 0.0)
                    results = self._retry.call_deadline(remaining_ms,
                                                        _run_once)
                else:
                    results = self._retry.call(_run_once)
            else:
                results = _run_once()
        except Exception as e:  # fail the batch, keep the worker alive
            if self._breaker is not None:
                self._breaker.record_failure(bucket)
            self.metrics.incr("errors", len(live))
            for r in live:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        if self._breaker is not None:
            self._breaker.record_success(bucket)
        done = time.monotonic()
        execute_ms = (done - t_exec) * 1e3
        for r, res in zip(live, results):
            self.metrics.observe_latency_ms((done - r.enqueue_t) * 1e3)
            self.metrics.observe_span((t_exec - r.enqueue_t) * 1e3,
                                      execute_ms)
            if not r.future.done():  # a timed-out drain may have failed it
                r.future.set_result(res)
        self.metrics.observe_batch(len(live), cap, depth)

    # -- shutdown ------------------------------------------------------------
    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop admissions; serve (``drain=True``) or fail (``False``)
        everything still queued, then join the worker (pull mode: wait for
        the consumer's :meth:`consumer_done`).  If that wait times out,
        everything STILL QUEUED fails with ``UnavailableError`` instead of
        leaking pending futures (``drain_timeout`` counts these closes)."""
        with self._cv:
            self._closing = True
            self._drain = drain
            self._cv.notify_all()
        if self._worker is None:
            finished = self._pull_done.wait(timeout)
        else:
            self._worker.join(timeout)
            finished = not self._worker.is_alive()
        if finished:
            return
        with self._cv:
            stranded = [r for dq in self._pending.values() for r in dq]
            self._pending.clear()
            self._depth = 0
        self.metrics.incr("drain_timeout")
        err = UnavailableError(
            f"{self.metrics.name}: drain timed out after {timeout}s with "
            f"the consumer still busy — failing {len(stranded)} queued "
            f"request(s)")
        for r in stranded:
            if not r.future.done():
                r.future.set_exception(err)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
