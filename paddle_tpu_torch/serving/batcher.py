"""Request queue for a slot-granular consumer (port of the pull mode of
``paddle_tpu.serving.batcher.MicroBatcher``).

Callers :meth:`~MicroBatcher.submit` requests and get
``concurrent.futures.Future``\\ s back; a consumer loop that owns the
device (the paged decode loop) :meth:`~MicroBatcher.poll`\\ s them FCFS.

Robustness contract:

* **bounded queue** — past ``max_queue_depth`` pending requests, submit
  sheds the load immediately (``UnavailableError``);
* **deadlines** — a request whose ``deadline_ms`` elapses while queued
  fails with ``ExecutionTimeoutError`` before it takes a slot; ``poll``
  and ``sweep`` enforce them even while no slot frees up;
* **graceful drain** — ``close(drain=True)`` stops admissions and waits
  for the consumer to serve everything queued; ``drain=False`` fails the
  queue instead.

The JAX package's worker mode (bucket-grouped batches run by a batcher
thread) serves its non-generation engines and is not ported yet.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

from ..framework.errors import ExecutionTimeoutError, UnavailableError
from ..framework.locking import OrderedCondition
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
    """Pull-mode request queue.

    ``router(inputs) -> int`` assigns a bucket key (raise to reject at
    submit time).  The consumer calls :meth:`poll` to take requests
    oldest-first across buckets, :meth:`sweep` to enforce deadlines while
    its slots are full, and :meth:`consumer_done` when it exits so
    :meth:`close` can return.
    """

    def __init__(self, router: Callable[[Sequence], int], *,
                 max_queue_depth: int = 256,
                 metrics: Optional[ServingMetrics] = None,
                 name: str = "serving#0"):
        if max_queue_depth < 1:
            raise UnavailableError("max_queue_depth must be >= 1")
        self._router = router
        self._max_depth = int(max_queue_depth)
        self.metrics = metrics or ServingMetrics(name)
        self._cv = OrderedCondition(name="MicroBatcher._cv")
        # bucket → FIFO of requests
        self._pending: Dict[int, deque] = OrderedDict()
        self._depth = 0
        self._closing = False
        self._drain = True
        self._pull_done = threading.Event()

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

    # -- shutdown ------------------------------------------------------------
    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop admissions; let the consumer serve (``drain=True``) or
        fail (``False``) everything still queued and wait for its
        :meth:`consumer_done`.  If that wait times out, everything STILL
        QUEUED fails with ``UnavailableError`` instead of leaking pending
        futures."""
        with self._cv:
            self._closing = True
            self._drain = drain
            self._cv.notify_all()
        if self._pull_done.wait(timeout):
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
