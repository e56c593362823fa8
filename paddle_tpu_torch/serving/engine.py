"""Dynamic-batching inference engine over bucketed executables (port of
``paddle_tpu.serving.engine``).

``InferenceEngine`` fronts an exported ``paddle_tpu_torch.inference``
artifact with the micro-batcher: requests are routed to the smallest
fitting shape bucket, padded, batched, and executed by ONE executable a
bucket (``Predictor.aot_compile``: on the card a CUDA graph over the
exported module).  After :meth:`warmup` the executable set is closed —
``compile_count == len(buckets)`` whatever shapes live traffic sends.

Two request forms, told apart by each bucket's rank against the
artifact's declared input rank:

* a bucket one rank below the input (the JAX form): a request is one
  unbatched example; requests of a bucket are stacked, up to the bucket's
  ``batch_size`` (or ``max_batch_size``), and the batch axis padded to
  that capacity;
* a bucket of the input's own rank: a request carries its own rows
  (``[r, 128]`` token ids, say), is padded to the bucket's geometry
  (``(16, 128)``: rows and sequence) and runs alone, and its answer is
  its own ``r`` rows.

The weights are input tensors of every executable, so :meth:`swap_weights`
copies a new ``.pdiparams`` side-file in between batches with no rebuild,
and no request sees a half-swapped model.  The engine's metrics stay in
its ``ServingMetrics`` (``stats()``); the serving event bus comes with the
control-plane slice.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError
from ..framework.locking import OrderedLock
from ..inference import Predictor
from ..resilience import CircuitBreaker, RetryPolicy
from ..resilience import retry as _retry_mod
from .batcher import MicroBatcher, Request
from .bucketing import BucketSet
from .metrics import ServingMetrics

__all__ = ["InferenceEngine"]

_FALLBACK = -1
_engine_counter = [0]


class InferenceEngine:
    """Serve an exported model under dynamic batching.

    ``buckets`` (the closed shape set — see ``serving.bucketing`` and the
    module docstring), ``max_batch_size`` / ``max_queue_delay_ms``
    (throughput vs latency), ``max_queue_depth`` (load shedding),
    ``allow_bucket_fallback`` (serve bucket misses unbatched through the
    exported module at their own shapes instead of rejecting them),
    ``circuit_breaker`` (per-bucket closed / open / half-open degradation)
    and ``retry_transient`` (re-run a batch once per transient device
    error).  ``device``: ``None`` is the card, ``"cpu"`` the CPU."""

    @classmethod
    def from_tuned(cls, path_prefix: str, config: Dict, **overrides):
        """Build an engine from a serving config: ``buckets`` plus
        ``max_batch_size`` / ``batch_size`` and ``max_queue_delay_ms`` map
        onto constructor arguments; keyword ``overrides`` win."""
        kw = {}
        batch = config.get("max_batch_size", config.get("batch_size"))
        if batch is not None:
            kw["max_batch_size"] = int(batch)
        if config.get("max_queue_delay_ms") is not None:
            kw["max_queue_delay_ms"] = float(config["max_queue_delay_ms"])
        kw.update(overrides)
        return cls(path_prefix, config["buckets"], **kw)

    def __init__(self, path_prefix: str, buckets: Sequence, *,
                 max_batch_size: int = 8, max_queue_delay_ms: float = 5.0,
                 max_queue_depth: int = 256, pad_value=0,
                 allow_bucket_fallback: bool = False,
                 unpad_outputs: bool = True,
                 device: Optional[str] = None,
                 params_file: Optional[str] = None,
                 circuit_breaker: bool = True,
                 retry_transient: bool = True,
                 name: Optional[str] = None):
        if name is None:
            _engine_counter[0] += 1
            name = f"engine#{_engine_counter[0]}"
        self.name = name
        self._pred = Predictor(path_prefix, device=device,
                               params_file=params_file)
        self._buckets = BucketSet(buckets, pad_value=pad_value)
        ranks = self._ranks = [len(i["shape"])
                               for i in self._pred._meta["inputs"]]
        self._rows = []
        for b in self._buckets.buckets:
            got = [len(s) for s in b.shapes]
            if got == ranks:
                self._rows.append(True)
            elif got == [r - 1 for r in ranks]:
                self._rows.append(False)
            else:
                raise InvalidArgumentError(
                    f"{name}: bucket {b.shapes} fits neither the inputs' "
                    f"ranks {ranks} (requests with their own rows) nor one "
                    f"below them (unbatched requests)")
        self._max_batch = int(max_batch_size)
        self._allow_fallback = bool(allow_bucket_fallback)
        self._unpad = bool(unpad_outputs)
        self._exe_lock = OrderedLock("InferenceEngine._exe_lock")
        self._executables: Dict[int, object] = {}
        self.metrics = ServingMetrics(name)
        self.breaker = (CircuitBreaker(name) if circuit_breaker else None)
        self._batcher = MicroBatcher(
            self._route, self._run_batch,
            max_batch_size=max_batch_size,
            max_queue_delay_ms=max_queue_delay_ms,
            max_queue_depth=max_queue_depth,
            capacity=self._bucket_capacity,
            metrics=self.metrics,
            breaker=self.breaker,
            retry=(RetryPolicy.from_flags(name=f"{name}.runner")
                   if retry_transient else None),
            name=name)

    # -- routing / executable set -------------------------------------------
    def _bucket_capacity(self, bucket: int) -> int:
        if bucket == _FALLBACK or self._rows[bucket]:
            return 1  # unbatched: the fallback, or requests with rows
        return self._buckets.buckets[bucket].batch_size or self._max_batch

    def _route(self, inputs: Sequence) -> int:
        shapes = tuple(tuple(np.shape(x)) for x in inputs)
        idx = self._buckets.route(shapes)
        if idx >= 0:
            return idx
        self.metrics.incr("bucket_misses")
        if self._allow_fallback:
            return _FALLBACK
        raise InvalidArgumentError(
            f"{self.name}: request shapes {shapes} fit none of the "
            f"{len(self._buckets)} configured buckets "
            f"{[b.shapes for b in self._buckets.buckets]} — add a bucket "
            f"covering them (or allow_bucket_fallback=True to serve "
            f"misses unbatched at their own shapes)")

    def _geometry(self, bucket: int):
        b = self._buckets.buckets[bucket]
        if self._rows[bucket]:
            return list(b.shapes)
        cap = self._bucket_capacity(bucket)
        return [(cap,) + s for s in b.shapes]

    def _executable(self, bucket: int):
        with self._exe_lock:
            exe = self._executables.get(bucket)
        if exe is not None:
            return exe
        exe = self._pred.aot_compile(self._geometry(bucket))
        with self._exe_lock:
            # a concurrent build of the same bucket keeps the first one
            exe = self._executables.setdefault(bucket, exe)
            self.metrics.incr("compiles")
        return exe

    @property
    def compile_count(self) -> int:
        """Bucket executables built so far (fallback runs are counted
        apart, in ``stats()['fallback_runs']``)."""
        with self._exe_lock:
            return len(self._executables)

    def warmup(self) -> int:
        """Build every configured bucket's executable up front, so first
        requests pay serve latency, not build latency.  Returns the (now
        closed) executable count."""
        for i in range(len(self._buckets)):
            self._executable(i)
        _retry_mod.mark_warm()  # later retry storms are post-warm
        return self.compile_count

    # -- execution -----------------------------------------------------------
    def _run_batch(self, bucket: int,
                   requests: List[Request]) -> List[List[np.ndarray]]:
        if bucket == _FALLBACK:
            outs = []
            for r in requests:
                self.metrics.incr("fallback_runs")
                rows = [np.ndim(x) for x in r.inputs] == self._ranks
                ins = [np.asarray(x) if rows else np.asarray(x)[None]
                       for x in r.inputs]
                out = self._pred.run(ins)
                outs.append(out if rows else [o[0] for o in out])
            return outs
        padded = [self._buckets.pad_request(bucket, r.inputs)
                  for r in requests]
        if self._rows[bucket]:
            stacked = padded[0]
        else:
            cap = self._bucket_capacity(bucket)
            stacked = []
            for j in range(len(padded[0])):
                col = np.stack([p[j] for p in padded])
                if col.shape[0] < cap:  # pad batch rows: shapes stay closed
                    widths = ([(0, cap - col.shape[0])]
                              + [(0, 0)] * (col.ndim - 1))
                    col = np.pad(col, widths)
                stacked.append(col)
        with torch.profiler.record_function(f"{self.name}/bucket[{bucket}]"):
            outs = self._pred.run_compiled(self._executable(bucket), stacked)
        return [self._slice_out(bucket, outs, i, r)
                for i, r in enumerate(requests)]

    def _slice_out(self, bucket: int, outs: List[np.ndarray], i: int,
                   req: Request) -> List[np.ndarray]:
        """The request's part of each output: row ``i`` (stacked
        requests) or the whole output (a request with its rows), with
        padded axes sliced back where they are recognisable — output axis
        ``j`` is sliced when it positionally matches a padded input-0
        bucket dim (``out.shape[j] == bucket_dim[j] != request_dim[j]``):
        a request's rows, and the sequence axes of a sequence model.
        ``unpad_outputs=False`` turns the sequence slicing off."""
        rows = self._rows[bucket]
        row = list(outs) if rows else [o[i] for o in outs]
        want = self._buckets.buckets[bucket].shapes[0]
        got = np.shape(req.inputs[0])
        out = []
        for o in row:
            idx = [slice(None)] * o.ndim
            for j in range(min(o.ndim, len(want))):
                if not self._unpad and not (rows and j == 0):
                    continue
                if o.shape[j] == want[j] and want[j] != got[j]:
                    idx[j] = slice(0, got[j])
            out.append(o[tuple(idx)])
        return out

    # -- public API ----------------------------------------------------------
    def synthetic_inputs(self, bucket: int = 0) -> List[np.ndarray]:
        """Zero-filled inputs exactly matching bucket ``bucket``'s shapes
        and the artifact's declared dtypes — a health probe over the real
        routed / padded / built path that needs no live traffic."""
        b = self._buckets.buckets[bucket]
        dtypes = self._pred.input_dtypes()
        return [torch.zeros(s, dtype=dtypes[i]).numpy()
                for i, s in enumerate(b.shapes)]

    def submit(self, inputs: Sequence,
               deadline_ms: Optional[float] = None) -> Future:
        """Async inference: one request (see the module docstring for its
        two forms); resolves to the list of the request's outputs."""
        return self._batcher.submit(inputs, deadline_ms=deadline_ms)

    def infer(self, inputs: Sequence,
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """Blocking :meth:`submit`."""
        return self.submit(inputs).result(timeout)

    def swap_weights(self, params_file: str) -> None:
        """Hot weight swap (see ``Predictor.swap_weights``): batches
        formed after this call run the new weights, with no rebuild."""
        self._pred.swap_weights(params_file)
        self.metrics.incr("weight_swaps")

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap["compile_count"] = self.compile_count
        snap["buckets"] = len(self._buckets)
        snap.setdefault("fallback_runs", 0)
        return snap

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        self._batcher.close(drain=drain, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
