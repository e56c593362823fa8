"""Shape buckets — the closed executable set under live traffic (port of
``paddle_tpu.serving.bucketing``; host-only).

The serving engine holds one executable per input geometry (on the card a
CUDA graph, ``inference.Predictor.aot_compile``), so it declares a FIXED
set of buckets up front; every request is padded up to the smallest
bucket that fits, and the steady-state executable set is exactly one per
bucket — closed, built once at warmup, never growing.

A :class:`Bucket` names the padded per-request shape of each model input:
without the batch dimension (batching is the micro-batcher's axis), or,
for requests that carry their own rows, with it (see
``serving.InferenceEngine``).  Requests whose shapes fit no bucket are
*bucket misses*: rejected (or served by the unbatched polymorphic
fallback) and counted.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..framework.errors import InvalidArgumentError

__all__ = ["Bucket", "BucketSet", "as_bucket"]


@dataclasses.dataclass(frozen=True)
class Bucket:
    """Padded per-request shapes, one tuple per model input.

    ``Bucket(((64,),))`` — one 1-D input padded to length 64;
    ``Bucket(((128, 80), (128,)))`` — two inputs.  ``batch_size``
    overrides the engine's ``max_batch_size`` for this bucket (small
    buckets can batch wider at equal cost).
    """

    shapes: Tuple[Tuple[int, ...], ...]
    batch_size: Optional[int] = None

    def __post_init__(self):
        shapes = tuple(tuple(int(d) for d in s) for s in self.shapes)
        if not shapes or any(d <= 0 for s in shapes for d in s):
            raise InvalidArgumentError(
                f"bucket shapes must be non-empty positive dims, got "
                f"{self.shapes!r}")
        object.__setattr__(self, "shapes", shapes)

    @property
    def padded_elements(self) -> int:
        return sum(int(np.prod(s)) if s else 1 for s in self.shapes)

    def fits(self, shapes: Sequence[Tuple[int, ...]]) -> bool:
        if len(shapes) != len(self.shapes):
            return False
        for got, want in zip(shapes, self.shapes):
            if len(got) != len(want) or any(g > w for g, w in zip(got, want)):
                return False
        return True


def as_bucket(spec) -> Bucket:
    """Normalize user shorthand: a ``Bucket``, a shape tuple for a
    single-input model (``(64,)``), or a tuple of per-input shapes
    (``((64, 8), (64,))``)."""
    if isinstance(spec, Bucket):
        return spec
    if isinstance(spec, (tuple, list)):
        if all(isinstance(d, (int, np.integer)) for d in spec):
            return Bucket((tuple(spec),))
        return Bucket(tuple(tuple(s) for s in spec))
    raise InvalidArgumentError(
        f"bucket spec must be a Bucket or a shape tuple, got {spec!r}")


class BucketSet:
    """Ordered bucket collection with smallest-fit routing and padding."""

    def __init__(self, buckets: Sequence, pad_value=0):
        self.buckets: List[Bucket] = [as_bucket(b) for b in buckets]
        if not self.buckets:
            raise InvalidArgumentError("at least one bucket is required")
        self.pad_value = pad_value
        # route tries buckets smallest-first but reports original indices
        self._by_size = sorted(range(len(self.buckets)),
                               key=lambda i: self.buckets[i].padded_elements)

    def __len__(self):
        return len(self.buckets)

    def route(self, shapes: Sequence[Tuple[int, ...]]) -> int:
        """Index of the smallest bucket fitting ``shapes``, or ``-1``
        (bucket miss)."""
        for i in self._by_size:
            if self.buckets[i].fits(shapes):
                return i
        return -1

    def pad_request(self, idx: int, inputs: Sequence) -> List[np.ndarray]:
        """Pad one request's inputs up to bucket ``idx``'s shapes."""
        b = self.buckets[idx]
        out = []
        for a, want in zip([np.asarray(x) for x in inputs], b.shapes):
            if a.shape == want:
                out.append(a)
                continue
            widths = [(0, w - g) for g, w in zip(a.shape, want)]
            out.append(np.pad(a, widths, constant_values=self.pad_value))
        return out
