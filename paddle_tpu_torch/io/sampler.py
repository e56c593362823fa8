"""Samplers and batch samplers — port of ``paddle_tpu.io.sampler``:
``SequenceSampler``, ``RandomSampler``, ``WeightedRandomSampler``,
``BatchSampler``, ``DistributedBatchSampler``, each with the JAX package's
exact-resume ``state_dict`` / ``set_state_dict``.

Orders are host numpy, as in the JAX package: an epoch's permutation is
``np.random.RandomState(seed).permutation(n)``, so with an int seed (or
``shuffle=False``) both packages produce the same indices.  Where no seed
is given, ``RandomSampler`` draws one from the port's CPU generator
(``framework.random``, reseeded by ``paddle_tpu_torch.seed``) — the JAX
package draws a JAX key there, so default shuffles differ between the
packages.  ``DistributedBatchSampler`` needs ``num_replicas`` and ``rank``
from the caller until the distributed environment is ported (ROADMAP
queue A, distributed execution).
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError, UnimplementedError
from ..framework.random import default_generator

__all__ = [
    "Sampler",
    "SequenceSampler",
    "RandomSampler",
    "WeightedRandomSampler",
    "BatchSampler",
    "DistributedBatchSampler",
]


def _batched(indices, batch_size: int, drop_last: bool):
    """Group an index stream into batch lists (shared by Batch/Distributed)."""
    batch: List[int] = []
    for idx in indices:
        batch.append(idx)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        # exact-resume support: the derived int seed fully determines one
        # epoch's permutation, so snapshotting it (state_dict) lets a
        # restored run regenerate the SAME order without re-consuming the
        # key source — the checkpoint's rng_state already reflects the
        # original draw.
        self._last_seed: Optional[int] = None
        self._replay_seed: Optional[int] = None
        if not replacement and num_samples is not None and num_samples > len(data_source):
            raise InvalidArgumentError("num_samples > dataset size without replacement")

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None else len(self.data_source)

    def _draw_seed(self) -> int:
        if self.generator is not None:
            if isinstance(self.generator, torch.Generator):
                # each epoch draws a fresh seed, replayed under seed()
                return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                         generator=self.generator))
            # an int seed: vary per epoch deterministically
            self._epoch = getattr(self, "_epoch", -1) + 1
            return (int(self.generator) + self._epoch) & 0x7FFFFFFF
        # default: the framework's CPU generator, so paddle_tpu_torch.seed()
        # reproduces the shuffle order
        return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=default_generator()))

    def _rng(self):
        if self._replay_seed is not None:
            # restored state: reuse the seed that generated the epoch being
            # re-entered, WITHOUT drawing from the key source (the original
            # draw is already baked into the restored generator state)
            s, self._replay_seed = self._replay_seed, None
        else:
            s = self._draw_seed()
        self._last_seed = s
        return np.random.RandomState(s)

    def __iter__(self):
        n = len(self.data_source)
        rng = self._rng()
        if self.replacement:
            return iter(rng.randint(0, n, size=self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples

    def state_dict(self) -> dict:
        """Shuffle-RNG snapshot for exact resume (see BatchSampler)."""
        return {"last_seed": self._last_seed,
                "epoch_counter": getattr(self, "_epoch", None)}

    def set_state_dict(self, state: dict) -> None:
        self._replay_seed = state.get("last_seed")
        if state.get("epoch_counter") is not None:
            self._epoch = int(state["epoch_counter"])


class WeightedRandomSampler(Sampler):
    """Indices drawn with probability proportional to ``weights``, by
    ``np.random.choice``: from ``generator`` (a ``np.random.RandomState``
    or an int seed) where one is given, else from numpy's global RNG, as
    the JAX package draws them."""

    def __init__(self, weights: Sequence[float], num_samples: int,
                 replacement=True, generator=None):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        if (self.weights < 0).any():
            raise InvalidArgumentError("weights must be non-negative")
        self.num_samples = num_samples
        self.replacement = replacement
        if not replacement and num_samples > len(self.weights):
            raise InvalidArgumentError("num_samples > len(weights) without replacement")
        self.generator = (np.random.RandomState(generator)
                          if isinstance(generator, (int, np.integer))
                          else generator)

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = self.generator if self.generator is not None else np.random
        idx = rng.choice(
            len(self.weights), size=self.num_samples, replace=self.replacement, p=p
        )
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Group sampler indices into batches.

    Matches the reference's constructor contract: either ``dataset`` (+
    shuffle) or an explicit ``sampler``.

    Exact resume: ``state_dict()`` snapshots (next-batch index, shuffle-RNG
    seed); after ``set_state_dict()`` the NEXT ``__iter__`` regenerates the
    same index stream and skips the already-consumed batches, so a restored
    run sees the remaining batches in the original order.  ``DataLoader``
    overrides the batch index with its delivered count (prefetch makes the
    sampler-side count run ahead of the consumer)."""

    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle: bool = False, batch_size: int = 1, drop_last: bool = False):
        if batch_size <= 0:
            raise InvalidArgumentError("batch_size must be positive")
        if sampler is not None:
            if dataset is not None:
                raise InvalidArgumentError("give either dataset or sampler, not both")
            if shuffle:
                raise InvalidArgumentError(
                    "shuffle=True conflicts with an explicit sampler; the "
                    "sampler alone controls ordering"
                )
            self.sampler = sampler
        else:
            if dataset is None:
                raise InvalidArgumentError("need a dataset or a sampler")
            self.sampler = RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._yielded = 0
        self._pending: Optional[dict] = None

    def _consume_pending(self) -> int:
        """Apply restored state (if any) to the sampler; return the number
        of leading batches to skip."""
        pending, self._pending = self._pending, None
        if pending is None:
            return 0
        sampler_state = pending.get("sampler")
        if sampler_state is not None and hasattr(self.sampler, "set_state_dict"):
            self.sampler.set_state_dict(sampler_state)
        return int(pending.get("next_batch", 0))

    def __iter__(self):
        skip = self._consume_pending()
        stream = _batched(self.sampler, self.batch_size, self.drop_last)
        for _ in range(skip):
            if next(stream, None) is None:
                break
        self._yielded = skip
        for batch in stream:
            self._yielded += 1
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def state_dict(self) -> dict:
        """(next-batch index, shuffle RNG) snapshot.  ``next_batch`` counts
        batches the sampler HANDED OUT — exact for synchronous iteration;
        a prefetching consumer (DataLoader) substitutes its delivered
        count."""
        out = {"next_batch": int(self._yielded)}
        sd = getattr(self.sampler, "state_dict", None)
        if sd is not None:
            out["sampler"] = sd()
        return out

    def set_state_dict(self, state: dict) -> None:
        """Arm the NEXT ``__iter__`` to replay from ``state`` (regenerate
        the permutation from the snapshotted seed, skip consumed batches)."""
        self._pending = dict(state)


class DistributedBatchSampler(BatchSampler):
    """Per-rank disjoint shard of the dataset (ref: batch_sampler.py:169).

    ``num_replicas`` / ``rank`` are the caller's (the distributed
    environment they default from is not ported yet).
    ``set_epoch(e)`` reseeds the shuffle so every rank permutes identically.
    """

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        if batch_size <= 0:
            raise InvalidArgumentError("batch_size must be positive")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            raise UnimplementedError(
                "DistributedBatchSampler: num_replicas and rank default "
                "from the distributed environment, which is not ported yet "
                "(ROADMAP queue A, distributed execution); pass both")
        if rank >= num_replicas or rank < 0:
            raise InvalidArgumentError(f"rank {rank} out of range for {num_replicas} replicas")
        self.nranks = self.num_replicas = num_replicas
        self.local_rank = self.rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas
        self._yielded = 0
        self._pending: Optional[dict] = None

    def __iter__(self):
        pending, self._pending = self._pending, None
        skip = int(pending.get("next_batch", 0)) if pending else 0
        n = len(self.dataset)
        if self.shuffle:
            # the permutation is a pure function of the epoch — restoring
            # ``epoch`` (set_state_dict) regenerates it exactly
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad to make evenly divisible (reference pads by wrapping; loop so
        # datasets smaller than total_size/2 still fill up)
        while len(indices) < self.total_size:
            indices += indices[: self.total_size - len(indices)]
        local = indices[self.rank : self.total_size : self.num_replicas]
        assert len(local) == self.num_samples
        stream = _batched(local, self.batch_size, self.drop_last)
        for _ in range(skip):
            if next(stream, None) is None:
                break
        self._yielded = skip
        for batch in stream:
            self._yielded += 1
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def state_dict(self) -> dict:
        """(epoch, next-batch index) snapshot — the per-rank shard order is
        a pure function of the epoch, so this is the complete state."""
        return {"epoch": int(self.epoch), "next_batch": int(self._yielded)}

    def set_state_dict(self, state: dict) -> None:
        if "epoch" in state:
            self.epoch = int(state["epoch"])
        self._pending = {"next_batch": int(state.get("next_batch", 0))}
