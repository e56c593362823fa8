"""DataLoader — port of ``paddle_tpu.io.dataloader``: worker processes on
the host, and batches staged onto the device ahead of the consumer.

* Batches are fetched and collated on the host (numpy), synchronously or
  by ``num_workers`` spawned worker processes ``prefetch_factor`` batches
  deep, exactly as in the JAX package, so both packages yield the same
  values in the same order.
* A staging thread moves the next batches to the device while the
  current one is consumed (the JAX package's ``device_put`` thread).  On
  the card each batch is copied from pinned host memory with
  ``non_blocking`` copies on a side stream; the consumer's stream waits
  on that batch's event before it gets the batch, and every tensor is
  ``record_stream``-ed on the consumer's stream, so a step never reads a
  half-copied batch and the allocator never reuses a batch's memory under
  it.  An exception in the thread (or in a worker) is raised again in the
  consumer.
* ``places`` is the device batches land on (a device, or a list holding
  one; default: the card, ``framework.device.default_device()``, resolved
  when an epoch starts).  ``return_numpy=True`` skips staging.
* ``superbatch=k`` stacks k batches along a new axis 0; ``state_dict`` /
  ``set_state_dict`` resume an epoch exactly, counting batches as they are
  delivered to the consumer (prefetch never over-counts).
"""
from __future__ import annotations

import itertools
import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..framework.device import resolve_device, upload
from ..framework.dtype import numpy_to_tensor, to_numpy
from ..framework.errors import InvalidArgumentError
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler, Sampler

__all__ = ["DataLoader", "WorkerInfo", "default_collate_fn",
           "default_convert_fn", "get_worker_info"]


def default_convert_fn(sample):
    return sample


def default_collate_fn(batch):
    """Stack a list of samples into a batch: arrays and numbers stack
    along a new dim 0; dict / tuple samples collate per field."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch, axis=0)
    if isinstance(sample, (int, float, np.generic)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn(list(field)) for field in zip(*batch))
    if isinstance(sample, torch.Tensor):
        return np.stack([to_numpy(s) for s in batch], axis=0)
    if hasattr(sample, "__array__"):
        return np.stack([np.asarray(s) for s in batch], axis=0)
    raise InvalidArgumentError(f"cannot collate batch of {type(sample)}")


def _leaves(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _leaves(v)
    else:
        yield obj


def _map(fn, *objs):
    """``fn`` over the leaves of equally structured batches."""
    first = objs[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(o[k] for o in objs)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *fields) for fields in zip(*objs))
    return fn(*objs)


def _to_device(a, device, pinned=False):
    """A numpy leaf as a tensor on ``device`` (through pinned host memory
    with a ``non_blocking`` copy where ``pinned``); other leaves (strings)
    as they are."""
    if not isinstance(a, (np.ndarray, np.generic, torch.Tensor)):
        return a
    t = numpy_to_tensor(a)
    return upload(t, device) if pinned else t.to(device)


# -- worker-process globals (set once per worker by the pool initializer) ----
_worker_dataset = None
_worker_collate = None
_worker_info = None


class WorkerInfo:
    """A worker process's identity, visible to Dataset code."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset

    def __repr__(self):
        return f"WorkerInfo(id={self.id}, num_workers={self.num_workers})"


def get_worker_info():
    """Inside a DataLoader worker process: that worker's ``WorkerInfo``;
    in the main process: None."""
    return _worker_info


def _init_worker(dataset, collate_fn, worker_init_fn, worker_id_counter,
                 num_workers=0):
    global _worker_dataset, _worker_collate, _worker_info
    _worker_dataset = dataset
    _worker_collate = collate_fn
    with worker_id_counter.get_lock():
        worker_id = worker_id_counter.value
        worker_id_counter.value += 1
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)


def _fetch_batch(indices):
    samples = [_worker_dataset[i] for i in indices]
    return _worker_collate(samples)


class _StagingIterator:
    """Pulls collated numpy batches from ``source`` and keeps ``depth``
    batches on ``device`` ahead of the consumer.  ``close()`` (also run on
    GC) stops the thread and closes the source, so a consumer that breaks
    mid-epoch leaks neither the thread nor the worker pool."""

    _DONE = object()

    def __init__(self, source, depth: int, device: torch.device):
        self._source = source
        self._device = device
        self._side = (torch.cuda.Stream(device) if device.type == "cuda"
                      else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _stage(self, batch):
        """``(batch on the device, the event its copies end with)``."""
        if self._side is None:
            return _map(lambda a: _to_device(a, self._device), batch), None
        with torch.cuda.stream(self._side):
            out = _map(lambda a: _to_device(a, self._device, pinned=True),
                       batch)
            done = torch.cuda.Event()
            done.record(self._side)
        return out, done

    def _put(self, item) -> bool:
        while not self._stop:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for batch in self._source:
                if not self._put(self._stage(batch)):
                    break
        except BaseException as e:  # raised again in the consumer
            self._err = e
        finally:
            if self._stop:
                close = getattr(self._source, "close", None)
                if close is not None:
                    close()
            self._put(self._DONE)

    def close(self):
        self._stop = True
        while True:  # drain so a blocked producer can see _stop
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        # GC may run __del__ on the staging thread itself
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)

    def __del__(self):
        if not self._stop and self._thread.is_alive():
            self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._q.put(self._DONE)  # stay exhausted; re-raise each time
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for t in _leaves(batch):
                if isinstance(t, torch.Tensor):
                    t.record_stream(stream)
        return batch


class _CountingIterator:
    """Counts batches as they are DELIVERED to the consumer — the position
    ``DataLoader.state_dict`` snapshots (the staging thread runs ahead).
    Forwards ``close()``."""

    def __init__(self, inner, loader, base: int):
        self._inner = inner
        self._loader = loader
        loader._delivered = int(base)
        loader._exhausted = False

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self._inner)
        except StopIteration:
            self._loader._exhausted = True
            raise
        self._loader._delivered += self._loader._batch_span(batch)
        return batch

    def close(self):
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()


class DataLoader:
    """Iterate a Dataset in collated, device-staged batches (the JAX
    package's arguments; ``feed_list`` is accepted and ignored).

    Exact resume: ``state_dict()`` snapshots the in-epoch position
    (batches delivered to the consumer) and the batch sampler's
    shuffle-seed state; ``set_state_dict()`` arms the next ``__iter__`` to
    regenerate the same order and skip the consumed prefix.
    """

    def __init__(
        self,
        dataset: Dataset,
        feed_list=None,
        places=None,
        return_list: bool = True,
        batch_sampler: Optional[BatchSampler] = None,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 0,
        use_buffer_reader: bool = True,
        prefetch_factor: int = 2,
        use_shared_memory: bool = True,
        timeout: int = 0,
        worker_init_fn: Optional[Callable] = None,
        return_numpy: bool = False,
        sampler: Optional[Sampler] = None,
        superbatch: int = 1,
    ):
        self.dataset = dataset
        if isinstance(places, (list, tuple)):
            if len(places) != 1:
                raise InvalidArgumentError(
                    f"DataLoader stages onto one device, got places="
                    f"{places!r}")
            places = places[0]
        self.places = places
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(int(num_workers), 0)
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout or None
        self.worker_init_fn = worker_init_fn
        self.return_numpy = return_numpy
        self.superbatch = max(int(superbatch), 1)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self._delivered = 0       # sampler-batches delivered this epoch
        self._exhausted = True    # no epoch in progress yet
        self._pending: Optional[dict] = None

        if self._iterable_mode:
            if batch_sampler is not None:
                raise InvalidArgumentError(
                    "IterableDataset cannot use batch_sampler")
            if self.num_workers > 0:
                import warnings

                warnings.warn(
                    "IterableDataset streams in the main process; "
                    "num_workers is ignored", RuntimeWarning)
                self.num_workers = 0
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if batch_size is None:
                raise InvalidArgumentError(
                    "batch_size or batch_sampler required")
            self.batch_sampler = BatchSampler(
                dataset=None if sampler is not None else dataset,
                sampler=sampler,
                shuffle=shuffle,
                batch_size=batch_size,
                drop_last=drop_last,
            )

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("DataLoader over IterableDataset has no len()")
        return len(self.batch_sampler)

    # -- batch sources -------------------------------------------------------
    def _iter_sync(self):
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def _iter_iterable(self):
        it = iter(self.dataset)
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield self.collate_fn(batch)

    def _iter_workers(self):
        # one pool an epoch, spawned (not forked: the parent runs threads),
        # so dataset and collate_fn must be picklable at module scope
        ctx = multiprocessing.get_context("spawn")
        worker_id_counter = ctx.Value("i", 0)
        with ProcessPoolExecutor(
            max_workers=self.num_workers,
            mp_context=ctx,
            initializer=_init_worker,
            initargs=(self.dataset, self.collate_fn, self.worker_init_fn,
                      worker_id_counter, self.num_workers),
        ) as pool:
            window = self.num_workers * self.prefetch_factor
            batches = iter(self.batch_sampler)
            pending = []
            for indices in itertools.islice(batches, window):
                pending.append(pool.submit(_fetch_batch, indices))
            while pending:
                fut = pending.pop(0)
                nxt = next(batches, None)
                if nxt is not None:
                    pending.append(pool.submit(_fetch_batch, nxt))
                yield fut.result(timeout=self.timeout)

    def _iter_superbatch(self, source):
        """Groups of ``superbatch`` consecutive batches, each field stacked
        along a new axis 0; a batch whose shapes differ from the group so
        far (a short last batch) flushes the group first, and a short last
        group is yielded too."""

        def stack(buf):
            return _map(lambda *xs: np.stack([np.asarray(x) for x in xs],
                                             axis=0), *buf)

        buf, sig = [], None
        for batch in source:
            s = tuple(repr(getattr(x, "shape", type(x)))
                      for x in _leaves(batch))
            if buf and s != sig:
                yield stack(buf)
                buf = []
            sig = s
            buf.append(batch)
            if len(buf) == self.superbatch:
                yield stack(buf)
                buf = []
        if buf:
            yield stack(buf)

    def _batch_span(self, batch) -> int:
        """Sampler-batches a delivered item stands for: 1, or with
        superbatch > 1 the stacked group's leading dim."""
        if self.superbatch <= 1:
            return 1
        first = next(_leaves(batch), None)
        if first is not None and getattr(first, "shape", None):
            return int(first.shape[0])
        return 1

    def state_dict(self) -> dict:
        """In-epoch position + shuffle-seed snapshot for exact resume."""
        if self._iterable_mode:
            raise InvalidArgumentError(
                "DataLoader over an IterableDataset cannot snapshot its "
                "position (the stream owns its own state)")
        out = {"delivered": int(self._delivered),
               "exhausted": bool(self._exhausted)}
        bs_state = self.batch_sampler.state_dict()
        # the sampler-side count runs ahead of the consumer under prefetch
        bs_state["next_batch"] = int(self._delivered)
        out["batch_sampler"] = bs_state
        return out

    def set_state_dict(self, state: dict) -> None:
        """Arm the NEXT ``__iter__`` to resume from ``state``; a snapshot
        taken between epochs arms nothing."""
        if self._iterable_mode:
            raise InvalidArgumentError(
                "DataLoader over an IterableDataset cannot restore a "
                "position snapshot")
        if state.get("exhausted", False):
            self._pending = None
            return
        self._pending = dict(state)

    def __iter__(self):
        pending, self._pending = self._pending, None
        base = 0
        if pending is not None:
            self.batch_sampler.set_state_dict(
                pending.get("batch_sampler", {}))
            base = int(pending.get("delivered", 0))
        if self._iterable_mode:
            source = self._iter_iterable()
        elif self.num_workers > 0:
            source = self._iter_workers()
        else:
            source = self._iter_sync()
        if self.superbatch > 1:
            source = self._iter_superbatch(source)
        if self.return_numpy:
            it = iter(source)
        else:
            device = resolve_device(self.places)
            if self.use_buffer_reader:
                it = _StagingIterator(source, self.prefetch_factor, device)
            else:
                it = (_map(lambda a: _to_device(a, device), b)
                      for b in source)
        if self._iterable_mode:
            return it  # no positional state to track on a raw stream
        return _CountingIterator(it, self, base)
