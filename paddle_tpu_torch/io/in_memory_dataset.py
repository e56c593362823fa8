"""InMemoryDataset — file-sharded native ingest with a global shuffle
(port of ``paddle_tpu.io.in_memory_dataset``).

C++ reader threads parse a file list straight into an in-memory store,
the store is shuffled, and minibatches are assembled natively — Python
never touches individual samples.  The engine is the port's copy of the
JAX package's (``paddle_tpu_torch/native/ingest.cc``, built with ``g++`` on
first use), so the same files and seed give the same batches, in the same
order, in both packages.  Batches are numpy arrays; ``Model.train_batch``
moves them to the network's device.

Usage::

    ds = InMemoryDataset(slots=[("sparse", 8, "int64"),
                                ("dense", 8, "float32"),
                                ("label", 1, "float32")])
    ds.set_filelist(["part-0.txt", "part-1.txt"])   # numeric text columns
    ds.load_into_memory(thread_num=8)
    ds.global_shuffle(seed=7)
    for sparse, dense, label in ds.batch_iter(batch_size=256):
        model.train_batch([sparse, dense], [label])
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..framework.errors import InvalidArgumentError, NotFoundError
from ..framework.flags import flag

__all__ = ["InMemoryDataset", "MultiSlotInMemoryDataset"]


class _IngestStoreBase:
    """What both datasets share over one native store handle: the file
    list, the threaded load, the shuffle, the size and the release."""

    def set_filelist(self, files: Sequence[str]):
        self._filelist = [str(f) for f in files]

    def load_into_memory(self, thread_num: Optional[int] = None) -> int:
        """Parse the file list with ``thread_num`` native readers (default
        ``FLAGS_paddle_num_threads``); returns the samples added.  Raises
        ``NotFoundError`` for a missing file and ``InvalidArgumentError``
        with file:line for a malformed one."""
        if thread_num is None:
            thread_num = max(int(flag("paddle_num_threads")), 1)
        if not self._filelist:
            raise InvalidArgumentError("set_filelist() first")
        arr = (ctypes.c_char_p * len(self._filelist))(
            *[f.encode() for f in self._filelist])
        n = self._lib.ingest_load(self._h, arr, len(self._filelist),
                                  int(thread_num))
        if n < 0:
            msg = self._lib.ingest_error(self._h).decode()
            exc = NotFoundError if "cannot open" in msg \
                else InvalidArgumentError
            raise exc(f"load_into_memory: {msg}")
        return int(n)

    def global_shuffle(self, seed: int = 0):
        """Shuffle the whole store (one host: one permutation)."""
        self._lib.ingest_shuffle(self._h, int(seed) & (2 ** 64 - 1))

    local_shuffle = global_shuffle  # one store per host

    def get_memory_data_size(self) -> int:
        return int(self._lib.ingest_size(self._h))

    def release_memory(self):
        self._lib.ingest_clear(self._h)
        self._filelist = []

    def __len__(self) -> int:
        return self.get_memory_data_size()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and getattr(self, "_lib", None):
            self._lib.ingest_destroy(h)

    def __iter__(self):
        raise InvalidArgumentError(
            "iterate with batch_iter(batch_size=...) — sample-wise Python "
            "iteration would defeat the native batch path")


class InMemoryDataset(_IngestStoreBase):
    """``slots``: ordered ``(name, width, dtype)`` column groups; every
    input line must hold exactly ``sum(width)`` numeric fields (stored as
    float64: integer ids are exact up to 2^53)."""

    def __init__(self, slots: Sequence[Tuple[str, int, str]]):
        from ..native import ingest_lib

        if not slots:
            raise InvalidArgumentError("need at least one slot")
        self._slots = [(str(n), int(w), np.dtype(d)) for n, w, d in slots]
        for n, w, _ in self._slots:
            if w <= 0:
                raise InvalidArgumentError(f"slot {n!r} width must be > 0")
        self._ncols = sum(w for _, w, _ in self._slots)
        self._lib = ingest_lib()
        self._h = self._lib.ingest_create(self._ncols)
        if not self._h:
            raise MemoryError("ingest_create failed")
        self._filelist: List[str] = []

    def batch_iter(self, batch_size: int, drop_last: bool = False
                   ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Minibatches assembled natively: one array a slot (``[b,
        width]``, the slot's dtype).  Each call starts its own pass over
        the current permutation: iterators own their cursor."""
        if batch_size <= 0:
            raise InvalidArgumentError("batch_size must be > 0")
        return self._batch_gen(int(batch_size), bool(drop_last))

    def _batch_gen(self, batch_size, drop_last):
        buf = np.empty((batch_size, self._ncols), np.float64)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        pos = 0
        while True:
            got = self._lib.ingest_copy_rows(self._h, ptr, pos, batch_size)
            if got <= 0:
                return
            pos += got
            if got < batch_size and drop_last:
                return
            rows = buf[:got]
            out = []
            col = 0
            for _, w, dt in self._slots:
                out.append(np.ascontiguousarray(
                    rows[:, col:col + w]).astype(dt))
                col += w
            yield tuple(out)


class MultiSlotInMemoryDataset(_IngestStoreBase):
    """Typed multi-slot ingest over the MultiSlot text format (per declared
    slot, ``<count> v1 ... vcount`` on each line).  ``slots``: ordered
    ``(name, dtype, max_len)`` with dtype ``"float32"`` or ``"int64"``;
    variable-length slots come back as zero-padded ``[b, max_len]`` values
    (and ``[b]`` lengths with ``return_lens``); values keep their declared
    dtype (int64 ids exact at full width)."""

    _TYPE_TAGS = {"float32": 0, "int64": 1}

    def __init__(self, slots):
        from ..native import ingest_lib

        if not slots:
            raise InvalidArgumentError("need at least one slot")
        self._slots = []
        for n, dt, ml in slots:
            if dt not in self._TYPE_TAGS:
                raise InvalidArgumentError(
                    f"slot {n!r} dtype must be float32/int64, got {dt!r}")
            if int(ml) <= 0:
                raise InvalidArgumentError(f"slot {n!r} max_len must be > 0")
            self._slots.append((str(n), str(dt), int(ml)))
        self._lib = ingest_lib()
        n = len(self._slots)
        types = (ctypes.c_int64 * n)(*[self._TYPE_TAGS[d]
                                       for _, d, _ in self._slots])
        lens = (ctypes.c_int64 * n)(*[ml for _, _, ml in self._slots])
        self._h = self._lib.ingest_create_multislot(n, types, lens)
        if not self._h:
            raise MemoryError("ingest_create_multislot failed")
        self._filelist: List[str] = []

    def batch_iter(self, batch_size: int, drop_last: bool = False,
                   return_lens: bool = False):
        """Yields a tuple with one ``values`` array a slot, or ``(values,
        lens)`` pairs with ``return_lens``."""
        if batch_size <= 0:
            raise InvalidArgumentError("batch_size must be > 0")
        return self._batch_gen(int(batch_size), bool(drop_last),
                               bool(return_lens))

    def _batch_gen(self, batch_size, drop_last, return_lens):
        np_dt = {"float32": np.float32, "int64": np.int64}
        bufs = [np.empty((batch_size, ml), np_dt[dt])
                for _, dt, ml in self._slots]
        lbufs = [np.empty((batch_size,), np.int64) for _ in self._slots]
        pos = 0
        while True:
            got = None
            for si in range(len(self._slots)):
                g = self._lib.ingest_copy_slot(
                    self._h, si, pos, batch_size,
                    bufs[si].ctypes.data_as(ctypes.c_void_p),
                    lbufs[si].ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int64)))
                if got is None:
                    got = g
                elif g != got:  # engine invariant: slots advance together
                    raise InvalidArgumentError(
                        "slot row counts diverged (corrupt store)")
            if not got:
                return
            pos += got
            if got < batch_size and drop_last:
                return
            out = []
            for si in range(len(self._slots)):
                vals = bufs[si][:got].copy()
                out.append((vals, lbufs[si][:got].copy()) if return_lens
                           else vals)
            yield tuple(out)
