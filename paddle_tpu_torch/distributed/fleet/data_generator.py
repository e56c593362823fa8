"""fleet.data_generator — user-defined sample → MultiSlot text pipeline.

Parity: python/paddle/distributed/fleet/data_generator/data_generator.py
(DataGenerator:19, MultiSlotStringDataGenerator:232,
MultiSlotDataGenerator:273).  Users subclass and implement
``generate_sample(line)``; ``run_from_stdin`` streams parsed samples to
stdout in the ``<len> id id ...`` MultiSlot format — the preprocessing
half of the CTR ingest pipeline, feeding files that
paddle.io.InMemoryDataset (native/ingest.cc) then loads and shuffles.

Port of ``paddle_tpu.distributed.fleet.data_generator``, copied: it is
host-only and imports no JAX.
"""
from __future__ import annotations

import sys

from ...framework.errors import InvalidArgumentError

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    """Base class: subclass and implement ``generate_sample`` (and
    optionally ``generate_batch``)."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def generate_sample(self, line):
        """→ a no-arg iterator yielding [(slot_name, [values]), ...]
        per sample (None entries are skipped)."""
        raise NotImplementedError(
            "implement generate_sample(line) returning a local iterator")

    def generate_batch(self, samples):
        """Optional batch-level hook; default passes samples through."""

        def local_iter():
            for sample in samples:
                yield sample

        return local_iter

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator / MultiSlotStringDataGenerator "
            "(or implement _gen_str for a custom feed format)")

    def _drain(self, batch_samples, out):
        for sample in self.generate_batch(batch_samples)():
            out.write(self._gen_str(sample))

    def run_from_memory(self, out=None):
        """Emit from generate_sample(None) — debugging/benchmarks
        (ref :57)."""
        out = out or sys.stdout
        batch = []
        for sample in self.generate_sample(None)():
            if sample is None:
                continue
            batch.append(sample)
            if len(batch) == self.batch_size_:
                self._drain(batch, out)
                batch = []
        if batch:
            self._drain(batch, out)

    def run_from_stdin(self, source=None, out=None):
        """Line-streamed parse → MultiSlot text on stdout (ref :92).
        ``source``/``out`` are injectable for tests; defaults are the
        reference's stdin/stdout."""
        source = source or sys.stdin
        out = out or sys.stdout
        batch = []
        for line in source:
            for sample in self.generate_sample(line)():
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size_:
                    self._drain(batch, out)
                    batch = []
        if batch:
            self._drain(batch, out)


def _check_slots(line):
    if not isinstance(line, (list, tuple)):
        raise InvalidArgumentError(
            "the output of generate_sample must be a list/tuple of "
            "(slot_name, values) pairs, e.g. "
            "[('words', [1926, 8, 17]), ('label', [1])]")


class MultiSlotStringDataGenerator(DataGenerator):
    """String feasigns, no type checking (ref :232): fastest emit path."""

    def _gen_str(self, line):
        _check_slots(line)
        parts = []
        for name, elements in line:
            parts.append(" ".join([str(len(elements)), *elements]))
        return " ".join(parts) + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """Typed feasigns (ref :273): first sample fixes each slot's type
    (int → uint64 slot, float promotes the slot to float); later samples
    must match the slot order and arity."""

    def _gen_str(self, line):
        _check_slots(line)
        if self._proto_info is None:
            self._proto_info = []
            for name, elements in line:
                dtype = "uint64"
                for v in elements:
                    if isinstance(v, float):
                        dtype = "float"
                    elif not isinstance(v, int):
                        raise InvalidArgumentError(
                            f"slot {name!r}: feasigns must be int or "
                            f"float, got {type(v).__name__}")
                self._proto_info.append((name, dtype))
        else:
            if len(line) != len(self._proto_info):
                raise InvalidArgumentError(
                    f"expected {len(self._proto_info)} slots "
                    f"(as in the first sample), got {len(line)}")
            for (name, elements), (pname, ptype) in zip(line,
                                                        self._proto_info):
                if name != pname:
                    raise InvalidArgumentError(
                        f"slot order changed: expected {pname!r}, "
                        f"got {name!r}")
        parts = []
        for name, elements in line:
            parts.append(" ".join([str(len(elements)),
                                   *(str(v) for v in elements)]))
        return " ".join(parts) + "\n"
