"""``InMemoryDataset`` / ``MultiSlotInMemoryDataset`` — not ported yet.

The JAX package's file-sharded native ingest (``paddle_tpu.io.
in_memory_dataset`` over its C++ engine) goes with bench config 5 (ROADMAP
queue A, training step); both names raise ``UnimplementedError`` here.
"""
from __future__ import annotations

from ..framework.errors import UnimplementedError

__all__ = ["InMemoryDataset", "MultiSlotInMemoryDataset"]


class InMemoryDataset:
    def __init__(self, *args, **kwargs):
        raise UnimplementedError(
            f"{type(self).__name__} is not ported yet (ROADMAP queue A, "
            f"training step: io/in_memory_dataset.py with bench config 5)")


class MultiSlotInMemoryDataset(InMemoryDataset):
    pass
