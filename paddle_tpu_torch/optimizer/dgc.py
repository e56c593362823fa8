"""``DGCMomentum`` — deep gradient compression (port of
``paddle_tpu.optimizer.dgc``): top-k sparsification of the gradients
exchanged between data-parallel replicas, so it belongs to distributed
execution and raises ``UnimplementedError`` until that is ported."""
from __future__ import annotations

from ..framework.errors import UnimplementedError
from .optimizer import Optimizer

__all__ = ["DGCMomentum"]


class DGCMomentum(Optimizer):
    def __init__(self, *args, **kwargs):
        raise UnimplementedError(
            "DGCMomentum compresses the gradients replicas exchange; it is "
            "not ported yet (ROADMAP queue A, distributed execution)")
