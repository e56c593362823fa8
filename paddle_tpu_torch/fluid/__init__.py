"""paddle.fluid — the 1.x root namespace (port of ``paddle_tpu.fluid``).

The 1.x build / run flow: ``Program`` / ``program_guard`` / ``data`` (a
graph feed slot, unlike ``static.data``'s InputSpec outside a guard),
``fluid.layers``' builders and functions, ``fluid.optimizer``'s 1.x
spellings with ``minimize``, and ``Executor`` (``run``, ``run_steps``)
over the places (``CPUPlace``, ``CUDAPlace``); ``ParamAttr``,
``Parameter``, ``DataLoader``, ``InMemoryDataset``, ``save`` / ``load``
(the checkpoint format of both packages), ``enable_static`` /
``disable_static`` / ``in_dygraph_mode``, ``core``, ``initializer``,
``regularizer``, ``clip``, ``unique_name``, ``io`` (the reference's
binary persistables), ``dygraph`` (the 1.x layers; ``dygraph_guard``),
``metrics`` (the 1.x accumulators) and ``contrib.slim``.

Not ported yet: ``fluid.profiler`` raises ``UnimplementedError`` on
attribute access, naming ROADMAP queue A, static graph and the long tail;
so do the LoD tensors, ``fluid.embedding`` (the builder is
``fluid.layers.embedding``) and the inference export.
"""
from __future__ import annotations

from ..framework.device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace, XPUPlace,
    is_compiled_with_cuda,
)
from ..framework.flags import get_flags, set_flags  # noqa: F401
from ..framework.serialization import load, save  # noqa: F401
from ..io import DataLoader, InMemoryDataset  # noqa: F401
from ..nn import ParamAttr, Parameter  # noqa: F401
from ..static import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy, Executor,
    ParallelExecutor, Program, Scope, Variable, WeightNormParamAttr,
    cpu_places, cuda_places, default_main_program, default_startup_program,
    global_scope, load_inference_model, load_program_state, name_scope,
    program_guard, save_inference_model, scope_guard, set_program_state,
)
from ..static.builders import unported as _unported
from ..static.graph import data  # noqa: F401  (a graph feed slot)
from ..static.graph import (  # noqa: F401
    disable_static, enable_static, in_dygraph_mode,
)
from . import clip, core, initializer, layers, optimizer  # noqa: F401
from . import param_attr, regularizer, unique_name  # noqa: F401
from . import contrib, dygraph, io, metrics  # noqa: F401
from .dygraph import guard as dygraph_guard  # noqa: F401

def is_compiled_with_tpu() -> bool:
    return False


def enable_dygraph(place=None):
    """Parity no-op: eager mode is the default; ``disable_static`` leaves
    graph-building mode."""


def disable_dygraph():
    """Parity no-op kept for source compatibility."""


def one_hot(input, depth, allow_out_of_range=False):
    return layers.one_hot(input, depth, allow_out_of_range)


_ITEM8 = "static graph and the long tail"
embedding = _unported("fluid.embedding", _ITEM8)
LoDTensor = _unported("fluid.LoDTensor", _ITEM8)
create_lod_tensor = _unported("fluid.create_lod_tensor", _ITEM8)
create_random_int_lodtensor = _unported("fluid.create_random_int_lodtensor",
                                        _ITEM8)

#: the 1.x submodules still to port
_UNPORTED_MODULES = ("profiler",)


class _UnportedModule:
    """A 1.x submodule still to port: any attribute raises
    ``UnimplementedError`` naming its ROADMAP item."""

    def __init__(self, name):
        self.__name__ = f"paddle_tpu_torch.fluid.{name}"

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        from ..framework.errors import UnimplementedError

        raise UnimplementedError(
            f"{self.__name__.replace('paddle_tpu_torch.', '')}.{attr} is "
            f"not ported yet (ROADMAP queue A, {_ITEM8})")


for _m in _UNPORTED_MODULES:
    globals()[_m] = _UnportedModule(_m)
del _m
