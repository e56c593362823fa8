"""paddle_tpu_torch.distributed — collectives, mesh, fleet, parallel
layers (port of ``paddle_tpu.distributed``).

One process per rank on ``torch.distributed`` (NCCL between cards, gloo
on the CPU or for ranks sharing a card); the JAX package's stacked
single-controller collectives become per-rank calls that return this
rank's slot (``collective``).  Pipeline parallelism runs an explicit
per-rank schedule over the ``pipe`` axis (``pipeline_parallel``).  Not
ported yet (ROADMAP queue A, control plane and operations): the gang /
heartbeat supervisor (fault tolerance); of ``gang`` only ``mean_trees``
is here.
"""
from .env import (  # noqa: F401
    ParallelEnv,
    init_parallel_env,
    validate_env,
    get_rank,
    get_world_size,
    is_initialized,
    process_index,
    process_count,
)
from .mesh import (  # noqa: F401
    build_mesh,
    get_mesh,
    set_mesh,
    mesh_axis_size,
    Mesh,
    NamedSharding,
    PartitionSpec,
)
from .collective import (  # noqa: F401
    ReduceOp,
    all_reduce,
    all_gather,
    reduce,
    broadcast,
    scatter,
    alltoall,
    barrier,
    psum,
    pmean,
    pmax,
    pmin,
    ppermute,
    all_to_all_single,
    collective_stats,
    reset_collective_stats,
)
from .parallel import (  # noqa: F401
    DataParallel,
    spawn,
    shard_batch,
    GANG_RESTART_EXIT_CODE,
    RESTART_STORM_EXIT_CODE,
)
from ..static.builders import unported as _unported

_ITEM7 = "control plane and operations"
gang_transport = _unported("distributed.gang_transport", _ITEM7)
Gang = _unported("distributed.Gang", _ITEM7)
FileTransport = _unported("distributed.FileTransport", _ITEM7)
KVStoreTransport = _unported("distributed.KVStoreTransport", _ITEM7)
default_gang = _unported("distributed.default_gang", _ITEM7)
current_gang = _unported("distributed.current_gang", _ITEM7)
set_gang = _unported("distributed.set_gang", _ITEM7)


def prepare_context(strategy=None):
    """Legacy dygraph-DP bootstrap (ref: fluid/dygraph/parallel.py:34) —
    the modern entry is init_parallel_env.  Returns None single-process,
    else joins the group like the reference (which also returns None
    when nranks < 2)."""
    env = ParallelEnv()
    if env.world_size < 2:
        return None
    init_parallel_env()
    return strategy


from ..nn.recompute import recompute  # noqa: F401,E402
from . import launch  # noqa: F401,E402
from . import fleet  # noqa: F401,E402
from . import meta_parallel  # noqa: F401,E402
from . import pipeline_parallel  # noqa: F401,E402
from .gang import mean_trees  # noqa: F401,E402
from .pipeline_parallel import (  # noqa: F401,E402
    pipeline_blocks,
    pipeline_degree,
    pipeline_train_step,
    ring_buffer_slots,
)
from .sequence_parallel import (  # noqa: F401,E402
    ring_attention,
    ulysses_attention,
    ring_attention_sharded,
    ulysses_attention_sharded,
)
