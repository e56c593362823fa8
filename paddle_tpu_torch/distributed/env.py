"""Process / rank environment and rendezvous (port of
``paddle_tpu.distributed.env``).

The JAX package runs one controller per host; the port runs one process
per rank on ``torch.distributed``, as PyTorch and the reference Paddle
do.  The launch environment is the JAX package's: ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``COORDINATOR_ADDRESS``, ``PADDLE_TPU_GANG_DIR``,
``PADDLE_TPU_GANG_TRANSPORT`` and ``PADDLE_TPU_INIT_TIMEOUT_S``, checked
up front by the same :func:`validate_env`.  The rendezvous is a TCP store
at the coordinator address (or the first endpoint), else a ``FileStore``
in ``PADDLE_TPU_GANG_DIR``; a one-rank world joins an in-process store.

The backend is ``nccl`` when the port's device is a CUDA card (one card a
rank: ``cuda:<local rank>``) and ``gloo`` on the CPU; ``backend=`` (or
``PADDLE_DISTRI_BACKEND``) names it explicitly, for example ``gloo`` for
ranks that share one card.  Nothing switches the backend on its own: a
group that fails to form raises.  Every group gets the timeout of
``PADDLE_TPU_INIT_TIMEOUT_S`` (300 s by default).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..framework.errors import InvalidArgumentError

__all__ = [
    "ParallelEnv",
    "init_parallel_env",
    "validate_env",
    "get_rank",
    "get_world_size",
    "is_initialized",
    "process_index",
    "process_count",
]

ENV_GANG_TRANSPORT = "PADDLE_TPU_GANG_TRANSPORT"
ENV_GANG_DIR = "PADDLE_TPU_GANG_DIR"
ENV_INIT_TIMEOUT = "PADDLE_TPU_INIT_TIMEOUT_S"
ENV_BACKEND = "PADDLE_DISTRI_BACKEND"
ENV_LOCAL_RANK = "PADDLE_RANK_IN_NODE"
BACKENDS = ("nccl", "gloo")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        return int(raw)
    except ValueError:
        raise InvalidArgumentError(
            f"{name}={raw!r} is not an integer") from None


def validate_env(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 ) -> Tuple[Optional[str], int, int]:
    """Parse and cross-check the launch env; returns ``(addr, nproc,
    pid)``.  Every inconsistency raises :class:`InvalidArgumentError`
    naming the offending variable, with the JAX package's texts."""
    eps_raw = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    endpoints = [e.strip() for e in eps_raw.split(",") if e.strip()]

    explicit_coord = bool(coordinator_address
                          or os.environ.get("COORDINATOR_ADDRESS"))
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and endpoints:
        addr = endpoints[0]

    nproc = (num_processes if num_processes is not None
             else _env_int("PADDLE_TRAINERS_NUM", 0))
    if nproc is None:
        nproc = 0
    if num_processes is None and os.environ.get("PADDLE_TRAINERS_NUM") \
            and nproc < 1:
        raise InvalidArgumentError(
            f"PADDLE_TRAINERS_NUM={nproc} must be >= 1")
    pid = (process_id if process_id is not None
           else _env_int("PADDLE_TRAINER_ID", 0))

    world = nproc if nproc > 0 else (len(endpoints) or 1)
    if not 0 <= pid < max(world, 1):
        raise InvalidArgumentError(
            f"PADDLE_TRAINER_ID={pid} out of range [0, {world}) — "
            "check PADDLE_TRAINER_ID against PADDLE_TRAINERS_NUM")
    if endpoints and nproc > 0 and len(endpoints) != nproc \
            and not explicit_coord:
        raise InvalidArgumentError(
            f"PADDLE_TRAINER_ENDPOINTS lists {len(endpoints)} endpoints "
            f"but PADDLE_TRAINERS_NUM={nproc} — every rank needs exactly "
            "one endpoint")
    if len(set(endpoints)) != len(endpoints):
        dups = sorted({e for e in endpoints if endpoints.count(e) > 1})
        raise InvalidArgumentError(
            f"PADDLE_TRAINER_ENDPOINTS contains duplicate endpoint(s) "
            f"{dups} — two ranks cannot share an address")
    if addr is not None:
        host, _, port = addr.partition(":")
        if not host or not port or not port.isdigit():
            name = ("COORDINATOR_ADDRESS"
                    if coordinator_address or os.environ.get(
                        "COORDINATOR_ADDRESS")
                    else "PADDLE_TRAINER_ENDPOINTS")
            raise InvalidArgumentError(
                f"{name}={addr!r} is not host:port")
    transport = os.environ.get(ENV_GANG_TRANSPORT, "auto").lower()
    if transport not in ("auto", "jax", "file"):
        raise InvalidArgumentError(
            f"{ENV_GANG_TRANSPORT}={transport!r} must be one of "
            "auto|jax|file")
    if world > 1 and addr is None and transport != "file" \
            and not os.environ.get(ENV_GANG_DIR):
        raise InvalidArgumentError(
            f"PADDLE_TRAINERS_NUM={world} but neither COORDINATOR_ADDRESS "
            f"nor PADDLE_TRAINER_ENDPOINTS (nor a {ENV_GANG_DIR} for the "
            "file transport) is set — multi-host needs a rendezvous point")
    if transport == "file" and world > 1 \
            and not os.environ.get(ENV_GANG_DIR):
        raise InvalidArgumentError(
            f"{ENV_GANG_TRANSPORT}=file needs {ENV_GANG_DIR} to point at "
            "a directory shared by all ranks")
    return addr, world, pid


def _timeout() -> datetime.timedelta:
    raw = os.environ.get(ENV_INIT_TIMEOUT, "300") or "300"
    try:
        seconds = float(raw)
    except ValueError:
        raise InvalidArgumentError(
            f"{ENV_INIT_TIMEOUT}={raw!r} is not a number") from None
    return datetime.timedelta(seconds=seconds)


def _resolve_backend(backend: Optional[str]) -> str:
    backend = (backend or os.environ.get(ENV_BACKEND) or "").lower()
    if not backend:
        from ..framework.device import default_device

        backend = "nccl" if default_device().type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise InvalidArgumentError(
            f"backend {backend!r} must be one of {BACKENDS}")
    return backend


def _local_rank(pid: int) -> int:
    return _env_int(ENV_LOCAL_RANK, pid)


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      backend: Optional[str] = None):
    """Join the process group this rank's environment describes and
    return a :class:`ParallelEnv`.  A second call returns at once.

    ``nccl`` puts this rank on ``cuda:<local rank>`` (``set_device``);
    ``gloo`` leaves the device as it is (the CPU, or a card that several
    ranks share)."""
    if dist.is_initialized():
        return ParallelEnv()
    addr, world, pid = validate_env(coordinator_address, num_processes,
                                    process_id)
    backend = _resolve_backend(backend)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise InvalidArgumentError(
                "backend 'nccl' needs a CUDA card; pass backend='gloo' to "
                "run the ranks on the CPU")
        from ..framework.device import set_device

        index = _local_rank(pid)
        torch.cuda.set_device(index)
        set_device(f"cuda:{index}")
    kw = dict(backend=backend, rank=pid, world_size=world,
              timeout=_timeout())
    if world == 1 and addr is None and not os.environ.get(ENV_GANG_DIR):
        dist.init_process_group(store=dist.HashStore(), **kw)
    elif addr is not None:
        dist.init_process_group(init_method=f"tcp://{addr}", **kw)
    else:
        store = os.path.join(os.environ[ENV_GANG_DIR], "torch_store")
        dist.init_process_group(init_method=f"file://{store}", **kw)
    return ParallelEnv()


def is_initialized() -> bool:
    return dist.is_initialized()


def backend() -> Optional[str]:
    """The process group's backend, ``None`` before
    :func:`init_parallel_env`."""
    return dist.get_backend() if dist.is_initialized() else None


def process_index() -> int:
    """This process's rank in the joined group (0 before
    :func:`init_parallel_env`, as JAX's ``process_index``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """Number of ranks in the joined group (1 before
    :func:`init_parallel_env`)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return process_index()


def get_world_size() -> int:
    """Number of ranks — one device a rank, so also the number of
    devices the mesh spans."""
    return process_count()


class ParallelEnv:
    """Parity: paddle.distributed.ParallelEnv (fluid/dygraph/parallel.py:62)."""

    @property
    def rank(self) -> int:
        return process_index()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return _local_rank(process_index())

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def device_id(self) -> int:
        if backend() == "nccl":
            return torch.cuda.current_device()
        return 0

    @property
    def local_devices(self):
        from ..framework.device import default_device

        return [default_device()]

    @property
    def current_endpoint(self) -> str:
        eps = self.trainer_endpoints
        i = process_index()
        return eps[i] if i < len(eps) else ""

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []
