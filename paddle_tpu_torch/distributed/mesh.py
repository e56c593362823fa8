"""The hybrid-parallel rank mesh (port of ``paddle_tpu.distributed.mesh``).

Ranks are laid out as the JAX package lays out devices, outer to inner
``("pipe", "data", "sharding", "sep", "expert", "model")``: rank ``r`` sits
at the coordinates of ``r`` in that C-order array.  Every axis slice this
rank belongs to is one ``torch.distributed`` process group
(:class:`AxisGroup`), built once, by every rank in the same order, when a
mesh is built over the joined world; so is the data-parallel slice over
``data`` x ``sharding`` (:func:`data_axes`).  ``Mesh``, ``NamedSharding``
and ``PartitionSpec`` are small classes of the port's own;
``PartitionSpec`` is the annotation a parameter's ``partition_spec``
holds.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

from ..framework.errors import InvalidArgumentError

__all__ = [
    "AXIS_ORDER",
    "build_mesh",
    "get_mesh",
    "set_mesh",
    "mesh_axis_size",
    "data_axes",
    "suppress_constraints",
    "constraints_suppressed",
    "PartitionSpec",
    "NamedSharding",
    "Mesh",
    "AxisGroup",
]

# canonical axis names, outer→inner
AXIS_ORDER = ("pipe", "data", "sharding", "sep", "expert", "model")

_global_mesh: Optional["Mesh"] = None


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (``None`` = not sharded), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class AxisGroup:
    """This rank's slice along one or more mesh axes: the global ``ranks``
    in slice order, this rank's ``index`` in it, and the process group
    (``None`` for a one-rank slice, whose collectives are copies)."""

    def __init__(self, axes: Tuple[str, ...], ranks: List[int], index: int,
                 pg=None):
        self.axes = axes
        self.ranks = ranks
        self.index = index
        self.pg = pg

    @property
    def axis(self) -> Union[str, Tuple[str, ...]]:
        return self.axes[0] if len(self.axes) == 1 else self.axes

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self):
        return (f"AxisGroup(axes={self.axes}, ranks={self.ranks}, "
                f"index={self.index})")


class Mesh:
    """Named axes over ranks: ``devices`` is the int array of ranks in
    ``AXIS_ORDER`` shape, ``shape`` the ``{axis: size}`` mapping."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise InvalidArgumentError(
                f"mesh array of rank {self.devices.ndim} for axes "
                f"{self.axis_names}")
        self.shape: Dict[str, int] = OrderedDict(
            zip(self.axis_names, self.devices.shape))
        self._groups: Dict[Tuple[str, ...], AxisGroup] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """The axis coordinates of ``rank``."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise InvalidArgumentError(f"rank {rank} is not in this mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_index(self, axis: str, rank: Optional[int] = None) -> int:
        from .env import process_index

        return self.coords(process_index() if rank is None else rank)[axis]

    def _slices(self, axes: Tuple[str, ...]):
        """Every slice along ``axes``: lists of ranks, ``axes`` varying
        (C order among them), the other axes fixed."""
        dims = [self.axis_names.index(a) for a in axes]
        others = [i for i in range(len(self.axis_names)) if i not in dims]
        arr = np.transpose(self.devices, others + dims)
        lead = int(np.prod([self.devices.shape[i] for i in others]))
        return [list(map(int, row)) for row in arr.reshape(lead, -1)]

    def build_groups(self, extra: Sequence[Tuple[str, ...]] = ()):
        """Create the process groups of every axis of size > 1 and of the
        ``extra`` axis combinations, once, in one order on every rank (a
        ``new_group`` is a collective of the whole world)."""
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return
        if dist.get_world_size() != self.size:
            raise InvalidArgumentError(
                f"mesh of {self.size} ranks over a world of "
                f"{dist.get_world_size()}")
        me = dist.get_rank()
        wanted = [(a,) for a in self.axis_names if self.shape[a] > 1]
        wanted += [tuple(c) for c in extra
                   if tuple(c) not in wanted
                   and int(np.prod([self.shape[a] for a in c])) > 1]
        for axes in wanted:
            if axes in self._groups:
                continue
            for ranks in self._slices(axes):
                if len(ranks) == self.size:
                    pg = dist.group.WORLD
                else:
                    pg = dist.new_group(ranks)
                if me in ranks:
                    self._groups[axes] = AxisGroup(axes, ranks,
                                                   ranks.index(me), pg)

    def group(self, axes: Union[str, Sequence[str]]) -> AxisGroup:
        """This rank's slice along ``axes`` (one axis name or several)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise InvalidArgumentError(
                    f"unknown mesh axis {a!r} (have {self.axis_names})")
        axes = tuple(a for a in axes if self.shape[a] > 1) or axes[:1]
        got = self._groups.get(axes)
        if got is not None:
            return got
        from .env import process_index

        me = process_index()
        for ranks in self._slices(axes):
            if me in ranks:
                if (len(ranks) > 1 and dist.is_initialized()
                        and len(ranks) == dist.get_world_size()):
                    got = self._groups[axes] = AxisGroup(
                        axes, ranks, ranks.index(me), dist.group.WORLD)
                    return got
                if len(ranks) > 1:
                    raise InvalidArgumentError(
                        f"no process group for mesh axes {axes}: build the "
                        f"mesh after init_parallel_env()")
                # a joined one-rank world still runs its collectives
                # through its backend; a one-rank slice of a larger world
                # copies
                solo = dist.is_initialized() and dist.get_world_size() == 1
                return AxisGroup(axes, ranks, 0,
                                 dist.group.WORLD if solo else None)
        raise InvalidArgumentError(f"rank {me} is not in this mesh")

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"


class NamedSharding:
    """A ``PartitionSpec`` over a ``Mesh`` (the annotation; placing is
    ``fleet.ShardingPlan``'s)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def is_fully_replicated(self) -> bool:
        return all(a is None or self.mesh.shape.get(a, 1) == 1
                   for a in self.spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def build_mesh(
    dp: int = 0,
    mp: int = 1,
    pp: int = 1,
    sep: int = 1,
    sharding: int = 1,
    ep: int = 1,
    devices: Optional[Sequence[int]] = None,
    allow_dcn_inner: bool = False,
) -> Mesh:
    """Construct the hybrid-parallel mesh over ``devices`` (ranks; all of
    the world by default).  ``dp=0`` means "all remaining ranks"; degrees
    multiply to the rank count.  Over a joined world the process groups
    are built here.  ``allow_dcn_inner`` is accepted for signature parity
    (one process is one device, so no axis straddles a host's devices)."""
    if devices is None:
        from .env import get_world_size

        devices = list(range(get_world_size()))
    else:
        devices = list(devices)
    n = len(devices)
    fixed = mp * pp * sep * sharding * ep
    if fixed <= 0:
        raise InvalidArgumentError("parallel degrees must be positive")
    if dp in (0, -1, None):
        if n % fixed != 0:
            raise InvalidArgumentError(
                f"device count {n} not divisible by mp*pp*sep*sharding*ep="
                f"{fixed}"
            )
        dp = n // fixed
    if dp * fixed != n:
        raise InvalidArgumentError(
            f"dp*mp*pp*sep*sharding*ep = {dp * fixed} != device count {n}"
        )
    sizes = {"pipe": pp, "data": dp, "sharding": sharding, "sep": sep,
             "expert": ep, "model": mp}
    shape = [sizes[a] for a in AXIS_ORDER]
    mesh = Mesh(np.asarray(devices).reshape(shape), AXIS_ORDER)
    if dist.is_initialized() and sorted(devices) == list(
            range(dist.get_world_size())):
        mesh.build_groups(extra=[("data", "sharding")])
    return mesh


def set_mesh(mesh: Mesh):
    global _global_mesh
    _global_mesh = mesh
    return mesh


def get_mesh() -> Mesh:
    """The active global mesh; defaults to pure data parallelism over all
    ranks (every rank in the ``data`` axis)."""
    global _global_mesh
    if _global_mesh is None:
        _global_mesh = build_mesh()
    return _global_mesh


def mesh_axis_size(axis: str, mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or get_mesh()
    return mesh.shape[axis]


_suppress_tls = threading.local()


def constraints_suppressed() -> bool:
    """True while inside a :func:`suppress_constraints` scope (per
    thread)."""
    return getattr(_suppress_tls, "depth", 0) > 0


@contextlib.contextmanager
def suppress_constraints():
    """Scope in which ``meta_parallel.constrain`` does nothing (the JAX
    package's seam for fully-manual ``shard_map`` bodies; kept so code
    written for it runs)."""
    _suppress_tls.depth = getattr(_suppress_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _suppress_tls.depth -= 1


def data_axes(mesh: Optional[Mesh] = None) -> List[str]:
    """Axes a global batch is split over: data + (ZeRO) sharding — the
    sharding axis is data-parallel for the forward pass."""
    mesh = mesh or get_mesh()
    return [a for a in ("data", "sharding")
            if mesh.shape.get(a, 1) > 1] or ["data"]

