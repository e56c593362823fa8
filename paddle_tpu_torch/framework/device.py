"""Device selection for the port.

Entry points run on the CUDA card unless the caller asks for the CPU
explicitly: ``resolve_device(None)`` is ``cuda:0`` (or whatever
:func:`set_device` chose) and raises :class:`UnavailableError` when no card
is visible — it never falls back to the CPU quietly.  An explicit
``"cpu"`` passes through; that is how the tests run.

Places (port of ``paddle_tpu.framework.device``'s ``Place``): the 1.x
spelling of a device, which ``static.Executor(place)`` takes.
``CPUPlace()`` is the CPU, ``CUDAPlace(i)`` card ``i``, and
``CUDAPinnedPlace()`` pinned host memory (the CPU, for placement);
``TPUPlace`` and ``XPUPlace`` raise ``UnavailableError``, as the JAX
package raises for a device kind it does not have.
"""
from __future__ import annotations

from typing import Optional, Union

import dataclasses

import numpy as np
import torch

from .errors import InvalidArgumentError, UnavailableError

__all__ = ["set_device", "get_device", "default_device", "resolve_device",
           "upload", "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "TPUPlace", "XPUPlace", "place_device", "is_compiled_with_cuda"]

#: the device :func:`set_device` chose; None = the card
_chosen: Optional[torch.device] = None


def _parse(device: Union[str, torch.device]) -> torch.device:
    s = str(device).lower()
    if s.startswith("gpu"):
        s = "cuda" + s[3:]
    try:
        dev = torch.device(s)
    except RuntimeError as e:
        raise InvalidArgumentError(f"unknown device {device!r}") from e
    if dev.type not in ("cpu", "cuda"):
        raise InvalidArgumentError(
            f"device {device!r}: the port runs on 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise UnavailableError(
                f"device {device!r} requested but no CUDA card is visible "
                f"(pass device='cpu' to run on the CPU)")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise InvalidArgumentError(
                f"CUDA device index {index} out of range "
                f"({torch.cuda.device_count()} visible)")
        dev = torch.device("cuda", index)
    return dev


def set_device(device: Union[str, torch.device]) -> torch.device:
    """Parity: ``paddle.set_device('gpu')`` / ``('cpu')`` — the device that
    entry points called without ``device=`` run on."""
    global _chosen
    _chosen = _parse(device)
    return _chosen


def get_device() -> str:
    """Parity: ``paddle.get_device`` — e.g. ``'cuda:0'``; raises without a
    card unless :func:`set_device` chose the CPU."""
    return str(default_device())


def default_device() -> torch.device:
    """The device of an entry point called without ``device=``."""
    if _chosen is not None:
        return _chosen
    return _parse("cuda:0")


def resolve_device(device=None) -> torch.device:
    """``None`` → :func:`default_device`; anything else is parsed and
    checked (``"cpu"`` always passes)."""
    return default_device() if device is None else _parse(device)


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on ``device``, copied without
    stalling the host: to a card through pinned memory and a non-blocking
    copy, so kernels already queued keep running while the host goes on
    (the caching host allocator holds the pinned block until the copy has
    run).  On the CPU: a copy, so the caller may reuse its array.  A
    tensor already on a card is moved as ``Tensor.to`` moves it."""
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        return a.to(device)
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        # torch wants a writable buffer (a JAX array's view is read-only)
        a = torch.from_numpy(a if a.flags.writeable else a.copy())
    if device.type == "cuda":
        return a.pin_memory().to(device, non_blocking=True)
    return a.clone()


@dataclasses.dataclass(frozen=True)
class Place:
    """Device identity: kind (``"cpu"``, ``"gpu"`` or ``"pinned"``) and
    index (parity: ``platform::Place``, one dataclass for every kind)."""

    kind: str
    index: int = 0

    def __str__(self):
        return f"{self.kind}:{self.index}"

    def torch_device(self) -> torch.device:
        """The torch device of this place (pinned host memory is the
        CPU's); a card that is not visible raises."""
        if self.kind == "gpu":
            return _parse(f"cuda:{self.index}")
        return torch.device("cpu")


def CPUPlace(index: int = 0) -> Place:
    return Place("cpu", index)


def CUDAPlace(index: int = 0) -> Place:
    return Place("gpu", index)


def CUDAPinnedPlace() -> Place:
    return Place("pinned", 0)


def _no_backend(kind: str):
    raise UnavailableError(
        f"{kind}: the port runs on CUDA cards and the CPU only — use "
        f"CUDAPlace(i) or CPUPlace()")


def TPUPlace(index: int = 0) -> Place:
    _no_backend("TPUPlace")


def XPUPlace(index: int = 0) -> Place:
    _no_backend("XPUPlace")


def place_device(place=None) -> torch.device:
    """The torch device of ``place``: a :class:`Place`, a device string or
    ``torch.device``, or None (the default device: the card)."""
    if isinstance(place, Place):
        return place.torch_device()
    return resolve_device(place)


def is_compiled_with_cuda() -> bool:
    """Parity: ``paddle.is_compiled_with_cuda`` — whether this torch was
    built with CUDA (a card need not be visible)."""
    return bool(torch.backends.cuda.is_built())
