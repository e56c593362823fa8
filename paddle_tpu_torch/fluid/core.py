"""paddle.fluid.core — the pybind module's Python-visible surface (port of
``paddle_tpu.fluid.core``): the places, flag access, device queries,
``EOFException`` and the ``core.ops`` shim (the generated per-op fast
path does not exist: its names raise, pointing at the public API)."""
from __future__ import annotations

import torch

from ..framework.device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace, XPUPlace,
)
from ..framework.errors import UnimplementedError
from ..framework.flags import get_flags, set_flags  # noqa: F401


def is_compiled_with_cuda() -> bool:
    from ..framework.device import is_compiled_with_cuda as f

    return f()


def is_compiled_with_xpu() -> bool:
    return False


def get_cuda_device_count() -> int:
    return torch.cuda.device_count()


def globals():  # noqa: A001  (reference name: core.globals() flag map)
    """Read-only mapping of the ``FLAGS_*`` values."""
    from ..framework import flags as _flags

    return {f"FLAGS_{k}" if not k.startswith("FLAGS_") else k: v["value"]
            for k, v in _flags._REGISTRY.items()}


class _OpsShim:
    """core.ops.* — the reference's generated per-op C functions."""

    def __getattr__(self, name):
        raise UnimplementedError(
            f"core.ops.{name}: the generated pybind fast path does not "
            f"exist — call the public API (paddle.{name} / "
            f"paddle.nn.functional.{name})")


ops = _OpsShim()


class EOFException(Exception):
    """Raised when a started reader's pass ends (the Python
    ``fluid.core.EOFException`` 1.x training loops catch)."""
