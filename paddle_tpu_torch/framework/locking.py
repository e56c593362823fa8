"""Named lock wrappers (port of the two ``paddle_tpu.framework.locking``
primitives the serving layer uses).

Same API as the ``threading`` primitives plus a stable role ``name``
(``"ServingMetrics._lock"``).  The JAX package's runtime lock-order
sanitizer behind these names is not ported yet; here they are the plain
primitives.
"""
from __future__ import annotations

import threading
from typing import Optional

__all__ = ["OrderedLock", "OrderedCondition"]


class OrderedLock:
    """``threading.Lock`` with a role name."""

    __slots__ = ("_lock", "name")

    def __init__(self, name: Optional[str] = None):
        self._lock = threading.Lock()
        self.name = name or "OrderedLock"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def __repr__(self):
        return f"<OrderedLock {self.name}>"


class OrderedCondition:
    """``threading.Condition`` with a role name."""

    __slots__ = ("_cond", "name")

    def __init__(self, name: Optional[str] = None):
        self._cond = threading.Condition()
        self.name = name or "OrderedCondition"

    def __enter__(self):
        self._cond.acquire()
        return self

    def __exit__(self, *exc):
        self._cond.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._cond.wait(timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self):
        return f"<OrderedCondition {self.name}>"
