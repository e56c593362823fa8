"""High-level API of the port (``paddle.Model`` and its callbacks)."""
from . import callbacks
from .model import Model

__all__ = ["Model", "callbacks"]
