"""High-level API of the port (``paddle.Model``)."""
from .model import Model

__all__ = ["Model"]
