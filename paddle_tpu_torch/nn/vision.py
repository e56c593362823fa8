"""``paddle.nn.vision``: ``PixelShuffle`` (which lives in ``common.py``),
as in the JAX package."""
from .common import PixelShuffle  # noqa: F401

__all__ = ["PixelShuffle"]
