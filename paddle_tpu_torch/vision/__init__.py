"""Vision of the port: ``vision.models`` (the ResNet family so far; the
other models, transforms and datasets wait in ROADMAP queue A,
vision)."""
from . import models

__all__ = ["models"]
