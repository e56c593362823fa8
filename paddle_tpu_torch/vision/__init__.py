"""Vision of the port: ``vision.models`` (ResNet, VGG, MobileNet v1 / v2
and LeNet; transforms, ops and datasets wait in ROADMAP queue A,
vision)."""
from . import models

__all__ = ["models"]
