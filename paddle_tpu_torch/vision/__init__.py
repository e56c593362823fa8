"""Vision of the port (``paddle_tpu.vision``'s names): ``models`` (ResNet,
VGG, MobileNet v1 / v2, LeNet), ``transforms`` (host-side numpy / PIL
preprocessing for ``DataLoader`` workers), ``datasets`` (local files
only) and the image backend (``set_image_backend`` /
``get_image_backend`` / ``image_load``).  ``vision.ops`` — the detection
ops and ``deform_conv2d`` — raises: it comes with the tail of ``nn/``
(ROADMAP queue A, training step)."""
from . import datasets, models, transforms
from .image import get_image_backend, image_load, set_image_backend

__all__ = ["datasets", "models", "transforms", "set_image_backend",
           "get_image_backend", "image_load"]


def __getattr__(name):
    if name == "ops":
        from ..framework.errors import UnimplementedError

        raise UnimplementedError(
            "vision.ops (the detection ops and deform_conv2d) is not ported "
            "yet (ROADMAP queue A, training step)")
    raise AttributeError(
        f"module 'paddle_tpu_torch.vision' has no attribute {name!r}")
