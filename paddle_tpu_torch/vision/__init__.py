"""Vision of the port (``paddle_tpu.vision``'s names): ``models`` (ResNet,
VGG, MobileNet v1 / v2, LeNet), ``transforms`` (host-side numpy / PIL
preprocessing for ``DataLoader`` workers), ``datasets`` (local files
only), ``ops`` (the detection ops, ``deform_conv2d`` and
``MultiBoxHead``) and the image backend (``set_image_backend`` /
``get_image_backend`` / ``image_load``)."""
from . import datasets, models, ops, transforms
from .image import get_image_backend, image_load, set_image_backend

__all__ = ["datasets", "models", "transforms", "set_image_backend",
           "get_image_backend", "image_load"]
