"""fluid.contrib.slim: the port's ``slim.quantization``."""
from ....slim import quantization  # noqa: F401
