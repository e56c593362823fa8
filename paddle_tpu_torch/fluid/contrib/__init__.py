"""fluid.contrib (port of ``paddle_tpu.fluid.contrib``): the ``slim``
namespace."""
from . import slim  # noqa: F401
