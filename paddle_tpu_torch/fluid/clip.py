"""paddle.fluid.clip — the 1.x gradient-clip names over the optimizers'
``grad_clip=`` strategies (``optimizer/clip.py``).  ``set_gradient_clip``
registered a clip on the global Program; it raises, naming the
optimizer's ``grad_clip=`` argument, as in the JAX package."""
from ..framework.errors import UnimplementedError
from ..optimizer.clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)

GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


def set_gradient_clip(clip, param_list=None, program=None):
    raise UnimplementedError(
        "set_gradient_clip registered a clip on the global Program; pass "
        "grad_clip=GradientClipBy...(...) to the optimizer instead")
