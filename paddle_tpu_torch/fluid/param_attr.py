"""paddle.fluid.param_attr — ``ParamAttr`` and ``WeightNormParamAttr``
(the latter not ported yet: it raises, naming its ROADMAP item)."""
from ..nn import ParamAttr  # noqa: F401
from ..static import WeightNormParamAttr  # noqa: F401
