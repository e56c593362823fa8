"""Activation layers — port of ``paddle_tpu.nn.activation``: each layer
calls its function of ``nn.functional.activation`` with the arguments it
was built with.  ``PReLU`` holds ``weight`` ``[num_parameters]``, filled
with ``init`` (0.25).  GELU's default is the exact (erf) form, the one GPT
and BERT use; ``GELU(approximate=True)`` is the tanh form.
"""
from __future__ import annotations

from .functional import activation as A
from .initializer import (Constant, create_parameter, fill_at_construction,
                          init_parameter)
from .layer import Layer

__all__ = [
    "ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Silu", "Swish",
    "LeakyReLU", "PReLU", "RReLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LogSigmoid", "LogSoftmax", "Softmax", "Maxout", "Mish",
    "Softplus", "Softshrink", "Softsign", "Tanhshrink", "ThresholdedReLU",
    "GLU", "Sigmoid", "Tanh",
]


class _Act(Layer):
    """An activation layer: ``_fn`` of the input and the layer's ``_args``
    (attribute names, passed positionally after the input)."""
    _fn = None
    _args = ()

    def forward(self, x):
        return getattr(A, self._fn)(x, *(getattr(self, a)
                                         for a in self._args))


def _plain(fn):
    class Plain(_Act):
        _fn = fn

        def __init__(self, name=None):
            super().__init__()
    return Plain


class ReLU(_plain("relu")):
    pass


class ReLU6(_plain("relu6")):
    pass


class Silu(_plain("silu")):
    pass


class Swish(Silu):
    pass


class Hardsigmoid(_plain("hardsigmoid")):
    pass


class Hardswish(_plain("hardswish")):
    pass


class LogSigmoid(_plain("log_sigmoid")):
    pass


class Mish(_plain("mish")):
    pass


class Softsign(_plain("softsign")):
    pass


class Tanhshrink(_plain("tanhshrink")):
    pass


class Sigmoid(_plain("sigmoid")):
    pass


class Tanh(_plain("tanh")):
    pass


class ELU(_Act):
    _fn, _args = "elu", ("alpha",)

    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha


class SELU(_Act):
    _fn, _args = "selu", ("scale", "alpha")

    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha


class CELU(_Act):
    _fn, _args = "celu", ("alpha",)

    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha


class GELU(_Act):
    _fn, _args = "gelu", ("approximate",)

    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate


class LeakyReLU(_Act):
    _fn, _args = "leaky_relu", ("negative_slope",)

    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self._init = (weight_attr, init)
        self.weight = create_parameter((num_parameters,), weight_attr)
        fill_at_construction(self)

    def reset_parameters(self, generator=None):
        attr, init = self._init
        init_parameter(self.weight, attr, Constant(init), generator)

    def forward(self, x):
        return A.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return A.rrelu(x, self.lower, self.upper, training=self.training)


class Hardshrink(_Act):
    _fn, _args = "hardshrink", ("threshold",)

    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold


class Hardtanh(_Act):
    _fn, _args = "hardtanh", ("min", "max")

    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max


class LogSoftmax(_Act):
    _fn, _args = "log_softmax", ("axis",)

    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis


class Softmax(_Act):
    _fn, _args = "softmax", ("axis",)

    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis


class Maxout(_Act):
    _fn, _args = "maxout", ("groups", "axis")

    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis


class Softplus(_Act):
    _fn, _args = "softplus", ("beta", "threshold")

    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold


class Softshrink(_Act):
    _fn, _args = "softshrink", ("threshold",)

    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold


class ThresholdedReLU(_Act):
    _fn, _args = "thresholded_relu", ("threshold", "value")

    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self.threshold, self.value = threshold, value


class GLU(_Act):
    _fn, _args = "glu", ("axis",)

    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis
