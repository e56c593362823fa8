"""paddle.fluid.initializer — the 1.x initializer names over
``paddle_tpu_torch.nn.initializer`` (class spellings such as
``ConstantInitializer`` and the short aliases)."""
from ..nn.initializer import (  # noqa: F401
    Assign, Bilinear, Constant, KaimingNormal, KaimingUniform, Normal,
    TruncatedNormal, Uniform, XavierNormal, XavierUniform,
)

ConstantInitializer = Constant
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
UniformInitializer = Uniform
NumpyArrayInitializer = Assign


class Xavier(XavierNormal):
    """1.x ``Xavier(uniform=True)`` switch."""

    def __new__(cls, uniform=True, fan_in=None, fan_out=None, seed=0):
        if uniform:
            return XavierUniform(fan_in=fan_in, fan_out=fan_out)
        return XavierNormal(fan_in=fan_in, fan_out=fan_out)


class MSRA(KaimingNormal):
    """1.x ``MSRA(uniform=True)`` switch (uniform is the default)."""

    def __new__(cls, uniform=True, fan_in=None, seed=0):
        if uniform:
            return KaimingUniform(fan_in=fan_in)
        return KaimingNormal(fan_in=fan_in)


XavierInitializer = Xavier
MSRAInitializer = MSRA
BilinearInitializer = Bilinear
