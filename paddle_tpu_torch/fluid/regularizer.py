"""paddle.fluid.regularizer — the 1.x names over
``paddle_tpu_torch.regularizer``."""
from ..regularizer import L1Decay, L2Decay  # noqa: F401

L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
