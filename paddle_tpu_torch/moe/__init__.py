"""paddle_tpu_torch.moe — mixture-of-experts layers (port of
``paddle_tpu.moe``).

* ``MoELayer`` — GShard-style top-k routed expert FFN, a drop-in for the
  dense ``ParallelMLP`` behind ``GPTConfig.moe_experts`` (layer.py); its
  two expert matmuls run the ``grouped_matmul`` CUDA kernel on the card;
* ``stats`` — the thread-local collector carrying each layer's load-
  balance loss and routed / dropped counters to whoever owns the call
  (stats.py).

Under ``fleet`` the layer routes the global batch, and an ``expert``
mesh axis spreads the experts over ranks: an autograd all-to-all out,
an all-gather back (layer.py).
"""
from . import stats  # noqa: F401
from .layer import MoELayer  # noqa: F401
