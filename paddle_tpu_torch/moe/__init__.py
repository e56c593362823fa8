"""paddle_tpu_torch.moe — mixture-of-experts layers (port of
``paddle_tpu.moe``).

* ``MoELayer`` — GShard-style top-k routed expert FFN, a drop-in for the
  dense ``ParallelMLP`` behind ``GPTConfig.moe_experts`` (layer.py); its
  two expert matmuls run the ``grouped_matmul`` CUDA kernel on the card;
* ``stats`` — the thread-local collector carrying each layer's load-
  balance loss and routed / dropped counters to whoever owns the call
  (stats.py).

Single device: the ``expert`` mesh axis (expert-parallel all-to-alls)
comes with distributed execution (ROADMAP queue A).
"""
from . import stats  # noqa: F401
from .layer import MoELayer  # noqa: F401
