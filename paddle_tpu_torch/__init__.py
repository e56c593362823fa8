"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module layout and parameter names, imports ``torch`` and numpy only
(never ``jax``, never ``paddle_tpu``), and replaces each Pallas TPU kernel
on a ported path with a kernel written by hand for ``sm_90a``
(``ops/csrc``).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.

Ported so far: paged-KV generation serving for ``GPTForCausalLM``
(``serving.GenerationEngine(model, paged=True)``) through the
``paged_flash_decode`` CUDA kernel.
"""
from .framework.device import get_device, set_device
from .framework.random import seed

__version__ = "0.1.0"

__all__ = ["seed", "set_device", "get_device", "__version__"]
