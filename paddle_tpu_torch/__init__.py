"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module layout and parameter names, imports ``torch`` and numpy only
(never ``jax``, never ``paddle_tpu``), and replaces each Pallas TPU kernel
on a ported path with a kernel written by hand for ``sm_90a``
(``ops/csrc``).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.

Ported so far:

* generation serving for ``GPTForCausalLM``
  (``serving.GenerationEngine``): the default dense-ring continuous
  batching engine, the legacy run-batch-to-completion scheduler
  (``continuous=False``) and the paged-KV engine (``paged=True``, the
  ``paged_flash_decode`` CUDA kernel) with prefill/decode KV hand-off
  (``role=``), hot weight swaps (``swap_weights`` / ``reload_weights``),
  also quantized (``quantized="int8" | "fp8"``: ``slim`` weight
  quantization and ``export_quantized``, int8 / fp8 KV pools, the
  ``quantized_matmul`` CUDA kernel), batched multi-LoRA adapters
  (``lora``, ``GPTConfig.lora_capacity``; both low-rank hops through the
  ``grouped_matmul`` CUDA kernel) with multi-tenant admission
  (``serving.TenantScheduler``); ``tuning.RequestTrace`` / ``replay``
  drive bench.py's serving workloads;
* the training step through ``Model(net).prepare(optimizer, loss)`` /
  ``train_batch`` for BERT (``models.bert``: pretraining, QA and
  sequence-classification heads) and ``GPTForCausalLM``, with the
  ``layernorm_residual`` and ``softmax_cross_entropy`` CUDA kernels and
  the SGD / Momentum / Adam / AdamW rules of ``optimizer``;
* ResNet training (``vision.models.resnet50(data_format="NHWC",
  stem_space_to_depth=True)``, bf16, through ``Model.train_batch``) with
  the ``conv1x1_bn_stats`` and ``bn_apply_relu`` CUDA kernels in the
  conv3 → bn3 → +identity → relu tail of every bottleneck block;
* long-context GPT inference and training (the flash-attention kernels)
  and MoE GPT training and serving (the ``grouped_matmul`` kernel);
* the training loop around the step: ``Model.fit`` / ``evaluate`` /
  ``predict`` with ``hapi.callbacks`` and ``metric``, ``io.DataLoader``
  (worker processes, device staging on a side stream, exact resume),
  ``save`` / ``load`` (the JAX package's checkpoint format, both ways),
  ``Model.save`` / ``load``, and ``amp`` (the per-layer ``auto_cast``
  policy, ``decorate``, ``GradScaler``; ``prepare(amp_configs="O1")``),
  for which ``layernorm_residual`` takes the mixed dtypes amp hands it;
* sparse CTR training: SelectedRows gradients from
  ``Embedding(sparse=True)`` inside ``Model.train_batch``
  (``framework.selected_rows``), every optimizer of the JAX package with
  its sparse rule (``Adam(lazy_mode=True)`` updates touched rows only),
  ``models.WideDeep`` and the native ``io.InMemoryDataset``; plain
  PyTorch, as the JAX path is plain XLA;
* the 1.x static graph (``static``, ``fluid``): ``fluid.Program`` /
  ``program_guard`` / ``data``, the builders and ``layer_op`` /
  ``record_call``, ``optimizer.minimize``, ``Executor.run`` and
  ``run_steps`` (N optimizer steps as one CUDA graph replay), so
  bench.py's configs 1-3 run through their own entry point;
* sequence tagging: the linear-chain CRF and the dense ``sequence_*`` ops
  (``nn.functional``), the 1.x RNN and loss builders, ``fluid.dygraph``,
  ``fluid.metrics`` and ``fluid.io`` (the reference's binary
  persistables), so a 1.x BiGRU-CRF tagger trains through the static
  graph, and a BERT CRF tagger through ``Model.train_batch``;
* distributed execution, one process per rank on ``torch.distributed``
  (``distributed``): the rank mesh, the collectives, ``DataParallel``,
  ``spawn`` / ``launch``, ``fleet`` with data parallelism x ZeRO-1 x
  tensor parallelism through ``Model.prepare``, and ring / Ulysses
  sequence parallelism on the flash-attention kernels.
"""
from .tensor import *  # noqa: F401,F403  (the tensor functions, as JAX's)
from . import tensor  # noqa: F401
from . import (amp, io, metric, nn, optimizer, regularizer, slim, tuning,
               vision)
from .static.graph import disable_static, enable_static, in_dygraph_mode
from . import static, fluid  # noqa: E402  (after nn / optimizer / io)
from .framework.device import get_device, set_device
from .framework.random import seed
from .framework.serialization import load, save
from .hapi import Model
from .nn import ParamAttr
from . import distributed  # noqa: E402
from .distributed import DataParallel  # noqa: E402

__version__ = "0.5.0"


def crop_tensor(x, shape=None, offsets=None, name=None):
    """Legacy alias of ``crop`` (``fluid.layers.crop_tensor``)."""
    return tensor.crop(x, shape=shape, offsets=offsets)


__all__ = ["seed", "set_device", "get_device", "Model", "ParamAttr", "save",
           "load", "static", "fluid", "enable_static", "disable_static",
           "in_dygraph_mode", "crop_tensor", "distributed", "DataParallel",
           "amp", "io", "metric", "nn", "optimizer", "regularizer", "slim",
           "tuning", "vision", "__version__"]
