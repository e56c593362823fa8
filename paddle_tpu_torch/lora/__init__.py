"""paddle_tpu_torch.lora — batched multi-LoRA adapters for multi-tenant
serving (port of ``paddle_tpu.lora``).

Three pieces:

* :mod:`.batched` — fixed-capacity adapter tables registered as buffers on
  the parallel linears (``enable_lora``), the per-row ragged grouped apply
  (``apply_lora`` / ``lora_delta``; both hops through the
  ``grouped_matmul`` CUDA kernel on the card), and the host-side table
  edits (``write_adapter`` / ``clear_slot``);
* :mod:`.runtime` — the scoped ``[B]`` adapter-id vector
  (``adapter_scope``) the serving step installs around the block stack;
* :mod:`.adapter` — the :class:`LoraAdapter` bundle and its
  sha256-manifested side-file artifact (``export_adapter`` /
  ``load_adapter``, format ``paddle_tpu.lora_adapter.v1``, shared with the
  JAX package).

Slot id ``-1`` means "no adapter" and is bitwise the base model's output;
every shape is fixed by the adapter capacity, so hot add / remove of an
adapter edits table rows only.
"""
from . import runtime  # noqa: F401
from .adapter import (  # noqa: F401
    ADAPTER_FORMAT,
    LoraAdapter,
    export_adapter,
    load_adapter,
    merge_adapter,
    random_adapter,
)
from .batched import (  # noqa: F401
    DEFAULT_TARGETS,
    adapter_capacity,
    apply_lora,
    clear_slot,
    enable_lora,
    lora_delta,
    lora_targets,
    write_adapter,
)
from .runtime import active_ids, adapter_scope  # noqa: F401

__all__ = [
    "ADAPTER_FORMAT", "LoraAdapter", "export_adapter", "load_adapter",
    "merge_adapter", "random_adapter", "DEFAULT_TARGETS",
    "adapter_capacity", "apply_lora", "clear_slot", "enable_lora",
    "lora_delta", "lora_targets", "write_adapter", "adapter_scope",
    "active_ids", "runtime",
]
