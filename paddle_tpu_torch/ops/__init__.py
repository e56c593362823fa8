"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), each
with a plain PyTorch version beside it, built by ``_build`` on first use."""
from .paged_attention import paged_flash_decode, paged_flash_decode_ref

__all__ = ["paged_flash_decode", "paged_flash_decode_ref"]
