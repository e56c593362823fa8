"""Models of the port."""
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_small, gpt_tiny

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt_small"]
