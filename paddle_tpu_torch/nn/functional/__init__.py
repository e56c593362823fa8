"""Functional ops of the port (the parts the ported models call)."""
from .loss import cross_entropy

__all__ = ["cross_entropy"]
