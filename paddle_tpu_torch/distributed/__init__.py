"""Distributed building blocks of the port (single-device so far)."""
