"""Attention building blocks of the port (single device)."""
from . import ring_attention
from .ring_attention import local_attention

__all__ = ["ring_attention", "local_attention"]
