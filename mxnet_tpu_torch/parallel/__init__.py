"""Parallel training and attention building blocks of the port (one
device so far): ``ShardedTrainer``, the gradient bucket plan and the dense
attention path."""
from . import collectives, ring_attention, trainer
from .ring_attention import local_attention
from .trainer import ShardedTrainer

__all__ = ["collectives", "ring_attention", "trainer", "local_attention",
           "ShardedTrainer"]
