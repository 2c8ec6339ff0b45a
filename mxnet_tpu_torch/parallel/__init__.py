"""Parallel training and attention building blocks of the port (one
device so far): ``ShardedTrainer``, the gradient bucket plan, the dense
and blockwise attention paths and flash attention (kernels K3, K4)."""
from . import (collectives, flash_attention, mesh, ring_attention,
               trainer)
from .mesh import default_mesh, make_mesh
from .ring_attention import blockwise_attention, local_attention
from .trainer import ShardedTrainer

__all__ = ["collectives", "flash_attention", "mesh", "ring_attention",
           "trainer", "local_attention", "blockwise_attention",
           "make_mesh", "default_mesh", "ShardedTrainer"]
