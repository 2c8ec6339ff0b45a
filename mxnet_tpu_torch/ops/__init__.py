"""Operator registry and the ported operators.

Importing this package registers the ported ops, as importing
``mxnet_tpu.ops`` does for the JAX package.  ``fused_update`` holds the
single-pass optimizer update (kernel K2); it is an op of the trainer, not
of the graph, and registers nothing.
"""
from .registry import (OP_REGISTRY, OpContext, OpDef, OpParam, get_op,
                       register_op)
from . import simple_ops  # noqa: F401  (registers the binary ops)
from . import nn_ops  # noqa: F401  (registers the NN ops)
from . import attention_ops  # noqa: F401  (registers RingAttention, MoEFFN)
from . import fused_update  # noqa: F401

__all__ = ["OP_REGISTRY", "OpContext", "OpDef", "OpParam", "get_op",
           "register_op", "fused_update", "nn_ops", "attention_ops"]
