"""Elementwise binary operators: the ops ``Symbol`` arithmetic emits.

Counterpart of the elementwise-binary part of
``mxnet_tpu/ops/simple_ops.py``: ``a + b`` on symbols composes ``_plus``
(the residual sum of every ResNet unit), ``a + 2.0`` composes
``_plus_scalar``, and likewise for ``-``, ``*``, ``/`` and ``**``.  The
rest of that module (unary math, reductions, matrix ops, sampling) is not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

from .registry import OpDef, OpParam, elemwise_shape, register_op

__all__ = []  # ops land in the registry


def _binary(name, fn):
    register_op(OpDef(
        name=name,
        forward=lambda ctx, params, lhs, rhs, _fn=fn: _fn(lhs, rhs),
        arguments=("lhs", "rhs"),
        infer_shape=elemwise_shape,
        func_name=name,
    ))


def _binary_scalar(name, fn):
    register_op(OpDef(
        name=name,
        forward=lambda ctx, params, x, _fn=fn: _fn(x, params["scalar"]),
        arguments=("data",),
        params={"scalar": OpParam("scalar", "float", required=True)},
        infer_shape=elemwise_shape,
        func_name=name,
    ))


_binary("_plus", torch.add)
_binary("_minus", torch.sub)
_binary("_mul", torch.mul)
_binary("_div", torch.div)
_binary("_power", torch.pow)

_binary_scalar("_plus_scalar", lambda x, s: x + s)
_binary_scalar("_minus_scalar", lambda x, s: x - s)
_binary_scalar("_rminus_scalar", lambda x, s: s - x)
_binary_scalar("_mul_scalar", lambda x, s: x * s)
_binary_scalar("_div_scalar", lambda x, s: x / s)
_binary_scalar("_rdiv_scalar", lambda x, s: s / x)
_binary_scalar("_power_scalar", lambda x, s: torch.pow(x, s))
