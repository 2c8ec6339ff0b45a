"""fp8 quantization the paged KV cache needs.

Counterpart of the KV part of ``mxnet_tpu/quant.py``: the fp8 wire
formats and :func:`rowwise_quantize`, one f32 scale per leading-axis row.
The port keeps its own copy so that it never imports the JAX package.
The block-scaled fp8 matmul (``fp8_linear``, ``QuantConfig``) is not
ported yet.

:func:`rowwise_quantize` keeps the JAX package's order of operations
(widen to f32, row absmax, clamp to 1e-30, divide by the format's
maximum, divide the row by its scale, cast), so payload and scales equal
the JAX package's bit for bit.  Both divisions divide by tensors on the
input's device: CUDA turns a division by a host scalar into a product
with its reciprocal, which can move the last bit.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["FP8_MAX", "FP8_DTYPES", "rowwise_quantize"]

#: largest finite magnitude of each fp8 format
FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}

#: fp8 format -> torch dtype
FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def rowwise_quantize(x: torch.Tensor, fmt: str):
    """Quantize ``[rows, ...]`` to fp8 with one f32 scale per row:
    returns ``(q, scale [rows])`` with ``q * scale ~= x`` rowwise.  The
    row absmax lands on the format's largest finite value, so the cast
    never overflows.  A row is one cached token position in the KV pools:
    its H x head_dim states share a scale."""
    if fmt not in FP8_DTYPES:
        raise MXNetError(f"rowwise_quantize: unknown fp8 format {fmt!r}, "
                         f"expected one of {sorted(FP8_DTYPES)}")
    x32 = x.float()
    f32 = dict(dtype=torch.float32, device=x32.device)
    absmax = (x32.abs().amax(dim=tuple(range(1, x32.dim())))
              if x32.dim() > 1 else x32.abs())
    scale = (torch.maximum(absmax, torch.tensor(1e-30, **f32))
             / torch.tensor(FP8_MAX[fmt], **f32))
    q = x32 / scale.reshape(scale.shape + (1,) * (x32.dim() - 1))
    return q.to(FP8_DTYPES[fmt]), scale
