"""NDArray: a framework array over a torch tensor (minimal subset).

Counterpart of ``mxnet_tpu/ndarray.py``, reduced to what the initializer
and ``ShardedTrainer.get_params``/``set_params`` need: construction
(:func:`array`, :func:`zeros`), ``shape``/``dtype``/``context``,
whole-array writes (``arr[:] = value``) and ``asnumpy``.  Views with
write-through, arithmetic, ``save``/``load`` and the donation guard come
with the full port of the module (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .base import MXNetError
from .context import Context, cpu, gpu, resolve_device

__all__ = ["NDArray", "array", "zeros"]

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.bool_): torch.bool,
}
_NP_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


def _context_of(t: torch.Tensor) -> Context:
    if t.device.type == "cuda":
        return gpu(t.device.index or 0)
    return cpu()


class NDArray:
    """Mutable n-dimensional array on a device context."""

    __slots__ = ("_data",)

    def __init__(self, data: torch.Tensor):
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got "
                             f"{type(data).__name__}")
        self._data = data

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self) -> np.dtype:
        if self._data.dtype not in _NP_DTYPES:
            raise MXNetError(f"no numpy dtype for {self._data.dtype}")
        return _NP_DTYPES[self._data.dtype]

    @property
    def context(self) -> Context:
        return _context_of(self._data)

    def __setitem__(self, key, value) -> None:
        """Whole-array write: ``arr[:] = scalar | numpy | tensor | NDArray``
        (in place, cast to this array's dtype and device)."""
        if not (key is Ellipsis or key == slice(None)):
            raise MXNetError("NDArray supports whole-array writes arr[:] = v "
                             "only (partial writes are not ported yet)")
        if isinstance(value, NDArray):
            value = value.data
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                src = value
            else:
                src = torch.as_tensor(np.asarray(value))
            if tuple(src.shape) not in ((), self.shape):
                raise MXNetError(f"cannot write shape {tuple(src.shape)} "
                                 f"into {self.shape}")
            self._data.copy_(src.to(self._data.dtype).expand(self.shape))

    def asnumpy(self) -> np.ndarray:
        return self._data.detach().cpu().numpy().copy()

    def __repr__(self):
        return f"<NDArray {self.shape} @{self.context}>"


def _torch_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np.dtype(dtype)
    if dt not in _TORCH_DTYPES:
        raise MXNetError(f"unsupported dtype {dt}")
    return _TORCH_DTYPES[dt]


def zeros(shape: Union[int, Sequence[int]], ctx: Optional[Context] = None,
          dtype=None) -> NDArray:
    """Zeros on ``ctx`` (default: the card)."""
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(tuple(shape), dtype=_torch_dtype(dtype),
                               device=resolve_device(ctx)))


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """A copy of ``source_array`` (numpy, list, tensor or NDArray) on
    ``ctx`` (default: the card).  float64 numpy input becomes float32, as
    in the JAX package."""
    if isinstance(source_array, NDArray):
        source_array = source_array.data
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach()
        dt = t.dtype if dtype is None else _torch_dtype(dtype)
    else:
        arr = np.asarray(source_array)
        if dtype is None:
            dt = (torch.float32 if arr.dtype == np.float64
                  else _torch_dtype(arr.dtype))
        else:
            dt = _torch_dtype(dtype)
        t = torch.as_tensor(arr)
    return NDArray(t.to(device=resolve_device(ctx), dtype=dt, copy=True))
