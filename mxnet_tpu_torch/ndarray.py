"""NDArray: the imperative tensor API.

Counterpart of ``mxnet_tpu/ndarray.py``.  Design mapping:

* The reference NDArray is a ref-counted ``Chunk`` with zero-copy
  ``Slice``/``At``/``Reshape`` views.  Here :class:`_Chunk` holds the root
  ``torch.Tensor`` and a version counter; an array or view holds a torch
  view of the chunk's storage, so writes through any view are seen by all
  aliases, in place.  A write bumps the shared ``version``.
* The reference pushes work to its dependency engine and returns at once;
  CUDA streams play that role.  ``wait_to_read`` and :func:`waitall`
  synchronize the card.
* Arithmetic runs the registered ops through :func:`imperative_invoke`,
  and ``nd.<func_name>`` functions are generated from the op registry,
  as the reference's ``_init_ndarray_module`` does.
* :func:`save`/:func:`load` read and write the JAX package's byte format
  (``MXTPUND1``), so a file written by either package loads in the other.

Arrays live on :func:`~mxnet_tpu_torch.context.current_context` unless a
``ctx`` is given: the card by default, the host under ``with cpu():``.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .base import MXNetError
from .context import Context, as_context, current_context, resolve_device
from .ops.registry import OP_REGISTRY, OpContext, get_op

__all__ = [
    "NDArray", "zeros", "ones", "full", "empty", "array", "arange",
    "concatenate", "save", "load", "imperative_invoke", "waitall",
    "note_donation",
]

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

# The most recent donating dispatch.  Kept for the JAX package's API: the
# port has no step that donates buffers, so nothing here is ever deleted
# under a live NDArray and reads never raise for it.
_LAST_DONATION: Optional[str] = None


def note_donation(owner: str) -> None:
    """Record that ``owner`` donated buffers to a compiled step (API of the
    JAX package; the port donates nothing, so this is bookkeeping only)."""
    global _LAST_DONATION
    _LAST_DONATION = owner


def _torch_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    dt = np.dtype(dtype)
    if dt not in _TORCH_DTYPES:
        raise MXNetError(f"unsupported dtype {dt}")
    return _TORCH_DTYPES[dt]


def _context_of(t: torch.Tensor) -> Context:
    return as_context(t.device)


class _Chunk:
    """Shared storage cell (the reference's ``NDArray::Chunk``): the root
    tensor and a version that every write through any alias bumps."""

    __slots__ = ("data", "version", "donated_by")

    def __init__(self, data: torch.Tensor):
        self.data = data
        self.version = 0
        self.donated_by: Optional[str] = None


class NDArray:
    """Mutable n-dimensional array on a device context.

    ``NDArray(tensor)`` wraps a ``torch.Tensor`` without copying: writes
    through the array change the tensor.  Other sources (numpy arrays,
    lists) are copied to ``ctx``; :func:`array` is the usual constructor.
    """

    __slots__ = ("_chunk", "_data", "_ctx", "writable")

    # make numpy defer to our __r*__ operators
    __array_priority__ = 100.0

    def __init__(self, data, ctx: Optional[Context] = None,
                 writable: bool = True):
        if isinstance(data, torch.Tensor):
            ctx = _context_of(data) if ctx is None else as_context(ctx)
        else:
            ctx = as_context(ctx)
            data = torch.tensor(np.asarray(data)).to(resolve_device(ctx))
        self._chunk = _Chunk(data)
        self._data = data
        self._ctx = ctx
        self.writable = writable

    @classmethod
    def _view(cls, parent: "NDArray", data: torch.Tensor) -> "NDArray":
        out = cls.__new__(cls)
        out._chunk = parent._chunk
        out._data = data
        out._ctx = parent._ctx
        out.writable = parent.writable
        return out

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------

    @property
    def data(self) -> torch.Tensor:
        """The tensor (a view of the chunk's storage)."""
        return self._data

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def dtype(self) -> np.dtype:
        if self._data.dtype not in _NP_DTYPES:
            raise MXNetError(f"no numpy dtype for {self._data.dtype}")
        return _NP_DTYPES[self._data.dtype]

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    @property
    def version(self) -> int:
        return self._chunk.version

    # ------------------------------------------------------------------
    # Mutation
    # ------------------------------------------------------------------

    def _as_value(self, value) -> torch.Tensor:
        """``value`` (NDArray, tensor, numpy, scalar) as a tensor of this
        array's type on its device (a cross-device write transfers the
        value, as the reference's CopyFromTo does)."""
        if isinstance(value, NDArray):
            value = value.data
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        return value.to(device=self._data.device, dtype=self._data.dtype)

    def _migrate(self, ctx) -> None:
        """Move this array's storage to context ``ctx`` in place (an
        executor's ``group2ctx`` placement of a freshly bound array)."""
        ctx = as_context(ctx)
        data = self._data.to(resolve_device(ctx), copy=True)
        self._chunk.data = data
        self._data = data
        self._ctx = ctx

    def _write(self, value) -> None:
        """Write ``value`` (broadcast to this array's shape) in place."""
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        value = self._as_value(value)
        with torch.no_grad():
            self._data.copy_(torch.broadcast_to(value, self._data.shape))
        self._chunk.version += 1

    def __setitem__(self, key, value) -> None:
        if key is Ellipsis or (isinstance(key, slice) and key == slice(None)):
            self._write(value)
            return
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        with torch.no_grad():
            self._data[key] = self._as_value(value)
        self._chunk.version += 1

    def __getitem__(self, key) -> "NDArray":
        if isinstance(key, int):
            return self.at(key)
        if isinstance(key, slice):
            if key.step is not None and key.step != 1:
                raise MXNetError("NDArray only supports step=1 slicing on "
                                 "axis 0")
            start = key.start or 0
            stop = self.shape[0] if key.stop is None else key.stop
            return self.slice(start, stop)
        raise MXNetError("NDArray indexing supports int and contiguous slice "
                         "on axis 0")

    # zero-copy views -------------------------------------------------------

    def slice(self, start: int, stop: int) -> "NDArray":
        if not self.shape:
            raise MXNetError("cannot slice a scalar NDArray")
        n = self.shape[0]
        start = start + n if start < 0 else start
        stop = stop + n if stop < 0 else stop
        if not (0 <= start <= stop <= n):
            raise MXNetError(f"slice [{start}:{stop}] out of range for axis "
                             f"of {n}")
        return NDArray._view(self, self._data[start:stop])

    def at(self, idx: int) -> "NDArray":
        view = self.slice(idx, idx + 1)
        if self.ndim > 1:
            view._data = view._data[0]
        return view

    def reshape(self, shape: Sequence[int]) -> "NDArray":
        shape = tuple(int(s) for s in shape)
        if -1 in shape:
            rest = int(np.prod([s for s in shape if s != -1]))
            shape = tuple(self.size // rest if s == -1 else s for s in shape)
        if int(np.prod(shape)) != self.size:
            raise MXNetError(f"cannot reshape {self.shape} -> {shape}")
        return NDArray._view(self, self._data.view(shape))

    # ------------------------------------------------------------------
    # Synchronization / transfer
    # ------------------------------------------------------------------

    def mark_donated(self, owner: str) -> None:
        """Tag this array's storage as donated by ``owner`` (API of the JAX
        package, where a later read raises; nothing in the port donates,
        so reads never raise here)."""
        self._chunk.donated_by = owner
        note_donation(owner)

    def wait_to_read(self) -> None:
        """Block until the value is computed (``Engine::WaitForVar``)."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    def asnumpy(self) -> np.ndarray:
        if self._data.dtype not in _NP_DTYPES:
            raise MXNetError(f"no numpy dtype for {self._data.dtype}")
        return self._data.detach().cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("asscalar requires size-1 NDArray")
        return self.asnumpy().reshape(()).item()

    def copyto(self, other: Union["NDArray", Context]) -> "NDArray":
        """Copy into another NDArray, or into a new array on a context."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(resolve_device(other),
                                                  copy=True), ctx=other)
        if other is self:
            return other
        if other.shape != self.shape:
            raise MXNetError(f"copyto shape mismatch {self.shape} vs "
                             f"{other.shape}")
        other._write(self._data)
        return other

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    def astype(self, dtype) -> "NDArray":
        return NDArray(self._data.to(_torch_dtype(dtype), copy=True),
                       ctx=self._ctx)

    def copy(self) -> "NDArray":
        return NDArray(self._data.clone(), ctx=self._ctx)

    # ------------------------------------------------------------------
    # Arithmetic: each returns a fresh NDArray
    # ------------------------------------------------------------------

    def _binop(self, other, opname, rev_scalar_opname=None, reverse=False):
        if isinstance(other, NDArray):
            lhs, rhs = (other, self) if reverse else (self, other)
            return imperative_invoke(opname, [lhs, rhs], {})
        if isinstance(other, (int, float, np.integer, np.floating)):
            name = (rev_scalar_opname if (reverse and rev_scalar_opname)
                    else opname + "_scalar")
            return imperative_invoke(name, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, o): return self._binop(o, "_plus")
    def __radd__(self, o): return self._binop(o, "_plus")
    def __sub__(self, o): return self._binop(o, "_minus", "_rminus_scalar")
    def __rsub__(self, o):
        return self._binop(o, "_minus", "_rminus_scalar", reverse=True)
    def __mul__(self, o): return self._binop(o, "_mul")
    def __rmul__(self, o): return self._binop(o, "_mul")
    def __truediv__(self, o): return self._binop(o, "_div", "_rdiv_scalar")
    def __rtruediv__(self, o):
        return self._binop(o, "_div", "_rdiv_scalar", reverse=True)
    def __pow__(self, o): return self._binop(o, "_power", "_rpower_scalar")
    def __rpow__(self, o):
        return self._binop(o, "_power", "_rpower_scalar", reverse=True)
    def __neg__(self):
        return imperative_invoke("_mul_scalar", [self], {"scalar": -1.0})

    def _ibinop(self, other, opname):
        out = self._binop(other, opname)
        if out is NotImplemented:
            return out
        self._write(out.data)
        return self

    def __iadd__(self, o): return self._ibinop(o, "_plus")
    def __isub__(self, o): return self._ibinop(o, "_minus")
    def __imul__(self, o): return self._ibinop(o, "_mul")
    def __itruediv__(self, o): return self._ibinop(o, "_div")

    def __eq__(self, other):
        if isinstance(other, NDArray):
            return self is other
        return NotImplemented

    def __hash__(self):
        return id(self)

    def __len__(self) -> int:
        if not self.shape:
            raise MXNetError("len() of a scalar NDArray")
        return self.shape[0]

    def __repr__(self):
        return (f"<NDArray {self.shape} @{self._ctx} "
                f"{str(self._data.dtype).replace('torch.', '')}>")

    def __array__(self, dtype=None, copy=None):
        out = self.asnumpy()
        return out.astype(dtype) if dtype is not None else out


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def _shape(shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _new(t_fn, shape, ctx, dtype) -> NDArray:
    ctx = as_context(ctx)
    return NDArray(t_fn(_shape(shape), dtype=_torch_dtype(dtype),
                        device=resolve_device(ctx)), ctx=ctx)


def empty(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    return _new(torch.zeros, shape, ctx, dtype)


def ones(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    return _new(torch.ones, shape, ctx, dtype)


def full(shape, val, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    return _new(lambda s, **kw: torch.full(s, val, **kw), shape, ctx, dtype)


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """A copy of ``source_array`` (numpy, list, tensor or NDArray) on
    ``ctx`` (default: the source NDArray's context, else
    :func:`current_context`).  float64 numpy input becomes float32, as in
    the JAX package."""
    if isinstance(source_array, NDArray):
        if ctx is None:
            ctx = source_array.context
        source_array = source_array.data
    ctx = as_context(ctx)
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
        t = torch.tensor(arr)
    return NDArray(t.to(device=resolve_device(ctx), dtype=dt, copy=True),
                   ctx=ctx)


def arange(start, stop=None, step=1.0, ctx=None, dtype=None) -> NDArray:
    if stop is None:
        start, stop = 0, start
    ctx = as_context(ctx)
    return NDArray(torch.arange(start, stop, step, dtype=_torch_dtype(dtype),
                                device=resolve_device(ctx)), ctx=ctx)


def concatenate(arrays: Sequence[NDArray], axis: int = 0) -> NDArray:
    return NDArray(torch.cat([a.data for a in arrays], dim=axis),
                   ctx=arrays[0].context)


def waitall() -> None:
    """``Engine::WaitForAll``: wait for all work queued on the cards."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ---------------------------------------------------------------------------
# Save / load: the JAX package's byte format
# ---------------------------------------------------------------------------

_SAVE_MAGIC = b"MXTPUND1"


def save(fname: str, data: Union[List[NDArray], Dict[str, NDArray]]) -> None:
    """Save a list or dict of NDArrays in the JAX package's format:
    magic, ``<qq`` counts, per array its numpy dtype string, ndim, shape
    and bytes, then the names.

    Local writes are atomic (a same-directory temp file, fsynced and
    ``os.replace``d into place), so a process killed mid-save leaves the
    previous file whole.  Other schemes (``memory://``, ``s3://``) write
    directly.
    """
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    elif isinstance(data, (list, tuple)):
        names = []
        arrays = list(data)
    else:
        raise MXNetError("save expects list or dict of NDArrays")

    def _write(f):
        f.write(_SAVE_MAGIC)
        f.write(struct.pack("<qq", len(arrays), len(names)))
        for arr in arrays:
            np_arr = (arr.asnumpy() if isinstance(arr, NDArray)
                      else np.asarray(arr))
            dt = np_arr.dtype.str.encode()
            f.write(struct.pack("<i", len(dt)))
            f.write(dt)
            f.write(struct.pack("<i", np_arr.ndim))
            f.write(struct.pack(f"<{np_arr.ndim}q", *np_arr.shape))
            f.write(np_arr.tobytes())
        for name in names:
            nb = name.encode()
            f.write(struct.pack("<i", len(nb)))
            f.write(nb)

    from .stream import open_uri, split_scheme
    scheme, path = split_scheme(fname)
    if scheme != "file":
        with open_uri(fname, "wb") as f:
            _write(f)
        return
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            _write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _read_exact(f, nbytes: int, fname: str, what: str) -> bytes:
    """Exactly ``nbytes``, or an MXNetError naming the file and what was
    being read (a truncated file fails here, not as a misparse)."""
    buf = f.read(nbytes)
    if len(buf) != nbytes:
        raise MXNetError(
            f"{fname}: truncated NDArray file — expected {nbytes} bytes "
            f"for {what}, got {len(buf)}")
    return buf


def load(fname: str, ctx: Optional[Context] = None
         ) -> Union[List[NDArray], Dict[str, NDArray]]:
    """Load what :func:`save` (of either package) wrote, onto ``ctx``
    (default :func:`current_context`)."""
    from .stream import open_uri
    ctx = as_context(ctx)
    with open_uri(fname, "rb") as f:
        magic = f.read(8)
        if magic != _SAVE_MAGIC:
            raise MXNetError(f"{fname}: bad magic, not an NDArray file")
        n_arr, n_names = struct.unpack(
            "<qq", _read_exact(f, 16, fname, "the array/name counts"))
        if n_arr < 0 or n_names < 0 or (n_names and n_names != n_arr):
            raise MXNetError(
                f"{fname}: corrupt header — {n_arr} arrays, {n_names} names")
        arrays = []
        for i in range(n_arr):
            what = f"array {i}"
            (dt_len,) = struct.unpack(
                "<i", _read_exact(f, 4, fname, f"{what} dtype length"))
            try:
                dt = np.dtype(
                    _read_exact(f, dt_len, fname, f"{what} dtype").decode())
            except (TypeError, ValueError, UnicodeDecodeError) as e:
                raise MXNetError(f"{fname}: {what} has an invalid dtype "
                                 f"descriptor: {e}") from e
            (ndim,) = struct.unpack(
                "<i", _read_exact(f, 4, fname, f"{what} ndim"))
            if not 0 <= ndim <= 32:
                raise MXNetError(f"{fname}: {what} has corrupt ndim {ndim}")
            shape = struct.unpack(
                f"<{ndim}q",
                _read_exact(f, 8 * ndim, fname, f"{what} shape")) \
                if ndim else ()
            if any(d < 0 for d in shape):
                raise MXNetError(
                    f"{fname}: {what} has corrupt shape {shape}")
            count = int(np.prod(shape)) if shape else 1
            buf = _read_exact(f, count * dt.itemsize, fname,
                              f"{what} payload (shape {tuple(shape)})")
            arrays.append(array(np.frombuffer(buf, dtype=dt).reshape(shape),
                                ctx=ctx, dtype=dt))
        names = []
        for i in range(n_names):
            (ln,) = struct.unpack(
                "<i", _read_exact(f, 4, fname, f"name {i} length"))
            if ln < 0:
                raise MXNetError(f"{fname}: name {i} has corrupt length {ln}")
            names.append(_read_exact(f, ln, fname, f"name {i}").decode())
    if names:
        return dict(zip(names, arrays))
    return arrays


# ---------------------------------------------------------------------------
# Imperative invocation of registered ops
# ---------------------------------------------------------------------------

def imperative_invoke(opname: str, inputs: Sequence[NDArray],
                      raw_params: Dict[str, Any],
                      out: Optional[Union[NDArray, List[NDArray]]] = None,
                      ctx: Optional[Context] = None
                      ) -> Union[NDArray, List[NDArray]]:
    """Run a registered op eagerly on NDArrays (``MXFuncInvoke``): values
    only, no autograd graph.  Trailing inputs beyond the op's arguments
    are its aux states (BatchNorm), as the executor binds them."""
    op = get_op(opname)
    params = op.parse_params(raw_params)
    if ctx is None:
        ctx = inputs[0].context if inputs else current_context()
    ctx = as_context(ctx)
    rng = None
    if op.needs_rng:
        from . import random as _random
        rng = _random.generator(ctx)
    n_args = len(op.list_arguments(params))
    aux_names = op.list_aux_states(params)
    aux = None
    if aux_names and len(inputs) > n_args:
        aux = {name: arr.data for name, arr in zip(aux_names, inputs[n_args:])}
        inputs = inputs[:n_args]
    elif aux_names:
        raise MXNetError(
            f"op {opname} has aux states {list(aux_names)}; pass them as "
            f"trailing arguments after the {n_args} regular inputs")
    opctx = OpContext(is_train=False, rng=rng, aux=aux)
    with torch.no_grad():
        result = op.forward(opctx, params, *[x.data for x in inputs])
    results = list(result) if isinstance(result, (tuple, list)) else [result]
    dev = resolve_device(ctx)
    outs = [NDArray(r.to(dev), ctx=ctx) for r in results]
    if out is not None:
        out_list = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(out_list, outs):
            dst._write(src.data)
        outs = list(out_list)
    return outs[0] if len(outs) == 1 else outs


def _make_ndarray_function(opname: str, func_name: str):
    op = get_op(opname)
    param_names = list(op.params)

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        arrs = []
        scalars: Dict[str, Any] = {}
        remaining = list(param_names)
        for a in args:
            if isinstance(a, NDArray):
                arrs.append(a)
            else:
                # positional scalar params in declaration order
                while remaining and remaining[0] in kwargs:
                    remaining.pop(0)
                if not remaining:
                    raise MXNetError(f"{func_name}: too many positional args")
                scalars[remaining.pop(0)] = a
        scalars.update(kwargs)
        return imperative_invoke(opname, arrs, scalars, out=out)

    fn.__name__ = func_name
    fn.__doc__ = op.doc or f"{opname} (generated from the op registry)"
    return fn


def _init_ndarray_module() -> None:
    """Populate this module with functions from the op registry."""
    g = globals()
    for name, op in OP_REGISTRY.items():
        if op.func_name is None:
            continue
        fname = op.func_name
        public = not fname.startswith("_")
        if fname in g and not public:
            continue
        if fname in ("array", "save", "load", "zeros", "ones", "full",
                     "empty"):
            continue
        g[fname] = _make_ndarray_function(name, fname)
        if public and fname not in __all__:
            __all__.append(fname)


_init_ndarray_module()
