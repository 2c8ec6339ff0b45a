"""Custom operators defined in Python, all three reference generations.

Counterpart of ``mxnet_tpu/operator.py``: ``PythonOp``/``NumpyOp``
(bodies on numpy arrays), ``NDArrayOp`` (bodies on NDArrays) and the
``CustomOp`` + ``CustomOpProp`` + :func:`register` generation (the
``Custom`` op).  The JAX package runs a body under ``jax.pure_callback``
inside ``jax.custom_vjp``; here the body runs inside a
``torch.autograd.Function``, so the user's ``backward`` supplies the
gradient of the op in an executor's backward, and a forward under
``torch.no_grad()`` (``forward(is_train=False)``) records no node.

* ``NumpyOp`` and ``CustomOp`` bodies see numpy arrays, as in the JAX
  package: their values make a round trip through the host, which is the
  op's definition.
* ``NDArrayOp`` bodies see port NDArrays on the device of the op's
  inputs (the executor's device).  In the JAX package they are host
  arrays; the values are the same, and this placement lets a body push
  its own CUDA kernels (:class:`mxnet_tpu_torch.rtc.CudaKernel`) on the
  card.  ``in_data`` (and, in ``backward``, ``out_grad`` and
  ``out_data``) arrive read-only: the body writes ``out_data`` in
  ``forward`` and ``in_grad`` in ``backward``.

An op with ``need_top_grad() == False`` (a loss head) gets an empty
``out_grad`` list.  Output types are the first input's, as in the JAX
package.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray, _NP_DTYPES, _context_of
from .ops.registry import OpDef, OpParam, register_op

__all__ = ["PythonOp", "NumpyOp", "NDArrayOp", "CustomOp", "CustomOpProp",
           "register", "get_all_registered_operators"]


class _BodyFn(torch.autograd.Function):
    """Runs ``bridge.forward(ins) -> outs`` and, for the gradient,
    ``bridge.backward(out_grads, ins, outs) -> in_grads`` (one tensor per
    input)."""

    @staticmethod
    def forward(ctx, bridge, *ins):
        outs = bridge.forward(ins)
        ctx.bridge = bridge
        ctx.n_in = len(ins)
        ctx.save_for_backward(*ins, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        return (None, *ctx.bridge.backward(gs, ins, outs))


def _apply(bridge, in_vals):
    out = _BodyFn.apply(bridge, *in_vals)
    return out if len(out) > 1 else out[0]


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _from_numpy(a, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device=like.device, dtype=dtype)


# ---------------------------------------------------------------------------
# Generations 1/2: PythonOp -> NumpyOp / NDArrayOp
# ---------------------------------------------------------------------------

_INSTANCES: Dict[str, "PythonOp"] = {}
_instance_counter = itertools.count()


class PythonOp:
    """Base class of instance-style custom ops (reference
    ``operator.py:15``).  Override ``forward``/``backward``/
    ``infer_shape``/``list_arguments``/``list_outputs`` and call
    :meth:`get_symbol` to use the op in a symbol graph."""

    _numpy_style = True

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def infer_shape(self, in_shape):
        """Default: one output shaped like the first input."""
        return in_shape, [in_shape[0]]

    def need_top_grad(self) -> bool:
        """Whether backward needs the head gradient (False for losses)."""
        return self.need_top_grad_

    def forward(self, in_data, out_data):
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError

    def get_symbol(self, *args, **kwargs):
        from . import symbol as sym_mod
        name = kwargs.pop("name", None)
        key = f"_pyop_{next(_instance_counter)}"
        _INSTANCES[key] = self
        return sym_mod._apply_op("_PythonOp", list(args),
                                 {"op_instance_key": key}, name, kwargs)


class NumpyOp(PythonOp):
    """Custom op whose body sees numpy arrays (reference ``NumpyOp``):
    ``forward(in_data, out_data)`` and ``backward(out_grad, in_data,
    out_data, in_grad)`` write ``out_data``/``in_grad`` in place."""

    _numpy_style = True


class NDArrayOp(PythonOp):
    """Custom op whose body sees NDArrays on the inputs' device
    (reference ``NDArrayOp``), with the same in-place convention."""

    _numpy_style = False


class _PyOpBridge:
    """Marshals one ``_PythonOp`` node's values to and from its body."""

    def __init__(self, op: PythonOp, in_vals, out_shapes, out_dtype):
        self.op = op
        self.in_shapes = [tuple(v.shape) for v in in_vals]
        self.in_dtypes = [v.dtype for v in in_vals]
        self.out_shapes = out_shapes
        self.out_dtype = out_dtype

    def _wrap(self, tensors, writable):
        if self.op._numpy_style:
            return [_numpy(t) for t in tensors]
        return [NDArray(t.detach(), writable=writable) for t in tensors]

    def _unwrap(self, arrays, like, dtypes):
        if self.op._numpy_style:
            return [_from_numpy(a, like, d) for a, d in zip(arrays, dtypes)]
        return [a.data.to(d) for a, d in zip(arrays, dtypes)]

    def forward(self, ins):
        like = ins[0]
        outs = [torch.zeros(s, dtype=self.out_dtype, device=like.device)
                for s in self.out_shapes]
        out_w = self._wrap(outs, True)
        self.op.forward(in_data=self._wrap(ins, False), out_data=out_w)
        return self._unwrap(out_w, like, [self.out_dtype] * len(outs))

    def backward(self, gs, ins, outs):
        like = ins[0]
        grads = [torch.zeros(s, dtype=d, device=like.device)
                 for s, d in zip(self.in_shapes, self.in_dtypes)]
        grad_w = self._wrap(grads, True)
        out_grad = list(gs) if self.op.need_top_grad() else []
        self.op.backward(out_grad=self._wrap(out_grad, False),
                         in_data=self._wrap(ins, False),
                         out_data=self._wrap(outs, False), in_grad=grad_w)
        return self._unwrap(grad_w, like, self.in_dtypes)


def _pyop_forward(ctx, params, *in_vals):
    op = _INSTANCES[params["op_instance_key"]]
    _, out_shapes = op.infer_shape([list(v.shape) for v in in_vals])
    out_shapes = [tuple(s) for s in out_shapes]
    out_dtype = in_vals[0].dtype if in_vals else torch.float32
    return _apply(_PyOpBridge(op, in_vals, out_shapes, out_dtype), in_vals)


def _pyop_args(params):
    return _INSTANCES[params["op_instance_key"]].list_arguments()


def _pyop_outputs(params):
    return _INSTANCES[params["op_instance_key"]].list_outputs()


def _pyop_infer_shape(params, in_shapes):
    op = _INSTANCES[params["op_instance_key"]]
    if all(s is None for s in in_shapes):
        return in_shapes, [None] * len(op.list_outputs()), []
    ins, outs = op.infer_shape([list(s) if s is not None else None
                                for s in in_shapes])
    return ([tuple(s) if s is not None else None for s in ins],
            [tuple(s) if s is not None else None for s in outs], [])


register_op(OpDef(
    name="_PythonOp",
    forward=_pyop_forward,
    arguments=_pyop_args,
    outputs=_pyop_outputs,
    params={"op_instance_key": OpParam("op_instance_key", "str",
                                       required=True)},
    infer_shape=_pyop_infer_shape,
    doc="Instance-bound Python custom op (NumpyOp / NDArrayOp).",
))


# ---------------------------------------------------------------------------
# Generation 3: CustomOp / CustomOpProp / register
# ---------------------------------------------------------------------------

_CUSTOM_PROPS: Dict[str, type] = {}


class CustomOp:
    """Stateful custom operator body (reference ``CustomOp``); its arrays
    are numpy arrays."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Honour the grad_req write/add/null protocol."""
        if req in ("null", None):
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError(f"unknown req {req!r}")


class CustomOpProp:
    """Metadata and factory of a registered custom op (reference
    ``CustomOpProp``)."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def need_top_grad(self) -> bool:
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Class decorator registering a CustomOpProp under ``op_type``."""
    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register() expects a CustomOpProp subclass")
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_all_registered_operators() -> List[str]:
    return sorted(_CUSTOM_PROPS)


def _make_prop(params: Dict[str, Any]) -> CustomOpProp:
    op_type = params["op_type"]
    if op_type not in _CUSTOM_PROPS:
        raise MXNetError(
            f"custom op {op_type!r} not registered; known: "
            f"{get_all_registered_operators()}")
    kwargs = {k: v for k, v in params.items()
              if k != "op_type" and v is not None}
    return _CUSTOM_PROPS[op_type](**kwargs)


class _CustomOpDef(OpDef):
    """OpDef whose free-form params reach the prop's constructor as
    strings (the reference passes every Custom kwarg as a string)."""

    def parse_params(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        if "op_type" not in raw:
            raise MXNetError("Custom requires op_type=")
        return {k: str(v) for k, v in raw.items()
                if not (k.startswith("__") and k.endswith("__"))}


class _CustomBridge:
    """Marshals one ``Custom`` node's values to and from its numpy body."""

    def __init__(self, body: CustomOp, is_train, in_vals, out_shapes):
        self.body = body
        self.is_train = is_train
        self.in_shapes = [tuple(v.shape) for v in in_vals]
        self.in_dtypes = [v.dtype for v in in_vals]
        self.out_shapes = out_shapes

    def forward(self, ins):
        dt = self.in_dtypes[0]
        outs = [np.zeros(s, _NP_DTYPES[dt]) for s in self.out_shapes]
        self.body.forward(is_train=self.is_train,
                          req=["write"] * len(outs),
                          in_data=[_numpy(x) for x in ins], out_data=outs,
                          aux=[])
        return [_from_numpy(o, ins[0], dt) for o in outs]

    def backward(self, gs, ins, outs):
        in_grads = [np.zeros(s, _NP_DTYPES[d])
                    for s, d in zip(self.in_shapes, self.in_dtypes)]
        self.body.backward(req=["write"] * len(ins),
                           out_grad=[_numpy(g) for g in gs],
                           in_data=[_numpy(x) for x in ins],
                           out_data=[_numpy(o) for o in outs],
                           in_grad=in_grads, aux=[])
        return [_from_numpy(g, ins[0], d)
                for g, d in zip(in_grads, self.in_dtypes)]


def _custom_forward(ctx, params, *in_vals):
    prop = _make_prop(params)
    in_shapes = [tuple(v.shape) for v in in_vals]
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    out_shapes = [tuple(s) for s in out_shapes]
    body = prop.create_operator(
        _context_of(in_vals[0]), in_shapes,
        [_NP_DTYPES[v.dtype] for v in in_vals])
    return _apply(_CustomBridge(body, ctx.is_train, in_vals, out_shapes),
                  in_vals)


def _custom_args(params):
    return _make_prop(params).list_arguments()


def _custom_outputs(params):
    return _make_prop(params).list_outputs()


def _custom_infer_shape(params, in_shapes):
    prop = _make_prop(params)
    if all(s is None for s in in_shapes):
        return in_shapes, [None] * len(prop.list_outputs()), []
    ins, outs, aux = prop.infer_shape([list(s) if s is not None else None
                                       for s in in_shapes])
    return ([tuple(s) if s is not None else None for s in ins],
            [tuple(s) if s is not None else None for s in outs],
            [tuple(s) if s is not None else None for s in aux])


register_op(_CustomOpDef(
    name="Custom",
    forward=_custom_forward,
    arguments=_custom_args,
    outputs=_custom_outputs,
    params={"op_type": OpParam("op_type", "str", required=True)},
    infer_shape=_custom_infer_shape,
    func_name="Custom",
    doc="Registered Python custom op (CustomOp / CustomOpProp).",
))


def _refresh_generated_modules():
    """Expose ``Custom`` through the generated symbol and ndarray
    functions."""
    from . import ndarray as nd_mod, symbol as sym_mod
    sym_mod._init_symbol_module()
    nd_mod._init_ndarray_module()


_refresh_generated_modules()
