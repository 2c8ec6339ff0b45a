"""Operator registry: declarative metadata + PyTorch implementations.

Counterpart of ``mxnet_tpu/ops/registry.py``.  An :class:`OpDef` carries
an op's arguments, outputs, auxiliary states, parameters
(:class:`OpParam`, parsed from the same strings the symbol JSON holds)
and shape inference; its ``forward(ctx, params, *inputs)`` computes on
torch tensors.  Backward is autograd's, except for ops with their own
gradient rule (``SoftmaxOutput``), which wrap a
``torch.autograd.Function``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..base import MXNetError, Registry

__all__ = ["OpParam", "OpDef", "OpContext", "register_op", "get_op",
           "OP_REGISTRY", "elemwise_shape"]


# ---------------------------------------------------------------------------
# Declarative parameters (dmlc::Parameter analog)
# ---------------------------------------------------------------------------

def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, np.integer)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1"):
        return True
    if s in ("false", "0"):
        return False
    raise ValueError(f"cannot parse bool from {v!r}")


def _parse_tuple(cast):
    def parse(v):
        if isinstance(v, (tuple, list)):
            return tuple(cast(x) for x in v)
        val = ast.literal_eval(str(v).strip())
        if isinstance(val, (int, float)):
            return (cast(val),)
        return tuple(cast(x) for x in val)
    return parse


def _parse_int(v):
    if (not isinstance(v, str) or v.strip().lstrip("+-").isdigit()
            or "." in v):
        return int(float(v))
    return int(v)


_PARAM_PARSERS: Dict[str, Callable[[Any], Any]] = {
    "int": _parse_int,
    "float": float,
    "bool": _parse_bool,
    "str": str,
    "shape": _parse_tuple(int),
    "floats": _parse_tuple(float),
}


@dataclass
class OpParam:
    """One declarative op parameter (a dmlc::Parameter field)."""

    name: str
    type: str = "str"                   # int | float | bool | str | shape
    default: Any = None
    required: bool = False
    enum: Optional[Sequence[str]] = None
    doc: str = ""

    def parse(self, value: Any) -> Any:
        if value is None:
            if self.required:
                raise MXNetError(f"required parameter '{self.name}' missing")
            return self.default
        try:
            out = _PARAM_PARSERS[self.type](value)
        except (ValueError, SyntaxError) as e:
            raise MXNetError(f"parameter '{self.name}': {e}") from e
        if self.enum is not None and out not in self.enum:
            raise MXNetError(
                f"parameter '{self.name}' must be one of {list(self.enum)}, "
                f"got {out!r}")
        return out


# ---------------------------------------------------------------------------
# Op execution context
# ---------------------------------------------------------------------------

class OpContext:
    """Per-invocation state handed to op forward functions: the training
    flag, the random source (a ``torch.Generator`` or None), the node's
    current aux states and the aux updates it writes."""

    __slots__ = ("is_train", "rng", "aux", "aux_updates", "name")

    def __init__(self, is_train: bool = False, rng=None,
                 aux: Optional[Dict[str, Any]] = None, name: str = ""):
        self.is_train = is_train
        self.rng = rng
        self.aux = aux or {}
        self.aux_updates: Dict[str, Any] = {}
        self.name = name


# ---------------------------------------------------------------------------
# Op definition
# ---------------------------------------------------------------------------

ShapeT = Optional[Tuple[int, ...]]
ListOrFn = Union[Sequence[str], Callable[[Dict[str, Any]], Sequence[str]]]


def _resolve(lst: ListOrFn, params: Dict[str, Any]) -> List[str]:
    if callable(lst):
        return list(lst(params))
    return list(lst)


@dataclass
class OpDef:
    """A registered operator.

    ``forward(ctx, params, *inputs) -> tensor or tuple of tensors``.
    ``infer_shape(params, in_shapes) -> (in_shapes, out_shapes,
    aux_shapes)``, unknown input shapes arriving as ``None``.
    """

    name: str
    forward: Callable[..., Any]
    arguments: ListOrFn = ("data",)
    outputs: ListOrFn = ("output",)
    aux_states: ListOrFn = ()
    params: Dict[str, OpParam] = field(default_factory=dict)
    infer_shape: Optional[Callable[..., Tuple[List[ShapeT], List[ShapeT],
                                              List[ShapeT]]]] = None
    infer_type: Optional[Callable[..., Any]] = None
    doc: str = ""
    func_name: Optional[str] = None

    def list_arguments(self, params: Dict[str, Any]) -> List[str]:
        return _resolve(self.arguments, params)

    def list_outputs(self, params: Dict[str, Any]) -> List[str]:
        return _resolve(self.outputs, params)

    def list_aux_states(self, params: Dict[str, Any]) -> List[str]:
        return _resolve(self.aux_states, params)

    def parse_params(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for pname, spec in self.params.items():
            out[pname] = spec.parse(raw.get(pname))
        unknown = set(raw) - set(self.params)
        bad = [u for u in unknown
               if not (u.startswith("__") and u.endswith("__"))]
        if bad:
            raise MXNetError(f"op {self.name}: unknown parameter(s) "
                             f"{sorted(bad)}")
        return out

    def do_infer_shape(self, params: Dict[str, Any], in_shapes: List[ShapeT]):
        if self.infer_shape is None:
            return elemwise_shape(params, in_shapes)
        return self.infer_shape(params, in_shapes)

    def do_infer_type(self, params: Dict[str, Any],
                      in_types: List[Optional[np.dtype]]):
        if self.infer_type is not None:
            return self.infer_type(params, in_types)
        known = [t for t in in_types if t is not None]
        dt = known[0] if known else None
        n_in = len(self.list_arguments(params))
        n_out = len(self.list_outputs(params))
        n_aux = len(self.list_aux_states(params))
        return ([dt] * n_in, [dt] * n_out, [dt] * n_aux)


# ---------------------------------------------------------------------------
# Common shape functions
# ---------------------------------------------------------------------------

def elemwise_shape(params, in_shapes):
    """All inputs and the single output share one shape."""
    known = [s for s in in_shapes if s is not None]
    if not known:
        return in_shapes, [None], []
    shp = known[0]
    for s in known[1:]:
        if tuple(s) != tuple(shp):
            raise MXNetError(f"incompatible shapes {s} vs {shp}")
    return [tuple(shp)] * len(in_shapes), [tuple(shp)], []


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

OP_REGISTRY: Registry[OpDef] = Registry("operator")


def register_op(opdef: OpDef) -> OpDef:
    OP_REGISTRY.register(opdef, name=opdef.name)
    return opdef


def get_op(name: str) -> OpDef:
    try:
        return OP_REGISTRY.get(name)
    except KeyError as e:
        raise MXNetError(str(e)) from e
