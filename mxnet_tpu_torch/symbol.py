"""Symbol: declarative graph construction.

Counterpart of ``mxnet_tpu/symbol.py``.  A :class:`Symbol` is a list of
output entries ``(node, out_index)`` over a DAG of :class:`_Node` s (op +
attrs + inputs).  Composition, auto-created variable inputs, auto-naming
(:mod:`.name`), attribute scoping (:mod:`.attribute`), shape and type
inference and the JSON format are the JAX package's, so a graph built
here lists the same arguments and auxiliary states under the same names,
and ``tojson``/``load_json`` read and write the same text as the JAX
package.  Op constructors (``Convolution``, ``BatchNorm``, ...) are
generated from the port's op registry.

Graphs run through :func:`mxnet_tpu_torch.graph_eval.eval_symbol`, in
the trainer or in an executor from ``bind``/``simple_bind``.
:meth:`Symbol.save` and :func:`load` write and read the same JSON files
as the JAX package's.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import attribute, name as _name_mod
from .base import MXNetError
from .ops.registry import OP_REGISTRY, OpDef, get_op

__all__ = ["Symbol", "Variable", "Group", "load", "load_json", "var"]


class _Node:
    """One graph node: an operator application or a variable."""

    __slots__ = ("op", "name", "attrs", "inputs")

    def __init__(self, op: Optional[OpDef], name: str,
                 attrs: Optional[Dict[str, str]] = None,
                 inputs: Optional[List[Tuple["_Node", int]]] = None):
        self.op = op
        self.name = name
        self.attrs: Dict[str, str] = dict(attrs or {})
        self.inputs: List[Tuple[_Node, int]] = list(inputs or [])

    @property
    def is_variable(self) -> bool:
        return self.op is None

    def param_attrs(self) -> Dict[str, str]:
        """Attrs that are op parameters (not __annotation__ attrs)."""
        return {k: v for k, v in self.attrs.items()
                if not (k.startswith("__") and k.endswith("__"))}

    def anno_attrs(self) -> Dict[str, str]:
        return {k[2:-2]: v for k, v in self.attrs.items()
                if k.startswith("__") and k.endswith("__")}

    def parsed_params(self) -> Dict[str, Any]:
        return self.op.parse_params(self.param_attrs())

    def num_outputs(self) -> int:
        if self.is_variable:
            return 1
        return len(self.op.list_outputs(self.parsed_params()))

    def aux_full_names(self) -> List[str]:
        if self.is_variable:
            return []
        return [f"{self.name}_{a}"
                for a in self.op.list_aux_states(self.parsed_params())]


def _topo_sort(heads: Sequence[Tuple[_Node, int]]) -> List[_Node]:
    """Post-DFS order: each node after its inputs, inputs visited in
    order (the JAX package's order; iterative, so depth is unbounded)."""
    order: List[_Node] = []
    visited = set()
    for (head, _) in heads:
        if id(head) in visited:
            continue
        visited.add(id(head))
        stack = [(head, 0)]
        while stack:
            node, i = stack[-1]
            if i < len(node.inputs):
                stack[-1] = (node, i + 1)
                src = node.inputs[i][0]
                if id(src) not in visited:
                    visited.add(id(src))
                    stack.append((src, 0))
            else:
                stack.pop()
                order.append(node)
    return order


class Symbol:
    """Symbolic multi-output expression."""

    def __init__(self, heads: List[Tuple[_Node, int]]):
        self._heads = list(heads)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def name(self) -> Optional[str]:
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def _topo(self) -> List[_Node]:
        return _topo_sort(self._heads)

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_variable]

    def list_outputs(self) -> List[str]:
        out = []
        for (node, idx) in self._heads:
            if node.is_variable:
                out.append(node.name)
            else:
                names = node.op.list_outputs(node.parsed_params())
                out.append(f"{node.name}_{names[idx]}")
        return out

    def list_auxiliary_states(self) -> List[str]:
        out = []
        for n in self._topo():
            out.extend(n.aux_full_names())
        return out

    def get_internals(self) -> "Symbol":
        """All single outputs of every node."""
        heads = []
        for n in self._topo():
            for i in range(n.num_outputs()):
                heads.append((n, i))
        return Symbol(heads)

    def __getitem__(self, index: Union[int, str]) -> "Symbol":
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError(f"no output named {index}; have {names}")
            index = names.index(index)
        return Symbol([self._heads[index]])

    def __len__(self) -> int:
        return len(self._heads)

    def __iter__(self):
        return (self[i] for i in range(len(self._heads)))

    def __repr__(self):
        if self.name is not None:
            return f"<Symbol {self.name}>"
        return f"<Symbol group [{', '.join(self.list_outputs())}]>"

    # ------------------------------------------------------------------
    # Attributes
    # ------------------------------------------------------------------

    def attr(self, key: str) -> Optional[str]:
        """The first head node's attribute ``key``: an annotation
        (``__key__``) first, else an op parameter; None when absent."""
        node = self._heads[0][0]
        return node.attrs.get(f"__{key}__", node.attrs.get(key))

    def _set_attr(self, **kwargs) -> None:
        node = self._heads[0][0]
        for k, v in kwargs.items():
            if not isinstance(v, str):
                raise MXNetError("attr values must be strings")
            node.attrs[f"__{k}__"] = v

    def list_attr(self) -> Dict[str, str]:
        """The first head node's annotations, without their underscores."""
        return self._heads[0][0].anno_attrs()

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        ret: Dict[str, Dict[str, str]] = {}
        for n in self._topo():
            d = dict(n.param_attrs())
            d.update(n.anno_attrs())
            if d:
                ret[n.name] = d
        return ret

    # ------------------------------------------------------------------
    # Arithmetic sugar (registered binary ops)
    # ------------------------------------------------------------------

    def _binop(self, other, opname: str, scalar_op: str, reverse=False):
        if isinstance(other, Symbol):
            lhs, rhs = (other, self) if reverse else (self, other)
            return _apply_op(opname, [lhs, rhs], {}, None)
        if isinstance(other, (int, float)):
            return _apply_op(scalar_op, [self], {"scalar": str(float(other))},
                             None)
        return NotImplemented

    def __add__(self, o): return self._binop(o, "_plus", "_plus_scalar")
    def __radd__(self, o): return self._binop(o, "_plus", "_plus_scalar")
    def __sub__(self, o): return self._binop(o, "_minus", "_minus_scalar")
    def __rsub__(self, o):
        return self._binop(o, "_minus", "_rminus_scalar", reverse=True)
    def __mul__(self, o): return self._binop(o, "_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binop(o, "_mul", "_mul_scalar")
    def __truediv__(self, o): return self._binop(o, "_div", "_div_scalar")
    def __rtruediv__(self, o):
        return self._binop(o, "_div", "_rdiv_scalar", reverse=True)
    def __pow__(self, o): return self._binop(o, "_power", "_power_scalar")
    def __neg__(self): return self._binop(-1.0, "_mul", "_mul_scalar")

    # ------------------------------------------------------------------
    # Composition
    # ------------------------------------------------------------------

    def __call__(self, *args: "Symbol", **kwargs: "Symbol") -> "Symbol":
        """Substitute this symbol's free variables with other symbols."""
        arg_names = self.list_arguments()
        sub: Dict[str, Symbol] = {}
        if len(args) > len(arg_names):
            raise MXNetError("too many positional arguments to compose")
        for an, s in zip(arg_names, args):
            sub[an] = s
        for k, s in kwargs.items():
            if k in sub:
                raise MXNetError(f"duplicate composition argument {k}")
            sub[k] = s
        for k in sub:
            if k not in arg_names:
                raise MXNetError(f"compose: no variable named {k}")
        mapping: Dict[int, _Node] = {}
        for node in self._topo():
            if node.is_variable and node.name in sub:
                rep_node, rep_idx = sub[node.name]._heads[0]
                if rep_idx != 0 and rep_node.num_outputs() > 1:
                    raise MXNetError("cannot substitute with non-first "
                                     "output")
                mapping[id(node)] = rep_node
            else:
                mapping[id(node)] = _Node(
                    node.op, node.name, node.attrs,
                    [(mapping[id(s)], i) for (s, i) in node.inputs])
        return Symbol([(mapping[id(n)], i) for (n, i) in self._heads])

    # ------------------------------------------------------------------
    # Shape / type inference
    # ------------------------------------------------------------------

    def infer_shape(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes = self._infer_shape_impl(
            *args, **kwargs)
        if any(s is None for s in arg_shapes):
            unknown = [n for n, s in zip(self.list_arguments(), arg_shapes)
                       if s is None]
            raise MXNetError(f"cannot fully infer shapes; unknown for "
                             f"{unknown}. Use infer_shape_partial for "
                             "partial inference.")
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(*args, **kwargs)

    def _infer_shape_impl(self, *args, **kwargs):
        arg_names = self.list_arguments()
        known: Dict[str, Tuple[int, ...]] = {}
        for n, s in zip(arg_names, args):
            if s is not None:
                known[n] = tuple(s)
        for k, s in kwargs.items():
            if s is not None:
                known[k] = tuple(s)
        topo = self._topo()
        shapes: Dict[Tuple[int, int], Optional[Tuple[int, ...]]] = {}
        aux_shapes: Dict[str, Optional[Tuple[int, ...]]] = {}
        var_shapes: Dict[str, Optional[Tuple[int, ...]]] = dict(known)

        for _sweep in range(2):  # two sweeps let late constraints back-fill
            for node in topo:
                if node.is_variable:
                    shapes[(id(node), 0)] = var_shapes.get(node.name)
                    continue
                params = node.parsed_params()
                in_shapes = [shapes.get((id(s), i)) for (s, i) in node.inputs]
                try:
                    new_in, out_s, aux_s = node.op.do_infer_shape(params,
                                                                  in_shapes)
                except MXNetError:
                    raise
                except Exception as e:  # noqa: BLE001  (names the node)
                    raise MXNetError(
                        f"infer_shape error at node {node.name} "
                        f"({node.op.name}): {e}") from e
                for (src, i), s in zip(node.inputs, new_in):
                    if s is not None:
                        prev = shapes.get((id(src), i))
                        if prev is not None and tuple(prev) != tuple(s):
                            raise MXNetError(
                                f"shape mismatch at {node.name}: {prev} vs "
                                f"{s}")
                        shapes[(id(src), i)] = tuple(s)
                        if src.is_variable:
                            var_shapes[src.name] = tuple(s)
                for i, s in enumerate(out_s):
                    if s is not None:
                        shapes[(id(node), i)] = tuple(s)
                for aname, s in zip(node.aux_full_names(), aux_s):
                    aux_shapes[aname] = None if s is None else tuple(s)

        arg_out = [var_shapes.get(n) for n in arg_names]
        head_out = [shapes.get((id(n), i)) for (n, i) in self._heads]
        aux_out = [aux_shapes.get(n) for n in self.list_auxiliary_states()]
        return arg_out, head_out, aux_out

    def infer_type(self, *args, **kwargs):
        arg_names = self.list_arguments()
        known: Dict[str, np.dtype] = {}
        for n, t in zip(arg_names, args):
            if t is not None:
                known[n] = np.dtype(t)
        for k, t in kwargs.items():
            if t is not None:
                known[k] = np.dtype(t)
        types: Dict[Tuple[int, int], Optional[np.dtype]] = {}
        var_types: Dict[str, Optional[np.dtype]] = dict(known)
        aux_types: Dict[str, Optional[np.dtype]] = {}
        for node in self._topo():
            if node.is_variable:
                types[(id(node), 0)] = var_types.get(node.name,
                                                     np.dtype(np.float32))
                var_types.setdefault(node.name, np.dtype(np.float32))
                continue
            params = node.parsed_params()
            in_types = [types.get((id(s), i)) for (s, i) in node.inputs]
            new_in, out_t, aux_t = node.op.do_infer_type(params, in_types)
            for (src, i), t in zip(node.inputs, new_in):
                if t is not None and types.get((id(src), i)) is None:
                    types[(id(src), i)] = np.dtype(t)
                    if src.is_variable:
                        var_types[src.name] = np.dtype(t)
            for i, t in enumerate(out_t):
                types[(id(node), i)] = None if t is None else np.dtype(t)
            for aname, t in zip(node.aux_full_names(), aux_t):
                aux_types[aname] = None if t is None else np.dtype(t)
        arg_out = [var_types.get(n) for n in arg_names]
        head_out = [types.get((id(n), i)) for (n, i) in self._heads]
        aux_out = [aux_types.get(n, np.dtype(np.float32))
                   for n in self.list_auxiliary_states()]
        return arg_out, head_out, aux_out

    # ------------------------------------------------------------------
    # Serialization: the JAX package's JSON, text for text
    # ------------------------------------------------------------------

    def tojson(self) -> str:
        topo = self._topo()
        node_ids = {id(n): i for i, n in enumerate(topo)}
        nodes = [{
            "op": "null" if n.is_variable else n.op.name,
            "name": n.name,
            "attrs": dict(n.attrs),
            "inputs": [[node_ids[id(s)], i] for (s, i) in n.inputs],
        } for n in topo]
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(topo) if n.is_variable],
            "heads": [[node_ids[id(n)], i] for (n, i) in self._heads],
            "mxtpu_version": 1,
        }, indent=2)

    def save(self, fname: str) -> None:
        """Write :meth:`tojson` to a path or ``scheme://`` URI; either
        package's :func:`load` reads it back."""
        from .stream import open_uri
        with open_uri(fname, "w") as f:
            f.write(self.tojson())

    # ------------------------------------------------------------------
    # Binding (executor.py)
    # ------------------------------------------------------------------

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind arrays (lists in ``list_arguments`` order, or dicts) into
        an :class:`~mxnet_tpu_torch.executor.Executor` on ``ctx``."""
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx, shared_exec=shared_exec)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """Infer shapes from ``kwargs``, allocate zero arrays on ``ctx``
        (gradient arrays for every argument whose ``grad_req`` is not
        ``null``) and bind.  With ``shared_exec``, its arrays of the same
        name and shape are reused."""
        from . import ndarray as nd
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_types, _, aux_types = self.infer_type(**dict(type_dict or {}))

        def req_for(aname):
            if isinstance(grad_req, str):
                return grad_req
            if isinstance(grad_req, dict):
                return grad_req.get(aname, "null")
            return "write"

        def alloc(aname, shape, dtype, which):
            if shared_exec is not None:
                arr = getattr(shared_exec, which).get(aname)
                if arr is not None and tuple(arr.shape) == tuple(shape):
                    return arr
            return nd.zeros(shape, ctx=ctx, dtype=dtype)

        args, args_grad = {}, {}
        for aname, shape, dtype in zip(self.list_arguments(), arg_shapes,
                                       arg_types):
            args[aname] = alloc(aname, shape, dtype, "arg_dict")
            if req_for(aname) != "null":
                args_grad[aname] = alloc(aname, shape, dtype, "grad_dict")
        aux_states = {aname: alloc(aname, shape, dtype, "aux_dict")
                      for aname, shape, dtype in zip(
                          self.list_auxiliary_states(), aux_shapes,
                          aux_types)}
        return self.bind(ctx, args, args_grad or None, grad_req, aux_states,
                         group2ctx=group2ctx, shared_exec=shared_exec)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def _scope_attrs() -> Dict[str, str]:
    """Current AttrScope attrs in stored (``__key__``) form."""
    return {f"__{k}__": v for k, v in attribute.current().get(None).items()}


def Variable(name: str, attr: Optional[Dict[str, str]] = None,
             shape=None, lr_mult=None, wd_mult=None, dtype=None,
             init=None) -> Symbol:
    """Create a free variable."""
    if not isinstance(name, str):
        raise MXNetError("Variable name must be a string")
    attrs = _scope_attrs()
    attrs.update(
        {f"__{k}__" if not (k.startswith("__") and k.endswith("__")) else k: v
         for k, v in (attr or {}).items()})
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        attrs["__dtype__"] = str(np.dtype(dtype))
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    return Symbol([(_Node(None, name, attrs), 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    """Group symbols into one multi-output symbol."""
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


# ---------------------------------------------------------------------------
# Op constructors generated from the registry
# ---------------------------------------------------------------------------

def _apply_op(opname: str, sym_args: List[Symbol], str_params: Dict[str, str],
              name: Optional[str],
              sym_kwargs: Optional[Dict[str, Symbol]] = None) -> Symbol:
    op = get_op(opname)
    params = op.parse_params(str_params)
    arg_names = op.list_arguments(params)
    hint = op.name.lower().lstrip("_")
    name = _name_mod.current().get(name, hint)
    assigned: Dict[str, Symbol] = {}
    for an, s in zip(arg_names, sym_args):
        assigned[an] = s
    for k, s in (sym_kwargs or {}).items():
        if k in assigned:
            raise MXNetError(f"op {opname}: argument {k} given twice")
        if k not in arg_names:
            raise MXNetError(f"op {opname}: no argument named {k}; has "
                             f"{arg_names}")
        assigned[k] = s
    inputs: List[Tuple[_Node, int]] = []
    for an in arg_names:
        if an in assigned:
            s = assigned[an]
            if len(s._heads) != 1:
                raise MXNetError(f"op {opname}: argument {an} must be "
                                 "single-output")
            inputs.append(s._heads[0])
        else:
            # auto-create the variable, as the reference compose does
            inputs.append((_Node(None, f"{name}_{an}", _scope_attrs()), 0))
    attrs = _scope_attrs()
    attrs.update({k: str(v) for k, v in str_params.items()})
    node = _Node(op, name, attrs, inputs)
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _make_symbol_function(opname: str, func_name: str):
    op = get_op(opname)

    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_args = []
        pos_scalars = []
        for a in args:
            if isinstance(a, Symbol):
                sym_args.append(a)
            else:
                pos_scalars.append(a)
        sym_kwargs = {}
        str_params = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                sym_kwargs[k] = v
            else:
                str_params[k] = v if isinstance(v, str) else str(
                    tuple(v) if isinstance(v, (list, tuple)) else v)
        if "num_args" in op.params and "num_args" not in str_params:
            str_params["num_args"] = str(len(sym_args) + len(sym_kwargs))
        if pos_scalars:
            remaining = [p for p in op.params if p not in str_params]
            for v in pos_scalars:
                if not remaining:
                    raise MXNetError(f"{func_name}: too many positional "
                                     "args")
                str_params[remaining.pop(0)] = str(v)
        out = _apply_op(opname, sym_args, str_params, name, sym_kwargs)
        if attr:
            out._heads[0][0].attrs.update(
                {f"__{k}__": v for k, v in attr.items()})
        return out

    fn.__name__ = func_name
    fn.__doc__ = op.doc or f"{opname} symbol constructor"
    return fn


def load_json(json_str: str) -> Symbol:
    """A symbol from the JSON :meth:`Symbol.tojson` writes (either
    package's)."""
    data = json.loads(json_str)
    nodes: List[_Node] = []
    for spec in data["nodes"]:
        opname = spec["op"]
        op = None if opname == "null" else get_op(opname)
        node = _Node(op, spec["name"], spec.get("attrs", {}))
        node.inputs = [(nodes[i], j) for (i, j) in spec["inputs"]]
        nodes.append(node)
    return Symbol([(nodes[i], j) for (i, j) in data["heads"]])


def load(fname: str) -> Symbol:
    """A symbol from a file written by :meth:`Symbol.save` (either
    package's)."""
    from .stream import open_uri
    with open_uri(fname, "r") as f:
        return load_json(f.read())


def _init_symbol_module():
    g = globals()
    for opname, op in OP_REGISTRY.items():
        fname = op.func_name or opname
        if fname in ("Variable", "Group", "load", "load_json"):
            continue
        g[fname] = _make_symbol_function(opname, fname)
        if opname != fname and opname not in g:
            g[opname] = g[fname]
        if not fname.startswith("_") and fname not in __all__:
            __all__.append(fname)


_init_symbol_module()
