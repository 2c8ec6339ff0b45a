"""Simple (tensor-algebra) operators.

Counterpart of ``mxnet_tpu/ops/simple_ops.py``, op for op, with the same
names, parameters, shape rules and ``func_name`` s: one registration
exposes each op to the imperative API (``nd.<func_name>``) and to
symbols.  ``a + b`` on symbols or arrays composes ``_plus``, ``a + 2.0``
composes ``_plus_scalar``, and likewise for ``-``, ``*``, ``/`` and
``**``; the rest are the unary math, reductions, broadcasting and matrix
ops, the losses, sampling and the ``NDArray`` helpers of the reference.
Each is a PyTorch one-liner; gradients are autograd's.

Whole-array reductions return shape-``(1,)`` arrays, as in the
reference.  The samplers draw from the ``torch.Generator`` in the op
context (``ctx.rng``, :mod:`mxnet_tpu_torch.random`), so their streams
replay within the port and differ from the JAX package's PRNG bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import OpDef, OpParam, elemwise_shape, register_op

__all__ = []  # ops land in the registry


# ---------------------------------------------------------------------------
# Shape helpers
# ---------------------------------------------------------------------------

def _reduce_all_shape(params, in_shapes):
    return in_shapes, [(1,)], []


def _broadcast_binary_shape(params, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [None], []
    out = tuple(np.broadcast_shapes(tuple(a), tuple(b)))
    return [tuple(a), tuple(b)], [out], []


def _dot_shape(params, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [None], []
    a, b = tuple(a), tuple(b)
    if len(a) == 1 and len(b) == 1:
        if a[0] != b[0]:
            raise MXNetError(f"dot shape mismatch {a} {b}")
        return [a, b], [(1,)], []
    if len(a) == 2 and len(b) == 2:
        if a[1] != b[0]:
            raise MXNetError(f"dot shape mismatch {a} {b}")
        return [a, b], [(a[0], b[1])], []
    raise MXNetError(f"dot supports 1D/2D, got {a} x {b}")


# ---------------------------------------------------------------------------
# Registration helpers
# ---------------------------------------------------------------------------

def _unary(name, fn, doc=""):
    register_op(OpDef(
        name=name,
        forward=lambda ctx, params, x, _fn=fn: _fn(x),
        arguments=("data",),
        infer_shape=elemwise_shape,
        func_name=name,
        doc=doc,
    ))


def _binary(name, fn, doc="", shape_fn=elemwise_shape):
    register_op(OpDef(
        name=name,
        forward=lambda ctx, params, lhs, rhs, _fn=fn: _fn(lhs, rhs),
        arguments=("lhs", "rhs"),
        infer_shape=shape_fn,
        func_name=name,
        doc=doc,
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


def _scalar_like(s, x):
    """``s`` as a 0-d tensor of the type ``x`` takes with a Python scalar
    (a scalar base or bound): ``jnp``'s weak scalar, so an integer ``x``
    with a fractional ``s`` promotes to float rather than truncating
    ``s``."""
    # a fill, not a copy from the host: capturable in a CUDA graph
    return torch.full((), s, dtype=torch.result_type(x, s), device=x.device)


# ---------------------------------------------------------------------------
# Elementwise binary
# ---------------------------------------------------------------------------

_binary("_plus", torch.add, doc="elementwise add")
_binary("_minus", torch.sub, doc="elementwise subtract")
_binary("_mul", torch.mul, doc="elementwise multiply")
_binary("_div", torch.div, doc="elementwise divide")
_binary("_power", torch.pow, doc="elementwise power")
_binary("_maximum", torch.maximum, doc="elementwise maximum")
_binary("_minimum", torch.minimum, doc="elementwise minimum")

_binary_scalar("_plus_scalar", lambda x, s: x + s)
_binary_scalar("_minus_scalar", lambda x, s: x - s)
_binary_scalar("_rminus_scalar", lambda x, s: s - x)
_binary_scalar("_mul_scalar", lambda x, s: x * s)
_binary_scalar("_div_scalar", lambda x, s: x / s)
_binary_scalar("_rdiv_scalar", lambda x, s: s / x)
_binary_scalar("_power_scalar", lambda x, s: torch.pow(x, s))
_binary_scalar("_rpower_scalar", lambda x, s: torch.pow(_scalar_like(s, x), x))
_binary_scalar("_maximum_scalar",
               lambda x, s: torch.maximum(x, _scalar_like(s, x)))
_binary_scalar("_minimum_scalar",
               lambda x, s: torch.minimum(x, _scalar_like(s, x)))

# ---------------------------------------------------------------------------
# Elementwise unary math
# ---------------------------------------------------------------------------

# abs and clip as jnp writes them, so their gradients split ties as JAX's
# do: abs has gradient 1 at 0, clip 0.5 at either bound (adding 0 turns
# -0.0 into 0.0, as lax.abs gives)
_unary("abs", lambda x: torch.where(x >= 0, x, -x) + 0)
_unary("sign", torch.sign)
_unary("round", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("cos", torch.cos)
_unary("sin", torch.sin)
_unary("negative", torch.negative)
_unary("sigmoid", torch.sigmoid)
_unary("relu", torch.relu)
_unary("tanh", torch.tanh)

register_op(OpDef(
    name="clip",
    forward=lambda ctx, params, x: torch.minimum(
        torch.maximum(x, _scalar_like(params["a_min"], x)),
        _scalar_like(params["a_max"], x)),
    arguments=("data",),
    params={
        "a_min": OpParam("a_min", "float", required=True),
        "a_max": OpParam("a_max", "float", required=True),
    },
    infer_shape=elemwise_shape,
    func_name="clip",
    doc="clip values to [a_min, a_max]",
))

# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

# Over a mesh's data axis (the trainer's implicit mode), a reduction over
# the rows of the batch meets the other members (``OpContext.sync``,
# ``reduces_rows``): sums from the members' partial sums (differentiable
# into every member's rows), a norm from their summed squares, a max or
# min from their extremes with the gradient split over every tied winner
# of the global batch, as ``jax.grad`` of the global reduction splits it.

def _rows_sync(ctx):
    sync = ctx.sync
    return sync if sync is not None and sync.reduces_rows else None


class _GlobalExtremeFn(torch.autograd.Function):
    """The members' common extreme ``m`` (keepdim layout) of their
    inputs ``xs`` (one a member, each on its device); the gradient of
    each element equal to ``m`` is ``g / count`` (``count``: the equal
    elements of every member), the others' zero."""

    @staticmethod
    def forward(ctx, m, count, *xs):
        ctx.save_for_backward(m, count, *xs)
        return m.clone()

    @staticmethod
    def backward(ctx, g):
        m, count, *xs = ctx.saved_tensors
        share = g / count
        grads = [torch.where(x == m.to(x.device), share.to(x.device, x.dtype),
                             torch.zeros((), dtype=x.dtype, device=x.device))
                 for x in xs]
        return (None, None, *grads)


def _global_extreme(sync, x, dims, is_max):
    """The max (or min) over ``dims`` of every member's ``x``, keepdim."""
    pick = torch.amax if is_max else torch.amin
    with torch.no_grad():
        m = pick(x, dim=dims, keepdim=True)
    parts = sync.parts(m)
    both = torch.maximum if is_max else torch.minimum
    with torch.no_grad():
        top = parts[0].to(x.device)
        for p in parts[1:]:
            top = both(top, p.to(x.device))
    xs = sync.parts(x)
    with torch.no_grad():
        count = sum((xj == top.to(xj.device)).sum(dim=dims, keepdim=True)
                    .to(x.device, x.dtype) for xj in xs)
    return _GlobalExtremeFn.apply(top, count, *xs)


def _whole_fwd(name, fn):
    def fwd(ctx, params, x):
        sync = _rows_sync(ctx)
        if sync is None:
            return fn(x).reshape(1)
        if name == "sum":
            return sync.allreduce(torch.sum(x).reshape(1))
        dims = tuple(range(x.dim()))
        return _global_extreme(sync, x, dims, name == "max").reshape(1)
    return fwd


def _norm_fwd(ctx, params, x):
    sync = _rows_sync(ctx)
    sq = torch.sum(torch.square(x))
    if sync is not None:
        sq = sync.allreduce(sq)
    return torch.sqrt(sq).reshape(1)


register_op(OpDef(
    name="norm",
    forward=_norm_fwd,
    arguments=("data",),
    infer_shape=elemwise_shape,
    func_name="norm",
))
for _rname, _rfn in (("sum", torch.sum), ("max", torch.amax),
                     ("min", torch.amin)):
    register_op(OpDef(
        name=_rname,
        forward=_whole_fwd(_rname, _rfn),
        arguments=("data",),
        infer_shape=_reduce_all_shape,
        func_name=_rname,
        doc=f"{_rname} over all elements",
    ))


def _axes(params, ndim):
    axes = params["axis"]
    if isinstance(axes, int):
        axes = (axes,)
    return tuple(a % ndim for a in axes)


def _axis_reduce_shape(params, in_shapes):
    (s,) = in_shapes
    if s is None:
        return in_shapes, [None], []
    axes = _axes(params, len(s))
    if params.get("keepdims"):
        out = tuple(1 if i in axes else d for i, d in enumerate(s))
    else:
        out = tuple(d for i, d in enumerate(s) if i not in axes)
        if out == ():
            out = (1,)
    return [tuple(s)], [out], []


def _make_axis_reduce(name, fn):
    def fwd(ctx, params, x, _fn=fn):
        dims = _axes(params, x.dim())
        keep = bool(params["keepdims"])
        sync = _rows_sync(ctx)
        if sync is None:
            out = _fn(x, dim=dims, keepdim=keep)
        elif name == "sum_axis":
            out = sync.allreduce(_fn(x, dim=dims, keepdim=keep))
        else:
            out = _global_extreme(sync, x, dims, name == "max_axis")
            if not keep:
                out = out.reshape([d for i, d in enumerate(out.shape)
                                   if i not in dims])
        if out.dim() == 0:
            out = out.reshape(1)
        return out
    register_op(OpDef(
        name=name,
        forward=fwd,
        arguments=("data",),
        params={
            "axis": OpParam("axis", "shape", default=(0,)),
            "keepdims": OpParam("keepdims", "bool", default=False),
        },
        infer_shape=_axis_reduce_shape,
        func_name=name,
        doc=f"{name} over given axes",
    ))


_make_axis_reduce("sum_axis", torch.sum)
_make_axis_reduce("max_axis", torch.amax)
_make_axis_reduce("min_axis", torch.amin)

register_op(OpDef(
    name="argmax_channel",
    forward=lambda ctx, params, x: torch.argmax(x, dim=1).to(x.dtype),
    arguments=("data",),
    infer_shape=lambda params, in_shapes: (
        in_shapes,
        [None if in_shapes[0] is None else (in_shapes[0][0],)],
        []),
    func_name="argmax_channel",
    doc="argmax over axis 1 (channel)",
))

# ---------------------------------------------------------------------------
# Broadcasting
# ---------------------------------------------------------------------------


def _axis_sizes(params):
    axes, sizes = params["axis"], params["size"]
    if isinstance(axes, int):
        axes = (axes,)
    if isinstance(sizes, int):
        sizes = (sizes,)
    return axes, sizes


def _broadcast_axis_shape(params, in_shapes):
    (s,) = in_shapes
    if s is None:
        return in_shapes, [None], []
    out = list(s)
    for a, sz in zip(*_axis_sizes(params)):
        if s[a] != 1:
            raise MXNetError(f"broadcast_axis: axis {a} of {s} must be 1")
        out[a] = sz
    return [tuple(s)], [tuple(out)], []


def _broadcast_axis_fwd(ctx, params, x):
    target = list(x.shape)
    for a, sz in zip(*_axis_sizes(params)):
        target[a] = sz
    return torch.broadcast_to(x, tuple(target))


register_op(OpDef(
    name="broadcast_axis",
    forward=_broadcast_axis_fwd,
    arguments=("data",),
    params={
        "axis": OpParam("axis", "shape", default=(0,)),
        "size": OpParam("size", "shape", default=(1,)),
    },
    infer_shape=_broadcast_axis_shape,
    func_name="broadcast_axis",
))

_binary("broadcast_plus", torch.add, shape_fn=_broadcast_binary_shape)
_binary("broadcast_minus", torch.sub, shape_fn=_broadcast_binary_shape)
_binary("broadcast_mul", torch.mul, shape_fn=_broadcast_binary_shape)
_binary("broadcast_div", torch.div, shape_fn=_broadcast_binary_shape)
_binary("broadcast_power", torch.pow, shape_fn=_broadcast_binary_shape)

# ---------------------------------------------------------------------------
# Matrix ops
# ---------------------------------------------------------------------------

_binary("dot", lambda a, b: (torch.dot(a, b).reshape(1)
                             if a.dim() == 1 and b.dim() == 1
                             else torch.matmul(a, b)),
        shape_fn=_dot_shape, doc="matrix/vector product (cuBLAS)")


def _transpose_axes(params, ndim):
    axes = params["axes"]
    return tuple(axes) if axes else tuple(reversed(range(ndim)))


def _transpose_shape(params, in_shapes):
    (s,) = in_shapes
    if s is None:
        return in_shapes, [None], []
    return ([tuple(s)],
            [tuple(s[a] for a in _transpose_axes(params, len(s)))], [])


register_op(OpDef(
    name="transpose",
    forward=lambda ctx, params, x: x.permute(
        _transpose_axes(params, x.dim())),
    arguments=("data",),
    params={"axes": OpParam("axes", "shape", default=())},
    infer_shape=_transpose_shape,
    func_name="transpose",
))


def _expand_dims_shape(params, in_shapes):
    (s,) = in_shapes
    if s is None:
        return in_shapes, [None], []
    ax = params["axis"]
    out = list(s)
    out.insert(ax if ax >= 0 else len(s) + 1 + ax, 1)
    return [tuple(s)], [tuple(out)], []


register_op(OpDef(
    name="expand_dims",
    forward=lambda ctx, params, x: torch.unsqueeze(x, params["axis"]),
    arguments=("data",),
    params={"axis": OpParam("axis", "int", required=True)},
    infer_shape=_expand_dims_shape,
    func_name="expand_dims",
))


def _slice_bounds(params, s):
    ax = params["axis"] % len(s)
    begin, end = params["begin"], params["end"]
    if end is None or end == 0:
        end = s[ax]
    if end < 0:
        end += s[ax]
    if begin < 0:
        begin += s[ax]
    return ax, begin, end


def _slice_axis_shape(params, in_shapes):
    (s,) = in_shapes
    if s is None:
        return in_shapes, [None], []
    ax, begin, end = _slice_bounds(params, s)
    out = list(s)
    out[ax] = end - begin
    return [tuple(s)], [tuple(out)], []


def _slice_axis_fwd(ctx, params, x):
    ax, begin, end = _slice_bounds(params, tuple(x.shape))
    return torch.narrow(x, ax, begin, end - begin)


register_op(OpDef(
    name="slice_axis",
    forward=_slice_axis_fwd,
    arguments=("data",),
    params={
        "axis": OpParam("axis", "int", required=True),
        "begin": OpParam("begin", "int", required=True),
        "end": OpParam("end", "int", default=0),
    },
    infer_shape=_slice_axis_shape,
    func_name="slice_axis",
))

register_op(OpDef(
    name="flip",
    forward=lambda ctx, params, x: torch.flip(x, (params["axis"],)),
    arguments=("data",),
    params={"axis": OpParam("axis", "int", required=True)},
    infer_shape=elemwise_shape,
    func_name="flip",
))

# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _smooth_l1(ctx, params, x):
    s2 = params["sigma"] * params["sigma"]
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


register_op(OpDef(
    name="smooth_l1",
    forward=_smooth_l1,
    arguments=("data",),
    params={"sigma": OpParam("sigma", "float", default=1.0)},
    infer_shape=elemwise_shape,
    func_name="smooth_l1",
))


def _softmax_cross_entropy(ctx, params, data, label):
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, -1, label.long()[:, None])[:, 0]
    out = -torch.sum(picked).reshape(1)
    sync = _rows_sync(ctx)
    return out if sync is None else sync.allreduce(out)


register_op(OpDef(
    name="softmax_cross_entropy",
    forward=_softmax_cross_entropy,
    arguments=("data", "label"),
    infer_shape=lambda params, in_shapes: (in_shapes, [(1,)], []),
    func_name="softmax_cross_entropy",
))

# ---------------------------------------------------------------------------
# Sampling: the generator comes from the op context
# ---------------------------------------------------------------------------


def _sample_shape(params, in_shapes):
    return [], [tuple(params["shape"])], []


register_op(OpDef(
    name="_sample_uniform",
    forward=lambda ctx, params: params["low"] + (
        params["high"] - params["low"]) * torch.rand(
        tuple(params["shape"]), generator=ctx.rng, device=ctx.rng.device),
    arguments=(),
    params={
        "low": OpParam("low", "float", default=0.0),
        "high": OpParam("high", "float", default=1.0),
        "shape": OpParam("shape", "shape", required=True),
    },
    infer_shape=_sample_shape,
    func_name="_sample_uniform",
    needs_rng=True,
))

register_op(OpDef(
    name="_sample_normal",
    forward=lambda ctx, params: params["loc"] + params["scale"] * torch.randn(
        tuple(params["shape"]), generator=ctx.rng, device=ctx.rng.device),
    arguments=(),
    params={
        "loc": OpParam("loc", "float", default=0.0),
        "scale": OpParam("scale", "float", default=1.0),
        "shape": OpParam("shape", "shape", required=True),
    },
    infer_shape=_sample_shape,
    func_name="_sample_normal",
    needs_rng=True,
))

# ---------------------------------------------------------------------------
# NDArray helpers of the reference, registered as ops so both APIs see them
# ---------------------------------------------------------------------------


def _onehot(ctx, params, ind, out_like):
    classes = torch.arange(out_like.shape[1], device=ind.device)
    return (ind.long()[:, None] == classes).to(out_like.dtype)


register_op(OpDef(
    name="onehot_encode",
    forward=_onehot,
    arguments=("indices", "out_like"),
    infer_shape=lambda params, in_shapes: (in_shapes, [in_shapes[1]], []),
    func_name="onehot_encode",
))

register_op(OpDef(
    name="choose_element_0index",
    forward=lambda ctx, params, lhs, rhs: torch.gather(
        lhs, 1, rhs.long()[:, None])[:, 0],
    arguments=("lhs", "rhs"),
    infer_shape=lambda params, in_shapes: (
        in_shapes,
        [None if in_shapes[0] is None else (in_shapes[0][0],)],
        []),
    func_name="choose_element_0index",
    doc="pick lhs[i, rhs[i]] per row (used for eval metrics)",
))


def _fill_element_0index(ctx, params, lhs, mhs, rhs):
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return lhs.index_put((rows, rhs.long()), mhs.to(lhs.dtype))


register_op(OpDef(
    name="fill_element_0index",
    forward=_fill_element_0index,
    arguments=("lhs", "mhs", "rhs"),
    infer_shape=lambda params, in_shapes: (in_shapes, [in_shapes[0]], []),
    func_name="fill_element_0index",
))
