"""How a tensor-parallel trainer computes each rule-sharded parameter.

The JAX trainer places parameters by :class:`~.trainer.ShardingRules` and
lets GSPMD partition one program over the mesh.  Here each member of a
``{"data": D, "model": T}`` mesh holds only its piece of every
rule-sharded parameter and evaluates the symbol on its rows in its own
thread; a *plan* says how the pieces meet:

* **gather** (any rules, any graph): the member all-gathers each sharded
  parameter over the model axis where the graph reads it
  (:func:`gather_params`), its own piece differentiable and the others'
  not.  Every member of a model group sees the same rows and computes the
  same function, so each gets its own piece's full gradient.
* **split** (Megatron's partition, :func:`split_pass`): a graph pass
  builds each member's local graph.  Column-parallel products (the output
  dimension cut) read their input through a ``span`` (identity forward,
  the model group's gradients summed in the backward) and produce a
  ``1/T``-wide slice; reshapes of such slices have the cut dimension's
  size divided by ``T`` (the LM's head split ``(-1, l, heads, hd)``
  becomes ``(-1, l, heads/T, hd)``, so attention runs on the member's
  heads); row-parallel products (the input dimension cut) take a sum over
  the model group whose gradient goes to each member's own partial, the
  bias added once; a vocabulary-parallel embedding looks up the ids in the
  member's range and sums over the group; any other op that reads a slice
  gathers it first (``lm_head``'s logits before ``SoftmaxOutput``).  A
  graph the pass cannot express (a head count, feed-forward width or
  vocabulary that ``T`` does not divide, a bias replicated beside a cut
  weight, a cut parameter read by another op) takes the gather plan, and
  the pass's reason is recorded.

At ``T = 1`` every meeting is the identity and the split graph runs the
ops of the unsharded one.  Beside a seq, expert or pipe axis the plan
runs in each of their coordinates: the meetings along ``model`` join
the members that share every other coordinate.  A parameter cut over
another axis as well (or instead) is put together by
:func:`gather_params` before the graph reads it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["TPPlan", "Rewrite", "split_pass", "gather_params",
           "sharded_dim"]

# ops whose output is an elementwise function of one input: a cut input
# gives an output cut alike
_ELEMENTWISE = ("Activation", "LeakyReLU")


def sharded_dim(spec, axis: str) -> Optional[int]:
    """The dimension a spec cuts over ``axis`` (None: replicated)."""
    for d, ax in enumerate(spec):
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return d
    return None


class Rewrite:
    """One node of a member's local graph: ``kind`` (``col_fc``,
    ``row_fc``, ``vocab_embed``, ``reshape`` or ``local``), its parsed
    parameters at the local width (None: the node's own) and the inputs
    ``gather`` lists as ``(input index, dimension)`` to gather first."""

    __slots__ = ("kind", "params", "gather")

    def __init__(self, kind: str, params: Optional[Dict[str, Any]] = None,
                 gather: Tuple[Tuple[int, int], ...] = ()):
        self.kind, self.params, self.gather = kind, params, gather


class TPPlan:
    """A trainer's tensor-parallel plan: ``plan`` (``"split"`` or
    ``"gather"``), the sharded parameters' specs and cut dimensions, the
    split plan's node rewrites, and why the split plan was not taken."""

    def __init__(self, plan: str, axis: str, tp: int,
                 dims: Dict[str, int],
                 rewrites: Optional[Dict[int, Rewrite]] = None,
                 reason: Optional[str] = None):
        self.plan, self.axis, self.tp = plan, axis, tp
        self.dims = dims
        self.rewrites = rewrites or {}
        self.reason = reason

    def info(self) -> Dict[str, Any]:
        return {"kind": "tensor_parallel", "plan": self.plan,
                "axis": self.axis, "tp": self.tp,
                "params": {n: self.plan for n in self.dims},
                "reason": self.reason}

    # -- the split plan's local graph ----------------------------------

    def run(self, rw: Rewrite, op, ctx, params, in_vals):
        """Evaluate one rewritten node on this member (``ctx.sync`` is its
        meeting handle, None for a lone member)."""
        sync, axis = ctx.sync, self.axis
        ins = list(in_vals)
        for j, dim in rw.gather:
            ins[j] = _gather(sync, ins[j], dim, axis)
        if rw.kind == "col_fc":
            ins[0] = ins[0] if sync is None else sync.span(ins[0], axis)
            return op.forward(ctx, params, *ins)
        if rw.kind == "row_fc":
            out = op.forward(ctx, params, ins[0], ins[1])
            if sync is not None:
                out = sync.psum_local(out, axis)
            if len(ins) > 2:
                out = out + ins[2].to(out.dtype)
            return out
        if rw.kind == "vocab_embed" and sync is not None \
                and sync.size(axis) > 1:
            return _vocab_embed(sync, axis, ins[0], ins[1], params)
        return op.forward(ctx, params, *ins)


def _gather(sync, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    if sync is None:
        return t
    return sync.gather(t, dim % t.dim(), axis)


def gather_params(args: Dict[str, torch.Tensor],
                  gathers: Dict[str, Any], handle) -> None:
    """The values a member's graph reads of rule-sharded parameters:
    every parameter of ``gathers`` (``{name: [(dim, axis, to_owner),
    ...]}``) replaced in ``args``, in place, by its group's pieces end to
    end along ``dim``, one step after the other; with ``to_owner`` each
    piece is differentiable into its owner (``all_gather``), else only
    this member's piece (``gather``: the gather plan over the model
    axis).  ``handle`` is the member's meeting handle (None for a lone
    member: nothing to gather)."""
    if handle is None:
        return
    for n, steps in gathers.items():
        sync, t = handle.at(n), args[n]
        for dim, axis, to_owner in steps:
            t = (sync.all_gather(t, dim, axis) if to_owner
                 else sync.gather(t, dim, axis))
        args[n] = t


def _vocab_embed(sync, axis, data, weight, params):
    """The JAX package's lookup (``take`` semantics, as the Embedding
    op) over a vocabulary cut into ``T`` ranges: each member looks up
    the ids of its range, zeros elsewhere, and the group's partial rows
    are summed; an id outside the whole vocabulary gives NaN."""
    from ..ops.nn_ops import embedding_index
    n_local = weight.shape[0]
    n = n_local * sync.size(axis)
    ids, valid = embedding_index(data, n)
    lo = sync.rank(axis) * n_local
    local = ids - lo
    mine = valid & (local >= 0) & (local < n_local)
    rows = weight[torch.where(mine, local, torch.zeros_like(local))]
    part = torch.where(mine.unsqueeze(-1), rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    out = sync.psum_local(part, axis)
    return torch.where(valid.unsqueeze(-1), out,
                       torch.full((), float("nan"), dtype=out.dtype,
                                  device=out.device))


# ---------------------------------------------------------------------------
# The split pass
# ---------------------------------------------------------------------------

class _NoSplit(Exception):
    pass


def split_pass(sym, topo, dims: Dict[str, int], specs: Dict[str, Any],
               axis: str, tp: int, input_shapes: Dict[str, Tuple[int, ...]]
               ) -> Tuple[Optional[Dict[int, Rewrite]], Optional[str]]:
    """The split plan's rewrites of ``topo`` (``{id(node): Rewrite}``),
    or ``(None, reason)`` when the graph has no Megatron partition under
    these specs over ``tp`` members (see the module docstring)."""
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape_partial(**input_shapes)
    full = {(id(n), i): s for (n, i), s in zip(internals._heads, outs)}
    state: Dict[Tuple[int, int], Optional[int]] = {}
    rewrites: Dict[int, Rewrite] = {}

    def fail(msg):
        raise _NoSplit(msg)

    def cut(name) -> Optional[Tuple]:
        return tuple(specs[name]) if name in dims else None

    try:
        for node in topo:
            if node.is_variable:
                state[(id(node), 0)] = None
                continue
            name, p = node.op.name, node.parsed_params()
            srcs = [s for s, _ in node.inputs]
            ins = [state[(id(s), k)] for s, k in node.inputs]
            cut_params = [s.name for s in srcs
                          if s.is_variable and s.name in dims]
            nout = len(node.op.list_outputs(p))
            out_state: Optional[int] = None
            what = f"{name} ({node.name})"
            if name == "FullyConnected" and cut(srcs[1].name) is not None:
                w = cut(srcs[1].name)
                has_bias = len(srcs) > 2
                b = cut(srcs[2].name) if has_bias else None
                if w == (axis, None) and ins[0] is None:
                    if has_bias and b != (axis,):
                        fail(f"{what}: the weight is cut over its outputs "
                             "and the bias is not")
                    if p["num_hidden"] % tp:
                        fail(f"{what}: {p['num_hidden']} outputs do not "
                             f"split over {tp}")
                    rewrites[id(node)] = Rewrite(
                        "col_fc", dict(p, num_hidden=p["num_hidden"] // tp))
                    out_state = -1
                elif w == (None, axis) and ins[0] is not None:
                    shape = full.get((id(srcs[0]), node.inputs[0][1]))
                    if shape is None or ins[0] != -(len(shape) - 1):
                        fail(f"{what}: the input's cut is not its features")
                    if has_bias and b is not None:
                        fail(f"{what}: a row-parallel bias must be "
                             "replicated")
                    rewrites[id(node)] = Rewrite("row_fc")
                else:
                    fail(f"{what}: weight spec {w} on an input cut "
                         f"{ins[0]} has no split form")
            elif name == "Embedding" and cut(srcs[1].name) is not None:
                if cut(srcs[1].name) != (axis, None) or ins[0] is not None:
                    fail(f"{what}: only the vocabulary may be cut")
                if p["input_dim"] % tp:
                    fail(f"{what}: vocabulary {p['input_dim']} does not "
                         f"split over {tp}")
                rewrites[id(node)] = Rewrite(
                    "vocab_embed", dict(p, input_dim=p["input_dim"] // tp))
            elif cut_params:
                fail(f"{what} reads the cut parameter {cut_params[0]}")
            elif all(s is None for s in ins):
                pass
            elif name == "Reshape":
                out_state = _reshape(node, p, full, ins[0], tp, rewrites,
                                     fail)
            elif name == "RingAttention":
                head = -2 if p["layout"] == "blhd" else -3
                if ins != [head] * 3:
                    fail(f"{what}: q, k and v are not all cut over heads")
                out_state = head
            elif name in _ELEMENTWISE and len(ins) == 1:
                out_state = ins[0]
            else:
                # an op with no split form reads the whole value
                rewrites[id(node)] = Rewrite("local", None, tuple(
                    (j, st) for j, st in enumerate(ins) if st is not None))
            for k in range(nout):
                state[(id(node), k)] = out_state
        heads_cut = [state[(id(n), i)] for n, i in sym._heads]
        if any(h is not None for h in heads_cut):
            fail("a head of the graph is a cut value")
    except _NoSplit as exc:
        return None, str(exc)
    return rewrites, None


def _reshape(node, p, full, cut_dim, tp, rewrites, fail):
    """A Reshape of a value cut at ``cut_dim`` (negative): the cut
    dimension of the target is the first of the target's trailing
    dimensions that hold the input's cut features, divided by ``tp``."""
    what = f"Reshape ({node.name})"
    src, k_in = node.inputs[0]
    in_full = full.get((id(src), k_in))
    out_full = full.get((id(node), 0))
    if in_full is None or out_full is None:
        fail(f"{what}: shapes unknown")
    feats = int(np.prod(in_full[cut_dim:]))
    tgt = p["shape"]
    if p["target_shape"] or not tgt or len(tgt) != len(out_full) \
            or any(v in (0, -2, -3, -4) for v in tgt):
        fail(f"{what}: the target shape {tuple(tgt)} is not one this pass "
             "rewrites")
    prod, k = 1, len(out_full)
    while k > 0 and prod < feats:
        k -= 1
        prod *= out_full[k]
    if prod != feats or tgt[k] == -1 or out_full[k] % tp:
        fail(f"{what}: {tuple(out_full)} has no dimension of the cut "
             f"features that splits over {tp}")
    new = list(tgt)
    new[k] = out_full[k] // tp
    rewrites[id(node)] = Rewrite("reshape", dict(p, shape=tuple(new)))
    return k - len(out_full)
