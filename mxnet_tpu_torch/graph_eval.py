"""Symbol-graph evaluation on torch tensors.

Counterpart of ``mxnet_tpu/graph_eval.py``: :func:`eval_symbol` walks the
graph once in topological order and runs each node's op.  In the JAX
package the walk happens under tracing and XLA owns the buffers; here it
runs eagerly, and autograd records the graph when the inputs require
gradients, so ``torch.autograd.backward`` over the heads is the vjp the
JAX trainer takes.
"""
from __future__ import annotations

from typing import Dict

from .base import not_ported
from .ops.registry import OpContext

__all__ = ["eval_symbol"]


def eval_symbol(symbol, arg_vals: Dict[str, "torch.Tensor"],
                aux_vals: Dict[str, "torch.Tensor"], rng, is_train: bool,
                want_internals: bool = False, topo=None):
    """Evaluate a Symbol graph.

    ``arg_vals`` holds a tensor for every variable node (params, data,
    labels); ``aux_vals`` the auxiliary states keyed
    ``{node_name}_{aux_name}``; ``rng`` is a
    :class:`~mxnet_tpu_torch.random.GraphKey` or None: each node whose op
    samples (``OpDef.needs_rng``) draws from the key's generator for the
    node's topological index, as the JAX package folds that index into
    its key (without a key the op gets None: Dropout is then identity);
    ``is_train`` selects Dropout, batch statistics and aux updates in
    BatchNorm.  ``want_internals`` also
    returns every node output keyed ``{node_name}_{output_name}`` and
    every variable by name (the executor's monitor hook).  ``topo`` may
    pass a precomputed ``symbol._topo()``.

    Returns ``(heads, aux_updates)``, or ``(heads, aux_updates,
    internals)``: a tuple of head tensors and ``{aux_full_name: new
    value}``.
    """
    if topo is None:
        topo = symbol._topo()
    vals = {}
    aux_updates = {}
    internals = {}
    for index, node in enumerate(topo):
        if node.is_variable:
            vals[(id(node), 0)] = arg_vals[node.name]
            if want_internals:
                internals[node.name] = arg_vals[node.name]
            continue
        anno = node.anno_attrs()
        if anno.get("remat_scope") or anno.get("force_mirroring") in (
                "True", "true", "1"):
            raise not_ported("recompute scopes (remat_scope / "
                             "force_mirroring) in eval_symbol")
        op = node.op
        params = node.parsed_params()
        aux_full = node.aux_full_names()
        short = op.list_aux_states(params)
        node_rng = (rng.generator(index)
                    if rng is not None and op.needs_rng else None)
        opctx = OpContext(is_train=is_train, rng=node_rng,
                          aux={sh: aux_vals[f]
                               for sh, f in zip(short, aux_full)},
                          name=node.name)
        out = op.forward(opctx, params,
                         *[vals[(id(s), k)] for (s, k) in node.inputs])
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        for i, o in enumerate(outs):
            vals[(id(node), i)] = o
        if want_internals:
            for oname, o in zip(op.list_outputs(params), outs):
                internals[f"{node.name}_{oname}"] = o
        for sh, f in zip(short, aux_full):
            if sh in opctx.aux_updates:
                aux_updates[f] = opctx.aux_updates[sh]
    heads = tuple(vals[(id(n), i)] for (n, i) in symbol._heads)
    if want_internals:
        return heads, aux_updates, internals
    return heads, aux_updates
