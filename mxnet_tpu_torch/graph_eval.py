"""Symbol-graph evaluation on torch tensors.

Counterpart of ``mxnet_tpu/graph_eval.py``: :func:`eval_symbol` walks the
graph once in topological order and runs each node's op.  In the JAX
package the walk happens under tracing and XLA owns the buffers; here it
runs eagerly, and autograd records the graph when the inputs require
gradients, so ``torch.autograd.backward`` over the heads is the vjp the
JAX trainer takes.

Recompute scopes, as in the JAX package: a maximal run of nodes that
share one ``remat_scope`` annotation becomes one
``torch.utils.checkpoint.checkpoint`` (non-reentrant) over the run, so
the backward keeps only the values that enter the scope and recomputes
the rest; only the values that escape the scope (a consumer outside it,
or a head) leave it.  A node annotated ``force_mirroring`` without aux
states is checkpointed alone.  The monitor mode (``want_internals``)
needs every internal value, so it evaluates without scopes.

A scope's sampling ops ask the :class:`~mxnet_tpu_torch.random.GraphKey`
for their generator inside the recomputed function: the key reseeds it
from ``(key, node index)`` on every call, so the recompute draws the same
Dropout mask as the forward (``torch.utils.checkpoint`` restores only
torch's default generators).  Aux updates (BatchNorm's moving
statistics) come from the forward only; the recompute's are dropped, so
a scope updates them once.

Over a mesh, ``sync`` is a member's meeting handle: each op call sees
``sync.at(node name)`` as ``OpContext.sync``, so a recompute replays the
values its forward met with.  ``local`` is a tensor-parallel split
plan's member graph (:class:`~mxnet_tpu_torch.parallel.tensor_parallel.
TPPlan`): its rewritten nodes run at the member's width.  ``placement``
(the executor's ``group2ctx``) names each node's and variable's context;
every value that crosses between two contexts goes through
:func:`~mxnet_tpu_torch.ops.nn_ops.cross_device_copy`, once for each
context that reads it, and the graph
runs without recompute scopes, as in the JAX package.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List

from .ops.registry import OpContext

__all__ = ["eval_symbol", "graph_fingerprint"]


def graph_fingerprint(symbol, topo=None) -> str:
    """Structural identity of a symbol graph, for program keys
    (:func:`mxnet_tpu_torch.compile_cache.program_key`); the JAX
    package's algorithm, so a graph whose nodes parse to the same
    parameters and attrs has the same digest in both packages.

    Hashes, in topological order, each node's op name, its parsed
    parameters, its annotation attrs (``remat_scope`` changes the
    program) and its input wiring as topological indices, then the head
    entries.  Node names are left out: renamed but identical graphs
    share a fingerprint."""
    if topo is None:
        topo = symbol._topo()
    gidx = {id(n): i for i, n in enumerate(topo)}
    h = hashlib.sha256()
    for n in topo:
        if n.is_variable:
            h.update(b"var\x00")
            continue
        h.update(n.op.name.encode())
        h.update(repr(sorted(n.parsed_params().items())).encode())
        h.update(repr(sorted(n.anno_attrs().items())).encode())
        h.update(repr([(gidx[id(s)], k) for (s, k) in n.inputs]).encode())
        h.update(b"\x00")
    h.update(repr([(gidx[id(n)], i) for (n, i) in symbol._heads]).encode())
    return h.hexdigest()


def _mirrored(anno) -> bool:
    return anno.get("force_mirroring") in ("True", "true", "1")


def eval_symbol(symbol, arg_vals: Dict[str, "torch.Tensor"],
                aux_vals: Dict[str, "torch.Tensor"], rng, is_train: bool,
                want_internals: bool = False, topo=None, sync=None,
                local=None, placement=None):
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
    pass a precomputed ``symbol._topo()``.  ``sync`` (a mesh member's
    handle, or None) reaches every op as ``OpContext.sync``: BatchNorm's
    batch statistics and SoftmaxOutput's normalization then count the
    batch of every member.  ``local`` (a tensor-parallel plan) rewrites
    nodes to the member's width; ``placement`` maps node and variable
    names to contexts (model-parallel placement).

    Returns ``(heads, aux_updates)``, or ``(heads, aux_updates,
    internals)``: a tuple of head tensors and ``{aux_full_name: new
    value}``.
    """
    if topo is None:
        topo = symbol._topo()
    vals = {}
    aux_updates = {}
    internals = {}
    index_of = {id(n): i for i, n in enumerate(topo)}
    head_set = {(id(n), i) for (n, i) in symbol._heads}

    rewrites = local.rewrites if local is not None else {}

    def eval_node(node, in_vals):
        """One op node: ``(outputs, {aux_full_name: update})``."""
        op = node.op
        rw = rewrites.get(id(node))
        params = (node.parsed_params() if rw is None or rw.params is None
                  else rw.params)
        aux_full = node.aux_full_names()
        short = op.list_aux_states(params)
        opctx = OpContext(
            is_train=is_train,
            rng=(rng.generator(index_of[id(node)])
                 if rng is not None and op.needs_rng else None),
            aux={sh: aux_vals[f] for sh, f in zip(short, aux_full)},
            name=node.name,
            sync=None if sync is None else sync.at(node.name))
        out = (op.forward(opctx, params, *in_vals) if rw is None
               else local.run(rw, op, opctx, params, in_vals))
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        return outs, {f: opctx.aux_updates[sh]
                      for sh, f in zip(short, aux_full)
                      if sh in opctx.aux_updates}

    def record(node, outs):
        for i, o in enumerate(outs):
            vals[(id(node), i)] = o
        if want_internals:
            for oname, o in zip(node.op.list_outputs(node.parsed_params()),
                                outs):
                internals[f"{node.name}_{oname}"] = o

    where: Dict[tuple, Any] = {}
    moved: Dict[tuple, Any] = {}
    if placement is not None:
        from .ops.nn_ops import cross_device_copy

    use_remat = not want_internals and placement is None and any(
        not n.is_variable and (n.anno_attrs().get("remat_scope")
                               or _mirrored(n.anno_attrs()))
        for n in topo)
    consumers: Dict[tuple, List[int]] = {}
    if use_remat:
        for n in topo:
            if n.is_variable:
                continue
            for (src, k) in n.inputs:
                if not src.is_variable:
                    consumers.setdefault((id(src), k), []).append(id(n))

    i = 0
    while i < len(topo):
        node = topo[i]
        if node.is_variable:
            vals[(id(node), 0)] = arg_vals[node.name]
            if placement is not None:
                where[(id(node), 0)] = placement[node.name]
            if want_internals:
                internals[node.name] = arg_vals[node.name]
            i += 1
            continue
        anno = node.anno_attrs() if use_remat else {}
        scope = anno.get("remat_scope")
        if scope is None:
            in_vals = [vals[(id(s), k)] for (s, k) in node.inputs]
            if placement is not None:
                dst = placement[node.name]
                for j, (s, k) in enumerate(node.inputs):
                    if where[(id(s), k)] != dst:
                        # a value crosses to each context once
                        if (id(s), k, dst) not in moved:
                            moved[(id(s), k, dst)] = cross_device_copy(
                                in_vals[j], dst)
                        in_vals[j] = moved[(id(s), k, dst)]
                for k in range(len(node.op.list_outputs(
                        node.parsed_params()))):
                    where[(id(node), k)] = dst
            if _mirrored(anno) and not node.aux_full_names():
                # recompute-in-backward of one node (the reference's
                # gradient mirroring)
                from torch.utils.checkpoint import (
                    checkpoint, set_checkpoint_early_stop)
                with set_checkpoint_early_stop(False):
                    outs = list(checkpoint(
                        lambda *xs, _n=node: tuple(eval_node(_n, xs)[0]),
                        *in_vals, use_reentrant=False))
                node_aux = {}
            else:
                outs, node_aux = eval_node(node, in_vals)
            record(node, outs)
            aux_updates.update(node_aux)
            i += 1
            continue

        # ---- a remat scope: one checkpoint over the whole run ----------
        run: List[Any] = []
        j = i
        while j < len(topo):
            nj = topo[j]
            if nj.is_variable:
                vals[(id(nj), 0)] = arg_vals[nj.name]
                j += 1
                continue
            if nj.anno_attrs().get("remat_scope") != scope:
                break
            run.append(nj)
            j += 1
        run_ids = {id(n) for n in run}
        ext_keys: List[tuple] = []
        for n_ in run:
            for (src, k) in n_.inputs:
                if src.is_variable or id(src) in run_ids:
                    continue
                if (id(src), k) not in ext_keys:
                    ext_keys.append((id(src), k))
        out_keys: List[tuple] = []
        for n_ in run:
            for k in range(len(n_.op.list_outputs(n_.parsed_params()))):
                key = (id(n_), k)
                if key in head_set or any(
                        c not in run_ids for c in consumers.get(key, [])):
                    out_keys.append(key)
        scope_aux: Dict[str, Any] = {}

        def scope_fn(*ext_vals, _run=run, _ext=ext_keys, _out=out_keys,
                     _aux=scope_aux):
            local = dict(zip(_ext, ext_vals))
            # the first call (the forward) keeps its aux updates; the
            # recompute's find them already there and are dropped
            keep = not _aux
            for n_ in _run:
                ins = [arg_vals[src.name] if src.is_variable
                       else local[(id(src), k)] for (src, k) in n_.inputs]
                outs, n_aux = eval_node(n_, ins)
                for k, o in enumerate(outs):
                    local[(id(n_), k)] = o
                if keep:
                    _aux.update({f: v.detach() for f, v in n_aux.items()})
            return tuple(local[k] for k in _out)

        from torch.utils.checkpoint import (checkpoint,
                                            set_checkpoint_early_stop)
        # the recompute runs the whole scope, as jax.checkpoint does (an
        # early stop would skip what follows the last saved tensor)
        with set_checkpoint_early_stop(False):
            outs = checkpoint(scope_fn, *[vals[k] for k in ext_keys],
                              use_reentrant=False)
        for key, o in zip(out_keys, outs):
            vals[key] = o
        aux_updates.update(scope_aux)
        i = j

    heads = tuple(vals[(id(n), i)] for (n, i) in symbol._heads)
    if want_internals:
        return heads, aux_updates, internals
    return heads, aux_updates
