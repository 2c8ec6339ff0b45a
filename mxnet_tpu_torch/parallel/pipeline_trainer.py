"""Pipeline parallelism over Symbol stages (1F1B microbatch schedule).

Counterpart of ``mxnet_tpu/parallel/pipeline_trainer.py``:

* a Symbol is **partitioned into stages**, by its ``ctx_group`` attrs
  (``group2stage``) or by the automatic contiguous cost balance
  (:func:`_assign_stages`: the midpoint rule over parameter elements);
* each stage runs on its own context, eagerly, and stages may have
  different shapes; the contexts may repeat (four stages on one card run
  one after another on it, as the JAX package's stages on one device);
* the global batch is cut into microbatches and the step dispatches them
  in **1F1B order**: each stage runs a microbatch's backward as soon as
  the cotangent from the stage after it exists, and holds at most
  ``num_stages - s`` microbatch environments;
* the forward runs without autograd and keeps only each stage's inputs;
  the backward **rematerializes** the stage forward from them under
  autograd (the GPipe recipe) with the aux states the forward saw and
  the forward's sampling key (:class:`~mxnet_tpu_torch.random.GraphKey`
  reseeds each node's generator on every call, so a Dropout mask is
  drawn again the same), drops the recompute's aux updates, and takes
  ``torch.autograd.grad`` over the stage's parameters and the
  environment it received; gradients sum over microbatches and a
  per-stage ``optimizer._functional_step`` update runs on the stage's
  context (no fused update: K2 is not launched);
* **data parallelism composes**: with ``data_parallel=dp`` the contexts
  form a ``(dp, num_stages)`` grid and column ``s`` runs stage ``s`` over
  its members, each on its rows of the microbatch in a thread of its own
  (:func:`~.members.run_synced`), meeting at every cross-row statistic
  (BatchNorm's moments and normalized losses count the whole microbatch,
  as the JAX package's GSPMD programs do); the members read the
  parameters on the column's first context through a differentiable
  copy, so one backward sums their gradients there.

Cross-stage tensors travel in an "env" dict keyed ``"node#out_idx"``: a
skip connection that jumps stages rides the env through the stages in
between, and its cotangents accumulate through each stage's backward.
Between two contexts a tensor moves with ``.to(device)`` on the current
streams, which orders the copy after the producing kernels; on one
context the move is a no-op.

``remat_scope`` attributes (the LM's ``remat=True``) are not applied
inside a stage: the stage backward already recomputes the whole stage,
as in the JAX package, whose stage programs ignore them too.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import optimizer as opt_mod
from ..base import MXNetError, not_ported
from ..context import as_context, cpu, resolve_device
from ..initializer import Uniform
from ..ndarray import NDArray, array as nd_array, zeros as nd_zeros
from ..ops.registry import OpContext
from ..random import GraphKey, mix
from .members import run_synced
from .mesh import DATA_AXIS, Mesh, local_contexts
from .trainer import _batch_layout, _copy_tree, _torch_dtype

__all__ = ["PipelineTrainer"]


def _node_cost(node, shape_of, input_names):
    """Stage-balance weight: parameter elements feeding this op + 1
    (batch inputs are data, not model capacity -- excluded)."""
    cost = 1.0
    for src, _ in node.inputs:
        if (src.is_variable and src.name in shape_of
                and src.name not in input_names):
            cost += float(np.prod(shape_of[src.name]))
    return cost


def _assign_stages(topo, num_stages, group2stage, shape_of, input_names):
    """Stage index per op node (keyed by ``id(node)``); variables follow
    their consumers.  With ``group2stage`` a node takes the stage of its
    ``ctx_group`` (a node without one keeps the last stage seen); without
    it the midpoint rule balances the parameter elements."""
    op_nodes = [n for n in topo if not n.is_variable]
    stage: Dict[int, int] = {}
    if group2stage:
        last = 0
        for n in op_nodes:
            g = n.anno_attrs().get("ctx_group")
            if g is not None:
                if g not in group2stage:
                    raise MXNetError(f"node {n.name}: ctx_group {g!r} not in "
                                     f"group2stage {sorted(group2stage)}")
                last = int(group2stage[g])
            stage[id(n)] = last
    else:
        costs = [_node_cost(n, shape_of, input_names) for n in op_nodes]
        target = sum(costs) / num_stages
        s, acc = 0, 0.0
        for idx, (n, c) in enumerate(zip(op_nodes, costs)):
            # close the stage once half this node overshoots its share,
            # while enough nodes remain to populate every later stage
            can_close = (s < num_stages - 1
                         and len(op_nodes) - idx > num_stages - 1 - s)
            if acc > 0 and acc + c / 2 >= target and can_close:
                s, acc = s + 1, 0.0
            stage[id(n)] = s
            acc += c
    # monotonicity: a node must not run before a later-stage producer
    for n in op_nodes:
        for src, _ in n.inputs:
            if not src.is_variable and stage[id(src)] > stage[id(n)]:
                raise MXNetError(
                    f"stage assignment not topological: {n.name} (stage "
                    f"{stage[id(n)]}) consumes {src.name} (stage "
                    f"{stage[id(src)]})")
    return stage


def _key_of(node, i) -> str:
    return f"{node.name}#{i}"


class PipelineTrainer:
    """Train a Symbol split into pipeline stages across contexts.

    Parameters
    ----------
    symbol : Symbol
        Heads must be loss outputs (as for ShardedTrainer).
    num_stages : int
        Number of pipeline stages.
    devices : sequence of contexts (``Context``, ``torch.device`` or
        strings), optional
        ``num_stages * data_parallel`` of them, row-major over the
        ``(data_parallel, num_stages)`` grid; contexts may repeat across
        stages (not within a stage's column).  Default: the first CUDA
        devices; CPU contexts run the pipeline on the host.
    group2stage : dict, optional
        ``ctx_group`` attr value -> stage index.  Without it, stages are
        balanced automatically.
    num_microbatches : int
        Microbatch count; the global batch must divide by it times
        ``data_parallel``.
    compute_dtype : str, optional
        Activation type: float32 parameters are cast to it at each
        stage's edge; masters and the update stay float32.
    seed : int
        Seeds the initializer's generator and keys the graph's sampling
        ops (``(seed, update count, microbatch)``).
    """

    def __init__(self, symbol, num_stages: int, devices=None,
                 group2stage: Optional[Dict[str, int]] = None,
                 optimizer="sgd", optimizer_params=None,
                 num_microbatches: int = 4, initializer=None,
                 compute_dtype: Optional[str] = None,
                 data_parallel: int = 1, logger=None, seed: int = 0):
        self.symbol = symbol
        self.num_stages = int(num_stages)
        self.dp = int(data_parallel)
        if self.dp < 1:
            raise MXNetError("data_parallel must be >= 1")
        need = self.num_stages * self.dp
        devs = list(local_contexts()[:need] if devices is None else devices)
        self.devices = [as_context(d) for d in devs]
        if len(self.devices) < need:
            raise MXNetError(f"need {need} devices "
                             f"({self.num_stages} stages x {self.dp} dp), "
                             f"have {len(self.devices)}")
        # context grid (dp, S): column s hosts stage s as a one-axis
        # "data" mesh (distinct contexts within a column)
        grid = np.empty(need, dtype=object)
        grid[:] = self.devices[:need]
        grid = grid.reshape(self.dp, self.num_stages)
        self._grid = grid
        self._stage_meshes = [Mesh(grid[:, s], (DATA_AXIS,))
                              for s in range(self.num_stages)]
        # resolve_device raises for a CUDA context without CUDA: a stage
        # never falls back to the CPU
        self._col_devices = [[resolve_device(c) for c in grid[:, s]]
                             for s in range(self.num_stages)]
        self._stage_dev = [col[0] for col in self._col_devices]
        self.group2stage = group2stage
        self.num_microbatches = int(num_microbatches)
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        if type(optimizer)._needs_rng:
            raise MXNetError("PipelineTrainer does not support stochastic "
                             "optimizers (SGLD) yet")
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.07)
        self.compute_dtype = _torch_dtype(compute_dtype)
        self.logger = logger or logging.getLogger(__name__)
        self._seed = int(seed)
        self._generator = torch.Generator().manual_seed(self._seed)
        self._key_caches: Dict[Tuple[int, int], Dict] = {}
        self._bound = False

    # ------------------------------------------------------------------
    # Bind
    # ------------------------------------------------------------------

    def _transfer(self, tree: Dict[str, Any], s) -> Dict[str, Any]:
        """Boundary tensors or cotangents onto stage ``s``'s first
        context (a no-op where they already are)."""
        dev = self._stage_dev[s]
        return {k: v.to(dev) for k, v in tree.items()}

    def bind(self, data_shapes, label_shapes=None, arg_params=None,
             aux_params=None) -> "PipelineTrainer":
        sym = self.symbol
        input_shapes = dict(data_shapes)
        input_shapes.update(label_shapes or {})
        for name, shape in input_shapes.items():
            if shape[0] % (self.num_microbatches * self.dp):
                raise MXNetError(
                    f"global batch {shape[0]} for {name!r} not divisible by "
                    f"num_microbatches {self.num_microbatches} x "
                    f"data_parallel {self.dp}")
        arg_names = sym.list_arguments()
        self._input_names = [n for n in arg_names if n in input_shapes]
        self._param_names = [n for n in arg_names if n not in input_shapes]
        arg_shapes, _, aux_shapes = sym.infer_shape(**input_shapes)
        if any(s is None for s in arg_shapes):
            raise MXNetError("bind: incomplete shape inference")
        shape_of = dict(zip(arg_names, arg_shapes))
        self._input_shapes = {n: shape_of[n] for n in self._input_names}

        topo = sym._topo()
        self._topo = topo
        self._gidx = {id(n): i for i, n in enumerate(topo)}
        stage = _assign_stages(topo, self.num_stages, self.group2stage,
                               shape_of, set(self._input_names))
        self._stage_of = stage
        used = sorted(set(stage.values()))
        if len(used) < self.num_stages:
            self.logger.warning("only %d of %d stages are populated",
                                len(used), self.num_stages)

        # per-stage node lists, variable ownership, env (boundary) keys
        self._stage_nodes = [
            [n for n in topo if not n.is_variable and stage[id(n)] == s]
            for s in range(self.num_stages)]
        var_stages: Dict[str, set] = {}
        for n in topo:
            if n.is_variable:
                var_stages[n.name] = {
                    stage[id(m)] for m in topo if not m.is_variable
                    and any(src is n for src, _ in m.inputs)} or {0}
        for nm in self._param_names:
            if len(var_stages[nm]) > 1:
                raise MXNetError(
                    f"parameter {nm!r} is consumed by multiple pipeline "
                    f"stages {sorted(var_stages[nm])}; tie weights within "
                    f"one stage or pin the consumers to one ctx_group")
        self._stage_params = [
            [nm for nm in self._param_names if var_stages[nm] == {s}]
            for s in range(self.num_stages)]
        # batch inputs are injected at every consuming stage (no
        # gradient flows to them)
        self._stage_inputs = [
            [nm for nm in self._input_names if s in var_stages[nm]]
            for s in range(self.num_stages)]
        # aux states follow their node's stage
        self._stage_aux: List[List[str]] = [[] for _ in range(self.num_stages)]
        aux_names = sym.list_auxiliary_states()
        aux_shape_of = dict(zip(aux_names, aux_shapes))
        for n in topo:
            if n.is_variable:
                continue
            for full in n.aux_full_names():
                self._stage_aux[stage[id(n)]].append(full)

        # env keys crossing each s -> s+1 edge: tensors produced at
        # stage <= s and consumed (by an op or as a head) at stage > s
        produced_at: Dict[str, int] = {}
        consumed_at: Dict[str, int] = {}
        for n in topo:
            if n.is_variable:
                continue
            s = stage[id(n)]
            for i in range(len(n.op.list_outputs(n.parsed_params()))):
                produced_at[_key_of(n, i)] = s
            for src, i in n.inputs:
                if not src.is_variable:
                    k = _key_of(src, i)
                    consumed_at[k] = max(consumed_at.get(k, 0), s)
        self._head_keys = [(_key_of(hn, hi), stage[id(hn)])
                           for (hn, hi) in sym._heads]
        self._env_after = []  # env_after[s]: keys alive crossing s -> s+1
        for s in range(self.num_stages - 1):
            self._env_after.append(sorted(
                k for k, ps in produced_at.items()
                if ps <= s and consumed_at.get(k, -1) > s))
        self._node_of = {n.name: n for n in topo if not n.is_variable}
        self._setup_columns(input_shapes)

        # ---- init (in the symbol's order, as ShardedTrainer draws) and
        # place params/aux on each stage's first context ----------------
        def host_value(name, shape, given):
            nd = nd_zeros(shape, ctx=cpu())
            if given is not None and name in given:
                src = given[name]
                nd[:] = src.data if isinstance(src, NDArray) else src
            else:
                self.initializer(name, nd, generator=self._generator)
            return nd.data

        host = {n: host_value(n, shape_of[n], arg_params)
                for n in self._param_names}
        host_aux = {n: host_value(n, aux_shape_of[n], aux_params)
                    for n in aux_names}
        self._shape_of = shape_of
        self._aux_shape_of = aux_shape_of
        opt = self.optimizer
        self._params: List[Dict[str, torch.Tensor]] = []
        self._aux: List[Dict[str, torch.Tensor]] = []
        self._opt_state: List[Dict[str, Any]] = []
        for s in range(self.num_stages):
            dev = self._stage_dev[s]
            ps = {nm: host[nm].detach().to(dev, copy=True).requires_grad_(True)
                  for nm in self._stage_params[s]}
            self._params.append(ps)
            self._aux.append({nm: host_aux[nm].to(dev, copy=True)
                              for nm in self._stage_aux[s]})
            self._opt_state.append({nm: opt.state_zeros_like(p.detach())
                                    for nm, p in ps.items()})

        if opt._rescale_set:
            self._rescale_grad = opt.rescale_grad
        else:
            # per-sample loss-head gradients sum into the weight grads:
            # rescale by 1/global batch, as ShardedTrainer does
            self._rescale_grad = 1.0 / float(
                next(iter(data_shapes.values()))[0])
        self._wd_mult = {n: (0.0 if n.endswith(("_gamma", "_beta", "_bias"))
                             else 1.0) for n in self._param_names}
        for n in self._param_names:
            if n in opt.wd_mult:
                self._wd_mult[n] = opt.wd_mult[n]
        self._lr_mult = {n: opt.lr_mult.get(n, 1.0) for n in self._param_names}
        self._num_update = opt.begin_num_update
        # the step's rate and count as 0-d float32 tensors, one a context
        self._scalars: Dict[torch.device, Tuple[torch.Tensor,
                                                torch.Tensor]] = {}
        self._compile()
        self._bound = True
        return self

    def _setup_columns(self, input_shapes) -> None:
        """Over ``data_parallel > 1``: which node outputs the members cut
        by rows, the nodes whose reductions meet (the implicit mode's
        layout), the global heads; refuses a graph that moves rows."""
        self._row_reductions: frozenset = frozenset()
        self._global_heads: frozenset = frozenset()
        self._col_groups = {DATA_AXIS: [tuple(range(self.dp))]}
        if self.dp == 1:
            return
        mb = {n: (s[0] // self.num_microbatches,) + tuple(s[1:])
              for n, s in input_shapes.items()}
        why, reds, glob, row_split = _batch_layout(self.symbol, self._topo,
                                                   mb)
        if why is not None:
            raise not_ported(
                f"PipelineTrainer over data_parallel {self.dp}: {why}, "
                "which the members' split microbatch would compute per "
                "member")
        self._row_reductions, self._global_heads = reds, glob
        # the env values a column's members cut by rows
        self._row_keys = {_key_of(n, i) for n in self._topo
                          if not n.is_variable
                          for i in range(len(n.op.list_outputs(
                              n.parsed_params())))
                          if row_split(n, i)}

    # ------------------------------------------------------------------
    # Per-stage programs
    # ------------------------------------------------------------------

    def _stage_apply(self, s, params_s, aux_s, env_in, inputs_s, key,
                     is_train, sync=None):
        """Evaluate stage s's nodes; returns ``(env_out, heads_s,
        aux_up)``.  ``key``: the microbatch's GraphKey (or None);
        ``sync``: a column member's meeting handle (or None)."""
        cdt = self.compute_dtype
        # the compute-dtype cast once a parameter, at the stage's edge
        params_c = {n: (v.to(cdt) if cdt is not None
                        and v.dtype == torch.float32 else v)
                    for n, v in params_s.items()}
        vals: Dict[tuple, Any] = {}
        aux_up: Dict[str, Any] = {}
        for node in self._stage_nodes[s]:
            op = node.op
            p = node.parsed_params()
            in_vals = []
            for src, i in node.inputs:
                if src.is_variable:
                    in_vals.append(params_c[src.name] if src.name in params_c
                                   else inputs_s[src.name])
                elif (id(src), i) in vals:
                    in_vals.append(vals[(id(src), i)])
                else:
                    in_vals.append(env_in[_key_of(src, i)])
            short = op.list_aux_states(p)
            fulls = node.aux_full_names()
            opctx = OpContext(
                is_train=is_train,
                rng=(key.generator(self._gidx[id(node)])
                     if key is not None and op.needs_rng else None),
                aux={sh: aux_s[f] for sh, f in zip(short, fulls)},
                name=node.name,
                sync=None if sync is None else sync.at(node.name))
            out = op.forward(opctx, p, *in_vals)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
            for sh, f in zip(short, fulls):
                if sh in opctx.aux_updates:
                    aux_up[f] = opctx.aux_updates[sh]
        # heads produced at this stage, in the symbol's head order
        heads_s = []
        for (k, hs) in self._head_keys:
            if hs == s:
                name, i = k.rsplit("#", 1)
                heads_s.append(vals[(id(self._node_of[name]), int(i))])
        # env crossing to the next stage
        env_out = {}
        if s < self.num_stages - 1:
            for k in self._env_after[s]:
                if k in env_in:
                    env_out[k] = env_in[k]
                else:
                    name, i = k.rsplit("#", 1)
                    env_out[k] = vals[(id(self._node_of[name]), int(i))]
        return env_out, tuple(heads_s), aux_up

    def _run_stage(self, s, params_s, aux_s, env_in, inputs_s, keys,
                   is_train):
        """Stage ``s`` over its column: on its one context, or over the
        column's members in threads, each on its rows, meeting at the
        cross-row statistics; the members' results joined on the first
        context (differentiably)."""
        devs = self._col_devices[s]
        if len(devs) == 1:
            return self._stage_apply(s, params_s, aux_s, env_in, inputs_s,
                                     keys[0], is_train)
        n = len(devs)
        rows = self._row_keys

        def cut(v, r, dev):
            mb = v.shape[0] // n
            return v[r * mb:(r + 1) * mb].to(dev)

        def member(r, handle):
            dev = devs[r]
            p = {k: v.to(dev) for k, v in params_s.items()}
            a = {k: v.to(dev) for k, v in aux_s.items()}
            e = {k: (cut(v, r, dev) if k in rows else v.to(dev))
                 for k, v in env_in.items()}
            i = {k: cut(v, r, dev) for k, v in inputs_s.items()}
            return self._stage_apply(s, p, a, e, i, keys[r], is_train,
                                     sync=handle)

        outs = run_synced(member, devs, self._col_groups,
                          self._row_reductions)
        lead = devs[0]
        env_out = {k: (torch.cat([o[0][k].to(lead) for o in outs])
                       if k in rows else outs[0][0][k])
                   for k in outs[0][0]}
        stage_heads = [q for q, (_, hs) in enumerate(self._head_keys)
                       if hs == s]
        heads = tuple(outs[0][1][pos] if q in self._global_heads
                      else torch.cat([o[1][pos].to(lead) for o in outs])
                      for pos, q in enumerate(stage_heads))
        return env_out, heads, outs[0][2]

    def _compile(self):
        opt = self.optimizer
        hyper = opt._hyper()
        hyper["rescale_grad"] = self._rescale_grad
        step_fn = type(opt)._functional_step
        self._fwd = []
        self._bwd = []
        self._upd = []
        self._eval = []
        for s in range(self.num_stages):
            def fwd(params_s, aux_s, env_in, inputs_s, keys, _s=s):
                with torch.no_grad():
                    return self._run_stage(_s, params_s, aux_s, env_in,
                                           inputs_s, keys, True)

            def bwd(params_s, aux_s, env_in, inputs_s, keys, ct_env, _s=s):
                # rematerialized backward (GPipe): re-run the stage
                # forward under autograd from the kept inputs; loss heads
                # ignore their cotangent, so the heads' seed is ones
                env = {k: (v.detach().requires_grad_(True)
                           if v.is_floating_point() else v)
                       for k, v in env_in.items()}
                with torch.enable_grad():
                    env_out, heads, _ = self._run_stage(
                        _s, params_s, aux_s, env, inputs_s, keys, True)
                outs, cots = [], []
                for k, v in env_out.items():
                    if v.requires_grad:
                        outs.append(v)
                        cots.append(ct_env[k])
                for h in heads:
                    if h.requires_grad:
                        outs.append(h)
                        cots.append(torch.ones_like(h))
                names = list(params_s)
                env_keys = [k for k, v in env.items() if v.requires_grad]
                ins = [params_s[n] for n in names] + [env[k]
                                                      for k in env_keys]
                got = (torch.autograd.grad(outs, ins, cots,
                                           allow_unused=True)
                       if outs and ins else [None] * len(ins))
                gp = {n: (g if g is not None else torch.zeros_like(
                    params_s[n].detach()))
                    for n, g in zip(names, got[:len(names)])}
                genv = {k: (g if g is not None else torch.zeros_like(env[k]))
                        for k, g in zip(env_keys, got[len(names):])}
                return gp, genv

            def upd(params_s, grads_s, opt_s, lr, t, _s=s):
                lrs: Dict[float, torch.Tensor] = {}
                with torch.no_grad():
                    for nm in self._stage_params[_s]:
                        m = float(self._lr_mult[nm])
                        if m not in lrs:
                            lrs[m] = lr * m
                        p = params_s[nm]
                        w2, st2 = step_fn(hyper, p, grads_s[nm], opt_s[nm],
                                          lrs[m], opt.wd * self._wd_mult[nm],
                                          t, None)
                        p.copy_(w2)
                        _copy_tree(opt_s[nm], st2)
                return params_s, opt_s

            def evaluate(params_s, aux_s, env_in, inputs_s, keys, _s=s):
                with torch.no_grad():
                    return self._run_stage(_s, params_s, aux_s, env_in,
                                           inputs_s, keys, False)

            self._fwd.append(fwd)
            self._bwd.append(bwd)
            self._upd.append(upd)
            self._eval.append(evaluate)

    # ------------------------------------------------------------------
    # Step
    # ------------------------------------------------------------------

    def _named_inputs(self, batch) -> Dict[str, Any]:
        """A DataBatch / dict / positional batch as a name -> array dict
        in ``self._input_names`` order."""
        if hasattr(batch, "data"):
            vals = list(batch.data) + list(batch.label or [])
            return dict(zip(self._input_names, vals))
        if isinstance(batch, dict):
            return batch
        return dict(zip(self._input_names, batch))

    def _host_tensor(self, v) -> torch.Tensor:
        if isinstance(v, NDArray):
            v = v.data
        if isinstance(v, torch.Tensor):
            return v
        # a copy into torch's (aligned) memory, as ShardedTrainer places
        return torch.tensor(np.asarray(v))

    def _split_micro(self, batch) -> List[List[Dict[str, torch.Tensor]]]:
        """Per-stage, per-microbatch input dicts on each stage's first
        context (the whole batch moves once a context)."""
        named = self._named_inputs(batch)
        M = self.num_microbatches
        placed: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        out = []
        for s in range(self.num_stages):
            dev = self._stage_dev[s]
            per_mb: List[Dict[str, torch.Tensor]] = [{} for _ in range(M)]
            for nm in self._stage_inputs[s]:
                if (nm, dev) not in placed:
                    placed[(nm, dev)] = self._host_tensor(named[nm]).to(dev)
                v = placed[(nm, dev)]
                mb = v.shape[0] // M
                for j in range(M):
                    per_mb[j][nm] = v[j * mb:(j + 1) * mb]
            out.append(per_mb)
        return out

    def _step_scalars(self, dev) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step's rate and update count on ``dev`` (0-d float32)."""
        sc = self._scalars.get(dev)
        if sc is None:
            sc = self._scalars[dev] = (
                torch.zeros((), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.float32, device=dev))
        return sc

    def _lr_now(self) -> float:
        opt = self.optimizer
        return float(opt.lr_scheduler(self._num_update)
                     if opt.lr_scheduler else opt.lr)

    def step(self, batch) -> List[torch.Tensor]:
        """One pipelined training step in **1F1B order**; returns the
        heads concatenated over microbatches (on the producing stage's
        first context).

        Stage ``s`` never holds more than ``S - s`` in-flight microbatch
        environments; backwards drain deepest stage first."""
        if not self._bound:
            raise MXNetError("call bind() before step()")
        self._num_update += 1
        M = self.num_microbatches
        S = self.num_stages
        lr = self._lr_now()
        for dev in set(self._stage_dev):
            lr_t, t_t = self._step_scalars(dev)
            lr_t.fill_(lr)
            t_t.fill_(float(self._num_update))
        inputs = self._split_micro(batch)
        rngs = self._make_rngs(M)

        envs = [[None] * S for _ in range(M)]     # env entering stage s
        env_out = [[None] * S for _ in range(M)]  # env leaving stage s
        ct_out = [[None] * S for _ in range(M)]   # cotangent leaving s
        heads_js = [[None] * S for _ in range(M)]
        aux = [dict(a) for a in self._aux]
        # per-microbatch aux snapshot: the remat re-runs each stage with
        # the aux its forward saw
        aux_snap = [[None] * S for _ in range(M)]
        grads: List[Optional[Dict[str, torch.Tensor]]] = [None] * S

        def run_fwd(j, s):
            env = (self._transfer(env_out[j][s - 1], s) if s > 0 else {})
            envs[j][s] = env
            aux_snap[j][s] = aux[s]
            eo, heads_s, aux_up = self._fwd[s](
                self._params[s], aux[s], env, inputs[s][j], rngs[j][s])
            if aux_up:
                aux[s] = dict(aux[s], **aux_up)
            env_out[j][s] = eo
            heads_js[j][s] = heads_s

        def run_bwd(j, s):
            ct = (self._transfer(ct_out[j][s + 1], s) if s < S - 1 else {})
            gp, genv = self._bwd[s](
                self._params[s], aux_snap[j][s], envs[j][s],
                inputs[s][j], rngs[j][s], ct)
            ct_out[j][s] = genv
            grads[s] = gp if grads[s] is None else \
                {n: grads[s][n] + gp[n] for n in grads[s]}
            # this microbatch's residuals at stage s are released once
            # its backward ran
            envs[j][s] = aux_snap[j][s] = env_out[j][s] = None
            if s < S - 1:
                ct_out[j][s + 1] = None

        fwd_next = [0] * S
        bwd_next = [0] * S
        while min(bwd_next) < M:
            progressed = False
            # drain backwards first (deepest stage first): frees memory
            for s in range(S - 1, -1, -1):
                if (bwd_next[s] < M and fwd_next[s] > bwd_next[s]
                        and (s == S - 1 or bwd_next[s + 1] > bwd_next[s])):
                    run_bwd(bwd_next[s], s)
                    bwd_next[s] += 1
                    progressed = True
            # forwards, gated by the 1F1B in-flight cap (S - s)
            for s in range(S):
                j = fwd_next[s]
                if (j < M and (s == 0 or fwd_next[s - 1] > j)
                        and j - bwd_next[s] < S - s):
                    run_fwd(j, s)
                    fwd_next[s] += 1
                    progressed = True
            if not progressed:
                raise MXNetError("pipeline 1F1B schedule stalled (bug)")

        # ---- per-stage optimizer update -------------------------------
        for s in range(S):
            if not self._params[s]:
                continue
            lr_t, t_t = self._step_scalars(self._stage_dev[s])
            self._params[s], self._opt_state[s] = self._upd[s](
                self._params[s], grads[s], self._opt_state[s], lr_t, t_t)
        self._aux = [{k: v.detach() for k, v in a.items()} for a in aux]
        return self._gather_heads(heads_js)

    def _make_rngs(self, M):
        """Per-(microbatch, stage) keys: one GraphKey a column member,
        valued ``mix(seed, update count, microbatch)`` (folded with the
        member's data coordinate over several), each member's generators
        cached apart."""
        keys = []
        for j in range(M):
            kj = mix(self._seed, self._num_update, j)
            row = []
            for s in range(self.num_stages):
                devs = self._col_devices[s]
                row.append(tuple(
                    GraphKey(kj if len(devs) == 1 else mix(kj, r), dev,
                             self._key_caches.setdefault((s, r), {}))
                    for r, dev in enumerate(devs)))
            keys.append(row)
        return keys

    def _gather_heads(self, heads_js):
        """Concatenate per-microbatch heads back to symbol head order."""
        M = self.num_microbatches
        outs = []
        # heads within one stage were harvested in _head_keys order, so
        # count per-stage positions to recover the global ordering
        pos_in_stage: Dict[int, int] = {}
        for (k, hs) in self._head_keys:
            i = pos_in_stage.get(hs, 0)
            pos_in_stage[hs] = i + 1
            parts = [heads_js[j][hs][i] for j in range(M)]
            outs.append(parts[0] if M == 1 else torch.cat(parts, dim=0))
        return outs

    def forward(self, batch) -> List[torch.Tensor]:
        """Inference forward (moving statistics, no aux update)."""
        if not self._bound:
            raise MXNetError("call bind() before forward()")
        inputs = self._split_micro(batch)
        M, S = self.num_microbatches, self.num_stages
        heads_js = [[None] * S for _ in range(M)]
        rngs = self._make_rngs(M)
        for j in range(M):
            env: Dict[str, torch.Tensor] = {}
            for s in range(S):
                env = self._transfer(env, s)
                env, heads_s, _ = self._eval[s](
                    self._params[s], self._aux[s], env, inputs[s][j],
                    rngs[j][s])
                heads_js[j][s] = heads_s
        return self._gather_heads(heads_js)

    # ------------------------------------------------------------------

    def get_params(self) -> Tuple[Dict[str, NDArray], Dict[str, NDArray]]:
        """Host copies (NDArrays on the CPU) of parameters and aux
        states."""
        arg = {n: nd_array(v.detach(), ctx=cpu())
               for ps in self._params for n, v in ps.items()}
        aux = {n: nd_array(v, ctx=cpu())
               for ax in self._aux for n, v in ax.items()}
        return arg, aux
