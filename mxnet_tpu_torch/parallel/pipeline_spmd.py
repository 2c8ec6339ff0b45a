"""The 1F1B pipeline step as one run of the mesh's members over a static
timetable.

Counterpart of ``mxnet_tpu/parallel/pipeline_spmd.py``.
:class:`SpmdPipelineTrainer` keeps :class:`~.pipeline_trainer.
PipelineTrainer`'s stage partition and its constructor and ``bind``; its
step is one call of :func:`~.members.run_synced` over a ``(data, pipe)``
mesh, where the JAX package compiles one ``shard_map`` program
(``dispatch_count`` counts these calls: one a step):

* each member -- one thread a mesh coordinate, on its own context --
  holds its stage's parameters, optimizer state and aux states in padded
  flat float32 buffers (:class:`_FlatSpec`), so stages of different
  shapes share one layout;
* the 1F1B order is a static timetable (:func:`schedule_1f1b`): at each
  tick a member runs its forward slot and its backward slot, then the
  members meet once along ``pipe``: activations move to the next stage
  (+1) and cotangents to the one before (-1), every tick, whether a slot
  ran or not, so the meetings do not depend on the schedule;
* a stage's received activations, cotangents and aux snapshots wait in
  rings of :meth:`SpmdPipelineTrainer._ring_depth` slots;
* the backward slot re-runs the stage forward under autograd from the
  saved flat input and takes ``torch.autograd.grad`` (the GPipe remat);
  gradients accumulate over microbatches in a flat buffer, are summed
  over ``data`` and the members update their stage;
* aux states are averaged over ``data`` after the step; BatchNorm's
  moments are taken over each member's local data shard (non-synced BN,
  as in the JAX program), and sampling keys fold in the data coordinate
  over several data members;
* boundary tensors travel as float32 (a bfloat16 activation is widened
  on the way and narrowed back exactly on arrival).

A mesh's members are distinct contexts (:class:`~.mesh.Mesh`): several
stages on one device are :class:`~.pipeline_trainer.PipelineTrainer`'s.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import cpu
from ..ndarray import array as nd_array
from ..random import GraphKey, mix
from .members import run_synced
from .mesh import DATA_AXIS, PIPE_AXIS, Mesh, axis_groups
from .pipeline_trainer import PipelineTrainer

__all__ = ["SpmdPipelineTrainer", "schedule_1f1b"]


def schedule_1f1b(num_stages: int, num_microbatches: int):
    """Static 1F1B timetable.

    Returns ``(fwd_tbl, bwd_tbl)`` of shape ``[T, S]`` int32: entry
    ``[t, s]`` is the microbatch whose forward (resp. backward) stage
    ``s`` runs at tick ``t``, or ``-1``.  Each tick has one forward and
    one backward slot per stage.  Constraints encoded:

    * ``F(s, j) > F(s-1, j)`` -- activations arrive next tick;
    * ``B(s, j) > B(s+1, j)`` -- cotangents likewise;
    * ``B(s, j) >= F(s, j)`` -- the last stage turns around same-tick
      (its forward slot runs before its backward slot);
    * ``F(s, j) > B(s, j - (S - s))`` -- the 1F1B in-flight cap: stage
      ``s`` holds at most ``S - s`` live microbatches;
    * one forward / one backward per stage per tick.
    """
    S, M = num_stages, num_microbatches
    F = np.zeros((S, M), np.int64)
    B = np.zeros((S, M), np.int64)
    for j in range(M):
        for s in range(S):
            c = [0]
            if s > 0:
                c.append(F[s - 1, j] + 1)
            if j > 0:
                c.append(F[s, j - 1] + 1)
            k = j - (S - s)
            if k >= 0:
                c.append(B[s, k] + 1)
            F[s, j] = max(c)
        for s in range(S - 1, -1, -1):
            c = [F[s, j]]
            if s < S - 1:
                c.append(B[s + 1, j] + 1)
            if j > 0:
                c.append(B[s, j - 1] + 1)
            B[s, j] = max(c)
    T = int(B[0, M - 1]) + 1
    fwd_tbl = -np.ones((T, S), np.int32)
    bwd_tbl = -np.ones((T, S), np.int32)
    for s in range(S):
        for j in range(M):
            fwd_tbl[F[s, j], s] = j
            bwd_tbl[B[s, j], s] = j
    return fwd_tbl, bwd_tbl


class _FlatSpec:
    """Layout of a list of named arrays inside one padded f32 buffer."""

    def __init__(self, items: List[Tuple[str, tuple, Any]]):
        # items: (name, shape, dtype)
        self.items = items
        self.offsets = []
        off = 0
        for _, shape, _ in items:
            self.offsets.append(off)
            off += int(np.prod(shape))
        self.size = off

    def flatten(self, values: Dict[str, torch.Tensor], pad_to: int,
                device=None) -> torch.Tensor:
        """The values end to end as float32, zero-padded to ``pad_to``
        (at least 1; differentiable); ``device`` places an empty
        layout's padding."""
        parts = [values[n].reshape(-1).to(torch.float32)
                 for n, _, _ in self.items]
        pad = pad_to - self.size
        if pad:
            parts.append(torch.zeros(
                (pad,), dtype=torch.float32,
                device=parts[0].device if parts else device))
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def unflatten(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each item as a view of ``buf`` in its shape, cast to its
        dtype (differentiable)."""
        out = {}
        for (n, shape, dtype), off in zip(self.items, self.offsets):
            size = int(np.prod(shape))
            out[n] = buf[off:off + size].reshape(shape).to(dtype)
        return out


def _state_flatten(st) -> Tuple[list, Any]:
    """An optimizer state tree (None, a tensor, nested tuples or lists)
    as its leaves and a structure to rebuild it from."""
    if st is None:
        return [], None
    if isinstance(st, torch.Tensor):
        return [st], "leaf"
    leaves, defs = [], []
    for x in st:
        sub, d = _state_flatten(x)
        leaves.extend(sub)
        defs.append((len(sub), d))
    return leaves, (type(st), defs)


def _state_unflatten(defn, leaves: list):
    if defn is None:
        return None
    if defn == "leaf":
        return leaves[0]
    kind, defs = defn
    out, pos = [], 0
    for n, d in defs:
        out.append(_state_unflatten(d, leaves[pos:pos + n]))
        pos += n
    return kind(out)


class _StackedStateGuard:
    """Data descriptor guarding ``_params``/``_aux``/``_opt_state`` on
    :class:`SpmdPipelineTrainer`: after ``_compile`` the per-stage dicts
    live only in the members' flat buffers (``_pflat``/``_sflat``/
    ``_auxflat``) and the originals are dropped.  An inherited
    :class:`PipelineTrainer` code path that still reaches for them gets a
    clear ``RuntimeError`` naming the supported surface."""

    def __init__(self, name: str):
        self.name = name
        self.slot = "_guarded" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if self.slot not in obj.__dict__:
            raise AttributeError(self.name)
        val = obj.__dict__[self.slot]
        if val is None:
            raise RuntimeError(
                f"SpmdPipelineTrainer.{self.name} is dropped after "
                "compile: per-stage params/aux/optimizer state live only "
                "in the members' flat buffers.  Use get_params() for host "
                "copies, or step()/forward(), which read the flat buffers "
                "directly.")
        return val

    def __set__(self, obj, value):
        obj.__dict__[self.slot] = value


class SpmdPipelineTrainer(PipelineTrainer):
    """:class:`PipelineTrainer` with the whole 1F1B step in one run of
    the mesh's members.

    Same constructor and :meth:`bind`; the contexts must be distinct.
    ``step()`` makes one member run (``self.dispatch_count`` counts
    them)."""

    _params = _StackedStateGuard("_params")
    _aux = _StackedStateGuard("_aux")
    _opt_state = _StackedStateGuard("_opt_state")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        grid = self._grid.reshape(-1)
        if len(set(grid)) != len(grid):
            raise MXNetError(
                f"SpmdPipelineTrainer runs one member a mesh coordinate and "
                f"needs distinct contexts, got {list(grid)}; stages sharing "
                "a device run through PipelineTrainer")
        self.dispatch_count = 0

    def _setup_columns(self, input_shapes) -> None:
        # members take their own statistics (non-synced BN): no column
        # layout to plan or refuse
        self._row_reductions = self._global_heads = frozenset()

    # -- bind hook: PipelineTrainer.bind calls self._compile() last ----

    def _compile(self):
        S, M, dp = self.num_stages, self.num_microbatches, self.dp
        self.mesh = Mesh(self._grid, (DATA_AXIS, PIPE_AXIS))
        self._member_devices = [c.torch_device for c in self.mesh.members]
        shape_of, aux_shape_of = self._shape_of, self._aux_shape_of

        # ---- per-stage flat layouts ---------------------------------
        self._pspecs = [
            _FlatSpec([(n, tuple(shape_of[n]), torch.float32)
                       for n in sorted(self._stage_params[s])])
            for s in range(S)]
        self._auxspecs = [
            _FlatSpec([(n, tuple(aux_shape_of[n]), torch.float32)
                       for n in sorted(self._stage_aux[s])])
            for s in range(S)]
        self._n_max = max(1, max(sp.size for sp in self._pspecs))
        self._aux_max = max(1, max(sp.size for sp in self._auxspecs))

        # optimizer-state layout: per stage, params in sorted order, each
        # param's state tree flattened in order (the structure read off
        # the bound state, so any optimizer's works)
        self._state_defs: List[Dict[str, Any]] = []
        self._sspecs = []
        for s in range(S):
            defs, items = {}, []
            for n in sorted(self._stage_params[s]):
                leaves, defn = _state_flatten(self._opt_state[s][n])
                defs[n] = (len(leaves), defn)
                for i, leaf in enumerate(leaves):
                    items.append((f"{n}#{i}", tuple(leaf.shape), leaf.dtype))
            self._state_defs.append(defs)
            self._sspecs.append(_FlatSpec(items))
        self._state_max = max(1, max(sp.size for sp in self._sspecs))

        # ---- boundary shapes of the local microbatch: one forward of
        # zeros at those shapes on each stage's first member (the JAX
        # package's abstract evaluation) ---------------------------------
        mb_scale = M * dp
        self._mb_inputs = {
            n: (shp[0] // mb_scale,) + tuple(shp[1:])
            for n, shp in self._input_shapes.items()}
        self._envspecs = []            # boundary s -> s+1
        env: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for s in range(S):
                f32 = dict(dtype=torch.float32,
                           device=self._member_devices[s])
                p = {n: torch.zeros(shape_of[n], **f32)
                     for n in self._stage_params[s]}
                a = {n: torch.zeros(aux_shape_of[n], **f32)
                     for n in self._stage_aux[s]}
                i = {n: torch.zeros(self._mb_inputs[n], **f32)
                     for n in self._stage_inputs[s]}
                env = {k: v.to(f32["device"]) for k, v in env.items()}
                env, _, _ = self._stage_apply(
                    s, p, a, env, i, GraphKey(0, f32["device"]), True)
                if s < S - 1:
                    self._envspecs.append(_FlatSpec(
                        [(k, tuple(env[k].shape), env[k].dtype)
                         for k in self._env_after[s]]))
        self._env_max = max([1] + [sp.size for sp in self._envspecs])

        # ---- the bound state into each member's flat buffers ----------
        self._pflat: List[torch.Tensor] = []
        self._auxflat: List[torch.Tensor] = []
        self._sflat: List[torch.Tensor] = []
        rows = {}
        for s in range(S):
            params = {n: v.detach() for n, v in self._params[s].items()}
            states = {}
            for n in sorted(self._stage_params[s]):
                for i, leaf in enumerate(
                        _state_flatten(self._opt_state[s][n])[0]):
                    states[f"{n}#{i}"] = leaf
            cpu_dev = torch.device("cpu")
            rows[s] = (
                self._pspecs[s].flatten(params, self._n_max, cpu_dev).cpu(),
                self._auxspecs[s].flatten(self._aux[s], self._aux_max,
                                          cpu_dev).cpu(),
                self._sspecs[s].flatten(states, self._state_max,
                                        cpu_dev).cpu())
        for i, dev in enumerate(self._member_devices):
            p, a, st = rows[i % S]
            self._pflat.append(p.to(dev, copy=True))
            self._auxflat.append(a.to(dev, copy=True))
            self._sflat.append(st.to(dev, copy=True))
        # per-stage dicts now live only in the flat buffers
        self._params = self._aux = self._opt_state = None

        self._fwd_tbl, self._bwd_tbl = schedule_1f1b(S, M)
        # arrival tables: what last tick's meeting delivered.  An env
        # sent by stage s-1 at tick t lands at stage s at t+1; it may sit
        # several ticks before stage s consumes it (and is read again at
        # backward time for the remat), so receipts go into rings indexed
        # by microbatch, of a depth computed from the tables.
        T = self._fwd_tbl.shape[0]
        arr_f = -np.ones((T, S), np.int32)
        arr_b = -np.ones((T, S), np.int32)
        arr_f[1:, 1:] = self._fwd_tbl[:-1, :-1]
        arr_b[1:, :S - 1] = self._bwd_tbl[:-1, 1:]
        self._arr_f, self._arr_b = arr_f, arr_b
        self._ring_k = self._ring_depth()
        self._groups = {DATA_AXIS: axis_groups(self.mesh, DATA_AXIS),
                        PIPE_AXIS: axis_groups(self.mesh, PIPE_AXIS)}
        self._member_caches: Dict[int, Dict] = {}

    def _ring_depth(self) -> int:
        """Smallest ring size K such that slot ``j % K`` is never
        overwritten (by microbatch ``j + K``) before its last read."""
        S, M = self.num_stages, self.num_microbatches
        F, B = {}, {}
        for t in range(self._fwd_tbl.shape[0]):
            for s in range(S):
                if self._fwd_tbl[t, s] >= 0:
                    F[(s, int(self._fwd_tbl[t, s]))] = t
                if self._bwd_tbl[t, s] >= 0:
                    B[(s, int(self._bwd_tbl[t, s]))] = t
        for k in range(1, 2 * S + M + 1):
            ok = True
            for s in range(S):
                for j in range(M - k):
                    wr_next = (F[(s - 1, j + k)] + 1 if s > 0
                               else F[(s, j + k)])
                    if wr_next <= B[(s, j)]:
                        ok = False
                    if s < S - 1 and B[(s + 1, j + k)] + 1 <= B[(s, j)]:
                        ok = False
                    if F[(s, j + k)] <= B[(s, j)]:  # aux ring
                        ok = False
            if ok:
                return k
        raise MXNetError("no valid ring depth (schedule bug)")

    # -- flat-space stage bodies --------------------------------------

    def _unflat_env(self, boundary: int, buf):
        if boundary < 0 or boundary >= len(self._envspecs):
            return {}
        return self._envspecs[boundary].unflatten(buf)

    def _flat_env(self, boundary: int, env, device):
        if boundary < 0 or boundary >= len(self._envspecs):
            return torch.zeros((self._env_max,), dtype=torch.float32,
                               device=device)
        return self._envspecs[boundary].flatten(env, self._env_max, device)

    def _stage_fwd_flat(self, s, pflat, envflat, inputs_j, auxflat, key,
                        is_train=True):
        """Stage s's forward over flat buffers: ``(flat env out, the
        stage's heads, flat aux after its updates)``."""
        params_s = self._pspecs[s].unflatten(pflat)
        aux_s = self._auxspecs[s].unflatten(auxflat)
        env_in = self._unflat_env(s - 1, envflat)
        inputs_s = {n: inputs_j[n] for n in self._stage_inputs[s]}
        env_out, heads_s, aux_up = self._stage_apply(
            s, params_s, aux_s, env_in, inputs_s, key, is_train)
        if aux_up:
            aux_s = dict(aux_s, **aux_up)
        return (self._flat_env(s, env_out, pflat.device), heads_s,
                self._auxspecs[s].flatten(aux_s, self._aux_max, pflat.device))

    def _stage_bwd_flat(self, s, pflat, envflat, inputs_j, aux_snap, key,
                        ct_env):
        """The rematerialized backward: ``(flat parameter gradient, flat
        cotangent of the env that entered)``."""
        aux_s = self._auxspecs[s].unflatten(aux_snap)
        inputs_s = {n: inputs_j[n] for n in self._stage_inputs[s]}
        pf = pflat.detach().requires_grad_(True)
        ef = envflat.detach().requires_grad_(True)
        with torch.enable_grad():
            params_s = self._pspecs[s].unflatten(pf)
            env_in = self._unflat_env(s - 1, ef)
            env_out, heads, _ = self._stage_apply(
                s, params_s, aux_s, env_in, inputs_s, key, True)
            eo = self._flat_env(s, env_out, pflat.device)
        outs, cots = [], []
        if eo.requires_grad:
            outs.append(eo)
            cots.append(ct_env)
        for h in heads:
            if h.requires_grad:
                # loss heads discard their cotangent: seed ones
                outs.append(h)
                cots.append(torch.ones_like(h))
        gp, genv = (torch.autograd.grad(outs, (pf, ef), cots,
                                        allow_unused=True)
                    if outs else (None, None))
        if gp is None:
            gp = torch.zeros_like(pflat)
        if genv is None:
            genv = torch.zeros_like(envflat)
        return gp, genv

    def _stage_upd_flat(self, s, pflat, gflat, sflat, lr, t):
        """Stage s's optimizer update over flat buffers, in place."""
        opt = self.optimizer
        hyper = opt._hyper()
        hyper["rescale_grad"] = self._rescale_grad
        step_fn = type(opt)._functional_step
        params = self._pspecs[s].unflatten(pflat)
        grads = self._pspecs[s].unflatten(gflat)
        states_flat = self._sspecs[s].unflatten(sflat)
        new_p, new_s = {}, {}
        lrs: Dict[float, torch.Tensor] = {}
        for n in sorted(params):
            count, defn = self._state_defs[s][n]
            st = _state_unflatten(
                defn, [states_flat[f"{n}#{i}"] for i in range(count)])
            m = float(self._lr_mult[n])
            if m not in lrs:
                lrs[m] = lr * m
            w2, st2 = step_fn(hyper, params[n], grads[n], st, lrs[m],
                              opt.wd * self._wd_mult[n], t, None)
            new_p[n] = w2
            for i, leaf in enumerate(_state_flatten(st2)[0]):
                new_s[f"{n}#{i}"] = leaf
        if new_p:
            pflat.copy_(self._pspecs[s].flatten(new_p, self._n_max))
        if new_s:
            sflat.copy_(self._sspecs[s].flatten(new_s, self._state_max))

    # -- the member run -----------------------------------------------

    def _member_key(self, i, d, j) -> GraphKey:
        """Microbatch ``j``'s key on member ``i``: the host-driven path's
        ``(seed, update count, j)``, folded with the data coordinate
        ``d`` over several data members (decorrelated shards)."""
        value = mix(self._seed, self._num_update, j)
        return GraphKey(value if self.dp == 1 else mix(value, d),
                        self._member_devices[i],
                        self._member_caches.setdefault(i, {}))

    def _local_inputs(self, x_mb, d, dev):
        """Member data coordinate ``d``'s rows of every microbatch:
        ``[M, B / (M dp), ...]`` on ``dev``."""
        out = {}
        for n, v in x_mb.items():
            mbl = v.shape[1] // self.dp
            out[n] = v[:, d * mbl:(d + 1) * mbl].to(dev)
        return out

    def _exchange(self, handle, k, value):
        """Every pipe-group member's ``value`` of meeting ``k``, in
        stage order."""
        return handle.sync.exchange(handle.i, PIPE_AXIS, k, value)

    def _train_member(self, i, handle, x_mb, lr_val, t_val):
        S, M, K = self.num_stages, self.num_microbatches, self._ring_k
        d, sid = divmod(i, S)
        dev = self._member_devices[i]
        f32 = dict(dtype=torch.float32, device=dev)
        ploc, aloc, sloc = self._pflat[i], self._auxflat[i], self._sflat[i]
        x_loc = self._local_inputs(x_mb, d, dev)
        zero_env = torch.zeros((self._env_max,), **f32)
        fwd_recv = bwd_recv = zero_env
        ring_env = torch.zeros((K, self._env_max), **f32)
        ring_ct = torch.zeros((K, self._env_max), **f32)
        ring_aux = torch.zeros((K, self._aux_max), **f32)
        aux = aloc.clone()
        grads = torch.zeros((self._n_max,), **f32)
        mine = [q for q, (_, hs) in enumerate(self._head_keys) if hs == sid]
        heads_acc: Dict[int, List[Optional[torch.Tensor]]] = {
            q: [None] * M for q in mine}
        for t in range(self._fwd_tbl.shape[0]):
            fj = int(self._fwd_tbl[t, sid])
            bj = int(self._bwd_tbl[t, sid])
            aj = int(self._arr_f[t, sid])
            cj = int(self._arr_b[t, sid])
            # ---- bank last tick's deliveries ----
            if aj >= 0:
                ring_env[aj % K] = fwd_recv
            if cj >= 0:
                ring_ct[cj % K] = bwd_recv
            # ---- forward slot ----
            eo = zero_env
            if fj >= 0:
                j = fj
                ring_aux[j % K] = aux
                with torch.no_grad():
                    eo, heads, aux = self._stage_fwd_flat(
                        sid, ploc, ring_env[j % K],
                        {n: v[j] for n, v in x_loc.items()}, aux,
                        self._member_key(i, d, j))
                for q, h in zip(mine, heads):
                    heads_acc[q][j] = h
            # ---- backward slot ----
            genv = zero_env
            if bj >= 0:
                j = bj
                gp, genv = self._stage_bwd_flat(
                    sid, ploc, ring_env[j % K].clone(),
                    {n: v[j] for n, v in x_loc.items()},
                    ring_aux[j % K].clone(),
                    self._member_key(i, d, j),
                    ring_ct[j % K].clone())
                grads = grads + gp
            # ---- the unconditional ring moves: +1 and -1 over pipe ----
            parts = self._exchange(handle, t, (eo.detach(), genv.detach()))
            fwd_recv = (parts[sid - 1][0].to(dev) if sid > 0 else zero_env)
            bwd_recv = (parts[sid + 1][1].to(dev) if sid < S - 1
                        else zero_env)
        sync = handle.at("pipeline_step")
        with torch.no_grad():
            grads = sync.allreduce(grads, DATA_AXIS)
            aux = sync.allreduce(aux, DATA_AXIS) / self.dp
            lr = torch.full((), lr_val, **f32)
            tt = torch.full((), t_val, **f32)
            self._stage_upd_flat(sid, ploc, grads, sloc, lr, tt)
            aloc.copy_(aux)
        return {q: torch.stack(hs) for q, hs in heads_acc.items()}

    def _eval_member(self, i, handle, x_mb):
        S, M = self.num_stages, self.num_microbatches
        d, sid = divmod(i, S)
        dev = self._member_devices[i]
        x_loc = self._local_inputs(x_mb, d, dev)
        zero_env = torch.zeros((self._env_max,), dtype=torch.float32,
                               device=dev)
        fwd_recv = zero_env
        mine = [q for q, (_, hs) in enumerate(self._head_keys) if hs == sid]
        heads_acc: Dict[int, List[Optional[torch.Tensor]]] = {
            q: [None] * M for q in mine}
        for t in range(S + M - 1):
            fj = t - sid  # F(s, j) = s + j
            eo = zero_env
            if 0 <= fj < M:
                eo, heads, _ = self._stage_fwd_flat(
                    sid, self._pflat[i], fwd_recv,
                    {n: v[fj] for n, v in x_loc.items()}, self._auxflat[i],
                    self._member_key(i, d, fj), is_train=False)
                for q, h in zip(mine, heads):
                    heads_acc[q][fj] = h
            parts = self._exchange(handle, t, eo)
            fwd_recv = parts[sid - 1].to(dev) if sid > 0 else zero_env
        return {q: torch.stack(hs) for q, hs in heads_acc.items()}

    def _join_heads(self, outs) -> List[torch.Tensor]:
        """Each head from its stage's members, data shards end to end
        within each microbatch, microbatches end to end."""
        S = self.num_stages
        heads = []
        for q, (_, hs) in enumerate(self._head_keys):
            cols = [outs[d * S + hs][q] for d in range(self.dp)]
            lead = cols[0].device
            h = cols[0] if self.dp == 1 else torch.cat(
                [c.to(lead) for c in cols], dim=1)
            heads.append(h.reshape((-1,) + tuple(h.shape[2:])))
        return heads

    # -- public API ----------------------------------------------------

    def _batch_to_mb(self, batch) -> Dict[str, torch.Tensor]:
        named = self._named_inputs(batch)
        M = self.num_microbatches
        out = {}
        for n in self._input_names:
            v = self._host_tensor(named[n])
            if v.dtype != torch.float32:
                v = v.to(torch.float32)
            out[n] = v.reshape((M, v.shape[0] // M) + tuple(v.shape[1:]))
        return out

    def step(self, batch) -> List[torch.Tensor]:
        if not self._bound:
            raise MXNetError("call bind() before step()")
        self._num_update += 1
        x_mb = self._batch_to_mb(batch)
        lr, t = self._lr_now(), float(self._num_update)
        outs = run_synced(
            lambda i, h: self._train_member(i, h, x_mb, lr, t),
            self._member_devices, self._groups)
        self.dispatch_count += 1
        return self._join_heads(outs)

    def forward(self, batch) -> List[torch.Tensor]:
        if not self._bound:
            raise MXNetError("call bind() before forward()")
        x_mb = self._batch_to_mb(batch)
        with torch.no_grad():
            outs = run_synced(
                lambda i, h: self._eval_member(i, h, x_mb),
                self._member_devices, self._groups)
        self.dispatch_count += 1
        return self._join_heads(outs)

    def get_params(self):
        """Host copies (NDArrays on the CPU) of the parameters and aux
        states, read from each stage's first data member."""
        arg, aux = {}, {}
        for s in range(self.num_stages):
            for n, v in self._pspecs[s].unflatten(self._pflat[s]).items():
                arg[n] = nd_array(v.detach(), ctx=cpu())
            for n, v in self._auxspecs[s].unflatten(
                    self._auxflat[s]).items():
                aux[n] = nd_array(v.detach(), ctx=cpu())
        return arg, aux
