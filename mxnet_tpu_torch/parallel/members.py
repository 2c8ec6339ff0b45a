"""Where the members of a mesh meet inside one step.

The JAX package runs one program over the mesh (GSPMD, ``shard_map``)
and its collectives are XLA's.  Here each member of a mesh evaluates its
part of a step in a thread of its own (on its CUDA device, or on a CPU
context), and the members meet wherever a value crosses between them:

* :func:`run_synced` runs ``fn(i, handle)`` for every member in its own
  thread, with :class:`MemberSync` as the meeting point along the axes
  given and :class:`MemberHandle` as each member's side of it;
* ``handle.at(name)`` gives the :class:`NodeSync` an op call sees
  (``OpContext.sync``, or the ``sync=`` of a function that runs inside a
  member: ``ring_attention``, the MoE programs); its methods exchange the
  group's values along one axis and choose whose input each result's
  gradient reaches, since one backward later runs over every member's
  graph.

Meetings are keyed by node and call number, so a recompute scope
replayed in the backward (one thread, after the meeting point closed)
reads the values its forward exchanged.

Over a mesh that spans processes (``dist.init_distributed``), each axis
whose groups cross processes has a :class:`ProcessBridge`.  Once every
member of this process has reached its call ``k`` along such an axis,
the first member exchanges all of them, group by group, with the other
processes of its line along the axis (``parallel/process_mesh.py``),
through that line's process group; every member then gets the values of
its whole global group in its order.  One exchange a call, issued in the
same order on every process, so the processes' collectives pair up.  The
other processes' tensors come out of a link (:class:`_Link`) whose
backward sends each of them its gradient over the same group and
returns this process's.  The links of every axis hang on one token chain
(:class:`TokenChain`), so every process runs their backwards in the same
order (the trainer differentiates the last token with a zero cotangent
beside its heads).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from . import collectives
from .mesh import DATA_AXIS

__all__ = ["MemberSync", "MemberHandle", "NodeSync", "ProcessBridge",
           "TokenChain", "run_synced", "current_sync", "mesh_groups"]

_local = threading.local()


def _flatten(obj):
    """The leaves of a value made of lists and tuples, and a function that
    rebuilds the same structure from other leaves."""
    leaves: list = []

    def walk(o):
        if isinstance(o, (list, tuple)):
            return type(o), [walk(x) for x in o]
        leaves.append(o)
        return None

    shape = walk(obj)

    def rebuild(new_leaves):
        it = iter(new_leaves)

        def back(t):
            if t is None:
                return next(it)
            kind, kids = t
            return kind(back(k) for k in kids)
        return back(shape)
    return leaves, rebuild


def _floating(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


class TokenChain:
    """The token the links of one step hang on: a leaf until a tensor
    that needs a gradient crossed, then the last link's token."""

    def __init__(self):
        self.token = torch.zeros((), requires_grad=True)


class _Link(torch.autograd.Function):
    """The other processes' floating tensors of one cross-process
    meeting, tied to this process's.  Forward: the received tensors (and
    the next token).  Backward: the processes first say which received
    tensors got a gradient (a meeting that detaches the others' values,
    a gather, sends none back), then sum over the line's process group a
    vector with a slot for each such tensor, each process writing the
    gradients of the others' tensors into their slots and zeros into its
    own; each process's slots then hold what the others send its
    tensors."""

    @staticmethod
    def forward(ctx, meta, token, *tensors):
        ctx.meta = meta
        ctx.set_materialize_grads(False)
        return (token.clone(),) + tuple(t.clone()
                                        for t in tensors[meta["nlocal"]:])

    @staticmethod
    def backward(ctx, gtoken, *grads):
        from . import dist
        meta = ctx.meta
        specs, me, line = meta["specs"], meta["me"], meta["line"]
        used = dist.all_gather_object([g is not None for g in grads], line)
        # slot (q, j): process q's tensor j, sent back when any other
        # process's copy of it got a gradient
        wanted = set()
        for p, flags in zip(sorted(line), used):
            slots = [(q, j) for q in line if q != p
                     for j in range(len(specs[q]))]
            wanted.update(sl for sl, f in zip(slots, flags) if f)
        mine: list = [None] * meta["nlocal"]
        it = iter(grads)
        by_dtype: Dict[torch.dtype, list] = {}
        for q in line:
            for j, (shape, dtype) in enumerate(specs[q]):
                g = None if q == me else next(it)
                if (q, j) not in wanted:
                    continue
                if g is None:
                    g = torch.zeros(shape, dtype=dtype)
                by_dtype.setdefault(dtype, []).append(((q, j), g))
        for parts in by_dtype.values():
            flat = torch.cat([dist.transport(g).reshape(-1)
                              for _, g in parts])
            total = collectives.allreduce_processes(
                [flat], axis=meta["axis"], ranks=line)[0]
            off = 0
            for (q, j), g in parts:
                n = g.numel()
                if q == me:
                    mine[j] = total[off:off + n].view(g.shape)
                off += n
        outs = [None if g is None else g.to(d)
                for g, d in zip(mine, meta["devices"])]
        return (None, gtoken) + tuple(outs) + (None,) * len(grads)


class ProcessBridge:
    """Meetings along ``axis`` across processes: this process's members
    hold the global coordinates ``offset`` ... ``offset + n - 1`` of
    ``size`` along it, and ``line`` lists the processes whose members
    share every other coordinate with them, in the order of their
    offsets along the axis.  ``chain`` is the step's token chain, shared
    by every axis's bridge."""

    def __init__(self, axis: str, offset: int, size: int,
                 line: Sequence[int], chain: TokenChain):
        self.axis, self.offset, self.size = axis, offset, size
        self.line, self.chain = list(line), chain

    def exchange(self, groups: list) -> list:
        """``groups`` holds this process's values of each of its groups
        along the axis (a list a group, one value a member, in order);
        every group's values over the whole line come back end to end in
        the line's order.  This process's are returned as they are, the
        others' are differentiable through a link.  A small pickled
        header carries the values' structure, the tensors' shapes and
        types and every other value; the tensors then go as tensors, one
        all-gather a type."""
        from . import dist
        me = dist.process_index()
        leaves, rebuild = _flatten(list(groups))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        want = torch.is_grad_enabled() and any(t.requires_grad
                                              for t in tensors)
        header = ([None if isinstance(x, torch.Tensor) else x
                   for x in leaves],
                  [(tuple(x.shape), x.dtype) for x in tensors], want)
        ranks = sorted(self.line)
        heads = dict(zip(ranks, dist.all_gather_object(header, ranks)))
        got = dist.gather_tensors(
            tensors, {q: h[1] for q, h in heads.items()}, ranks,
            axis=self.axis,
            device=tensors[0].device if tensors else None)
        remote = {}
        for q in self.line:
            if q == me:
                continue
            it = iter(got[q])
            remote[q] = [next(it) if x is None else x for x in heads[q][0]]
        if any(h[2] for h in heads.values()):
            local = [x for x in leaves if _floating(x)]
            specs = {me: [(tuple(x.shape), x.dtype) for x in local]}
            flat = []
            for q, ls in remote.items():
                fl = [x for x in ls if _floating(x)]
                specs[q] = [(tuple(x.shape), x.dtype) for x in fl]
                flat.extend(fl)
            meta = {"nlocal": len(local), "line": self.line, "me": me,
                    "axis": self.axis, "specs": specs,
                    "devices": [x.device for x in local]}
            outs = _Link.apply(meta, self.chain.token, *local, *flat)
            self.chain.token, linked = outs[0], iter(outs[1:])
            remote = {q: [next(linked) if _floating(x) else x for x in ls]
                      for q, ls in remote.items()}
        parts = {q: rebuild(remote[q]) for q in remote}
        parts[me] = list(groups)
        return [[v for q in self.line for v in parts[q][t]]
                for t in range(len(groups))]


class MemberSync:
    """Where the threads of one step's members meet: call number ``k``
    along ``axis`` of each member waits for the values of that call from
    every member of its group along the axis (the members that share
    every other coordinate), and gets them in the group's order.  Once
    the forward is done the meeting point closes: a recompute scope
    replayed in the backward (one thread) reads the values its forward
    exchanged instead (:class:`NodeSync`)."""

    def __init__(self, groups: Dict[str, List[Tuple[int, ...]]],
                 bridges: Optional[Dict[str, ProcessBridge]] = None):
        self.groups = {axis: list(gs) for axis, gs in groups.items()}
        self.group_of = {axis: {i: g for g in gs for i in g}
                         for axis, gs in groups.items()}
        self.bridges = dict(bridges or {})
        self.nmembers = 1 + max((i for gs in groups.values() for g in gs
                                 for i in g), default=0)
        self.closed = False
        self._aborted = False
        self._cond = threading.Condition()
        self._slots: Dict[Tuple, Dict[int, Any]] = {}
        self._met: Dict[Tuple, Any] = {}

    def _wait(self, done) -> None:
        while not done() and not self._aborted:
            self._cond.wait()
        if self._aborted:
            raise threading.BrokenBarrierError

    def exchange(self, i: int, axis: str, k: int, value) -> list:
        bridge = self.bridges.get(axis)
        if bridge is None:
            group = self.group_of[axis][i]
            key = (axis, group, k)
            with self._cond:
                slot = self._slots.setdefault(key, {})
                slot[i] = value
                self._cond.notify_all()
                self._wait(lambda: len(slot) == len(group))
                return [slot[j] for j in group]
        # a bridged axis: every member of this process meets at call k,
        # and the first one meets the other processes for all of them
        key = (axis, k)
        with self._cond:
            slot = self._slots.setdefault(key, {})
            slot[i] = value
            self._cond.notify_all()
            self._wait(lambda: len(slot) == self.nmembers)
            if i != 0:
                self._wait(lambda: key in self._met)
                return self._met[key][i]
        groups = self.groups[axis]
        try:
            full = bridge.exchange([[slot[j] for j in g] for g in groups])
        except BaseException:
            self.abort()
            raise
        met = {j: vals for g, vals in zip(groups, full) for j in g}
        with self._cond:
            self._met[key] = met
            self._cond.notify_all()
        return met[i]

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()


class MemberHandle:
    """One member's side of a :class:`MemberSync`.  ``at(name)`` gives
    the handle an op of that node sees as ``OpContext.sync``
    (:class:`NodeSync`); the handle numbers each member's calls along
    each axis and keeps what every call exchanged, by node and call, for
    a recompute's replay.  ``row_reductions`` names the nodes whose op
    reduces over the rows of the batch (their result is the global
    batch's, through the meeting)."""

    def __init__(self, sync: MemberSync, i: int, row_reductions=()):
        self.sync, self.i = sync, i
        self.row_reductions = frozenset(row_reductions)
        self._calls: Dict[str, int] = {}
        self._seen: Dict[Tuple[str, int], list] = {}

    def at(self, name: str) -> "NodeSync":
        return NodeSync(self, name)

    def size(self, axis: str) -> int:
        bridge = self.sync.bridges.get(axis)
        if bridge is not None:
            return bridge.size
        group = self.sync.group_of.get(axis)
        return 1 if group is None else len(group[self.i])

    def _local_rank(self, axis: str) -> int:
        group = self.sync.group_of.get(axis)
        return 0 if group is None else group[self.i].index(self.i)

    def rank(self, axis: str) -> int:
        """This member's place in its group along ``axis`` (along an axis
        that spans processes, its global coordinate)."""
        bridge = self.sync.bridges.get(axis)
        offset = 0 if bridge is None else bridge.offset
        return offset + self._local_rank(axis)

    def meet(self, key: Tuple[str, int], axis: str, value) -> list:
        """Every group member's ``value`` of this call, in group order.
        After the forward, the values the call met with in the forward,
        this member's own replaced by ``value`` (a recompute's)."""
        if self.sync.closed:
            if key not in self._seen:
                raise MXNetError(
                    f"node {key[0]!r} asked the mesh members for a value "
                    "after the forward that it did not ask for in the "
                    "forward")
            parts = list(self._seen[key])
            parts[self.rank(axis)] = value
            return parts
        k = self._calls.get(axis, 0)
        self._calls[axis] = k + 1
        parts = self.sync.exchange(self.i, axis, k, value)
        self._seen[key] = parts
        if self._local_rank(axis) == 0 and isinstance(value, torch.Tensor):
            collectives.record_axis_call("meet", axis, value, len(parts))
        return parts


class NodeSync:
    """``OpContext.sync`` of one op call on a mesh member: the member's
    meetings, keyed by node and call number.  ``axis`` defaults to the
    data axis (the batch statistics); tensor parallelism meets along the
    model axis, ring attention along ``seq``, expert parallelism along
    ``expert``.

    * ``allreduce``: the sum in group order, differentiable into every
      member's input (every member's output depends on every input);
    * ``host_sum``: the sum of a host number;
    * ``psum_local``: the sum whose gradient reaches only this member's
      input (a row-parallel product's partial sums, whose consumers are
      the same on every member);
    * ``span``: this member's value, whose gradient collects the
      gradients of every member's copy (the input of a column-parallel
      product: identity forward, sum in the backward);
    * ``gather``: the members' pieces end to end, this member's piece
      differentiable and the others' not;
    * ``all_gather``: the members' pieces end to end, each differentiable
      into its owner (the other members differentiate nothing of it);
    * ``shift``: the value of the member before this one along the axis
      (one step of a ring), differentiable into its sender;
    * ``all_to_all``: chunk ``j`` of every member's tensor along
      ``split_dim`` goes to member ``j``, which puts the chunks it gets
      end to end along ``concat_dim`` in the group's order (XLA's tiled
      all-to-all), each differentiable into its sender;
    * ``parts``: the group's values (for an op that combines them)."""

    __slots__ = ("handle", "name", "calls")

    def __init__(self, handle: MemberHandle, name: str):
        self.handle, self.name, self.calls = handle, name, 0

    @property
    def reduces_rows(self) -> bool:
        return self.name in self.handle.row_reductions

    def size(self, axis: str = DATA_AXIS) -> int:
        return self.handle.size(axis)

    def rank(self, axis: str = DATA_AXIS) -> int:
        return self.handle.rank(axis)

    def parts(self, value, axis: str = DATA_AXIS) -> list:
        key, self.calls = (self.name, self.calls), self.calls + 1
        return self.handle.meet(key, axis, value)

    def allreduce(self, t: torch.Tensor, axis: str = DATA_AXIS):
        parts = self.parts(t, axis)
        acc = parts[0].to(t.device)
        for p in parts[1:]:
            acc = acc + p.to(t.device)
        return acc

    def host_sum(self, x, axis: str = DATA_AXIS):
        return sum(self.parts(x, axis))

    def psum_local(self, t: torch.Tensor, axis: str):
        parts = self.parts(t, axis)
        me = self.rank(axis)
        acc = None
        for j, p in enumerate(parts):
            p = t if j == me else p.detach().to(t.device)
            acc = p if acc is None else acc + p
        return acc

    def span(self, t: torch.Tensor, axis: str):
        parts = self.parts(t, axis)
        me = self.rank(axis)
        out = t
        for j, p in enumerate(parts):
            if j != me:
                p = p.to(t.device)
                out = out + (p - p.detach())
        return out

    def gather(self, t: torch.Tensor, dim: int, axis: str):
        parts = self.parts(t, axis)
        me = self.rank(axis)
        return torch.cat([t if j == me else p.detach().to(t.device)
                          for j, p in enumerate(parts)], dim)

    def all_gather(self, t: torch.Tensor, dim: int, axis: str):
        parts = self.parts(t, axis)
        me = self.rank(axis)
        return torch.cat([t if j == me else p.to(t.device)
                          for j, p in enumerate(parts)], dim)

    def shift(self, values: Sequence[torch.Tensor], axis: str) -> list:
        parts = self.parts(tuple(values), axis)
        prev = parts[(self.rank(axis) - 1) % len(parts)]
        return [p.to(v.device) for p, v in zip(prev, values)]

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int,
                   axis: str):
        parts = self.parts(t, axis)
        n, me = len(parts), self.rank(axis)
        if t.shape[split_dim] % n:
            raise MXNetError(f"all_to_all: dimension {split_dim} of size "
                             f"{t.shape[split_dim]} does not split into {n}")
        return torch.cat([p.chunk(n, split_dim)[me].to(t.device)
                          for p in parts], concat_dim)


def current_sync(name: str) -> NodeSync:
    """The calling member thread's meetings for a call named ``name``
    (:func:`run_synced` sets them); raises outside a member's step."""
    handle = getattr(_local, "handle", None)
    if handle is None:
        raise MXNetError(f"{name} runs inside a mesh member's step (a "
                         "trainer's, or one a global entry point runs); "
                         "outside one, pass sync=")
    return handle.at(name)


def run_synced(fn, devices: Sequence[torch.device],
               groups: Dict[str, List[Tuple[int, ...]]],
               row_reductions=(),
               bridges: Optional[Dict[str, ProcessBridge]] = None) -> list:
    """``fn(i, handle)`` for every member in its own thread (on its CUDA
    device, under the caller's grad mode), the members meeting along the
    axes of ``groups`` (and along each bridged axis with the other
    processes); the first failure aborts the others and is raised."""
    sync = MemberSync(groups, bridges)
    outs: list = [None] * len(devices)
    errors: list = []
    grad = torch.is_grad_enabled()

    def run(i):
        dev = devices[i]
        handle = MemberHandle(sync, i, row_reductions)
        _local.handle = handle
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()), torch.set_grad_enabled(grad):
                outs[i] = fn(i, handle)
        except BaseException as exc:
            errors.append(exc)
            sync.abort()
        finally:
            _local.handle = None

    # `sync.closed = True` below stores an attribute after the joins: `sync`
    # itself is never rebound
    # staticcheck: disable=source.daemon-capture -- attribute store, no rebind
    threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                name=f"mesh-member-{i}")
               for i in range(len(devices))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sync.closed = True
    if errors:
        first = next((e for e in errors
                      if not isinstance(e, threading.BrokenBarrierError)),
                     errors[0])
        raise first
    return outs


def mesh_groups(mesh, axes: Sequence[Optional[str]]
                ) -> Dict[str, List[Tuple[int, ...]]]:
    """``{axis: mesh.axis_groups(mesh, axis)}`` for the named axes the
    mesh has."""
    from .mesh import axis_groups
    return {ax: axis_groups(mesh, ax) for ax in axes
            if ax is not None and ax in mesh.axis_names}
