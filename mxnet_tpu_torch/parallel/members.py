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

Over a data axis that spans processes (``dist.init_distributed``), a
:class:`ProcessBridge` extends each data-axis meeting to the other
processes: once this process's members have met, the group's first
member exchanges their values with the other processes through the
process group (``dist.all_gather_object``), and every member gets the
values of the whole global group in its order.  The other processes'
tensors come out of a link (:class:`_Link`) whose backward sends each
of them its gradient and returns this process's: one exchange a link,
the links chained by a token so that every process runs their
backwards in the same order (the trainer differentiates the last token
with a zero cotangent beside its heads).
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
           "run_synced", "current_sync", "mesh_groups"]

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


def _host(x):
    return x.detach().to("cpu") if isinstance(x, torch.Tensor) else x


class _Link(torch.autograd.Function):
    """The other processes' tensors of one cross-process meeting, tied
    to this process's.  Forward: the received tensors (and the next
    token).  Backward: each received tensor's gradient goes to its
    owner, this process's tensors get the sum of what the other
    processes send them, in process order."""

    @staticmethod
    def forward(ctx, owners, local_devices, token, *tensors):
        nlocal = len(local_devices)
        ctx.owners, ctx.local_devices = owners, local_devices
        remote = tensors[nlocal:]
        return (token.clone(),) + tuple(t.clone() for t in remote)

    @staticmethod
    def backward(ctx, gtoken, *grads):
        from . import dist
        me = dist.process_index()
        send: Dict[int, list] = {}
        for q, g in zip(ctx.owners, grads):
            send.setdefault(q, []).append(_host(g))
        mine: list = [None] * len(ctx.local_devices)
        for q, got in enumerate(dist.all_gather_object(send)):
            if q == me:
                continue
            for j, g in enumerate(got[me]):
                mine[j] = g if mine[j] is None else mine[j] + g
        mine = [None if g is None else g.to(d)
                for g, d in zip(mine, ctx.local_devices)]
        return (None, None, gtoken) + tuple(mine) + (None,) * len(grads)


class ProcessBridge:
    """Data-axis meetings across processes: this process's members hold
    the global data coordinates ``offset`` ... ``offset + n - 1`` of
    ``size``, and the processes' members lie along the axis in process
    order.  ``token`` is the last link's token (a leaf until a tensor
    that needs a gradient crossed)."""

    def __init__(self, axis: str, offset: int, size: int):
        self.axis, self.offset, self.size = axis, offset, size
        self.token = torch.zeros((), requires_grad=True)

    def exchange(self, values: list) -> list:
        """Every process's ``values`` (one a local member, in order) end
        to end in process order; this process's are returned as they
        are, the others' are differentiable through a link."""
        from . import dist
        leaves, rebuild = _flatten(list(values))
        got = dist.all_gather_object([_host(x) for x in leaves])
        me = dist.process_index()
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        dev = tensors[0].device if tensors else None
        remote = {q: [x.to(dev) if isinstance(x, torch.Tensor) else x
                      for x in ls] for q, ls in enumerate(got) if q != me}
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors):
            owners, flat = [], []
            for q, ls in remote.items():
                for x in ls:
                    if isinstance(x, torch.Tensor):
                        owners.append(q)
                        flat.append(x)
            outs = _Link.apply(owners, [t.device for t in tensors],
                               self.token, *tensors, *flat)
            self.token, linked = outs[0], iter(outs[1:])
            remote = {q: [next(linked) if isinstance(x, torch.Tensor)
                          else x for x in ls] for q, ls in remote.items()}
        out: list = []
        for q in range(len(got)):
            out.extend(values if q == me else rebuild(remote[q]))
        return out


class MemberSync:
    """Where the threads of one step's members meet: call number ``k``
    along ``axis`` of each member waits for the values of that call from
    every member of its group along the axis (the members that share
    every other coordinate), and gets them in the group's order.  Once
    the forward is done the meeting point closes: a recompute scope
    replayed in the backward (one thread) reads the values its forward
    exchanged instead (:class:`NodeSync`)."""

    def __init__(self, groups: Dict[str, List[Tuple[int, ...]]],
                 bridge: Optional[ProcessBridge] = None):
        self.group_of = {axis: {i: g for g in gs for i in g}
                         for axis, gs in groups.items()}
        self.bridge = bridge
        self.closed = False
        self._aborted = False
        self._cond = threading.Condition()
        self._slots: Dict[Tuple, Dict[int, Any]] = {}
        self._met: Dict[Tuple, list] = {}

    def exchange(self, i: int, axis: str, k: int, value) -> list:
        group = self.group_of[axis][i]
        key = (axis, group, k)
        bridged = self.bridge is not None and axis == self.bridge.axis
        with self._cond:
            slot = self._slots.setdefault(key, {})
            slot[i] = value
            self._cond.notify_all()
            while len(slot) < len(group) and not self._aborted:
                self._cond.wait()
            if self._aborted:
                raise threading.BrokenBarrierError
            if not bridged:
                return [slot[j] for j in group]
            if i != group[0]:
                while key not in self._met and not self._aborted:
                    self._cond.wait()
                if self._aborted:
                    raise threading.BrokenBarrierError
                return self._met[key]
        # the group's first member meets the other processes
        try:
            full = self.bridge.exchange([slot[j] for j in group])
        except BaseException:
            self.abort()
            raise
        with self._cond:
            self._met[key] = full
            self._cond.notify_all()
        return full

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

    def _bridged(self, axis: str) -> bool:
        return self.sync.bridge is not None and axis == self.sync.bridge.axis

    def size(self, axis: str) -> int:
        if self._bridged(axis):
            return self.sync.bridge.size
        group = self.sync.group_of.get(axis)
        return 1 if group is None else len(group[self.i])

    def _local_rank(self, axis: str) -> int:
        group = self.sync.group_of.get(axis)
        return 0 if group is None else group[self.i].index(self.i)

    def rank(self, axis: str) -> int:
        """This member's place in its group along ``axis`` (over a data
        axis that spans processes, its global data coordinate)."""
        offset = self.sync.bridge.offset if self._bridged(axis) else 0
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
               row_reductions=(), bridge: Optional[ProcessBridge] = None
               ) -> list:
    """``fn(i, handle)`` for every member in its own thread (on its CUDA
    device, under the caller's grad mode), the members meeting along the
    axes of ``groups`` (and along ``bridge``'s axis with the other
    processes); the first failure aborts the others and is raised."""
    sync = MemberSync(groups, bridge)
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
