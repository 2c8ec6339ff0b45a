"""Multi-process collective runtime (the ``torch.distributed`` tier).

Counterpart of ``mxnet_tpu/parallel/dist.py``.  The JAX package joins
``jax.distributed``, after which ``jax.devices()`` is global; here
:func:`init_distributed` joins a ``torch.distributed`` process group, and
every process publishes its local contexts (the members it runs), so
that ``make_mesh({"data": -1})`` and ``data_parallel_mesh()`` span every
process's contexts::

    from mxnet_tpu_torch.parallel import dist, make_mesh
    dist.init_distributed()            # env-driven rendezvous
    mesh = make_mesh({"data": -1})     # every process's contexts
    trainer = ShardedTrainer(sym, mesh=mesh, ...)

``ShardedTrainer`` over such a mesh runs only this process's members and
takes the rows of the data coordinates they hold (``parallel/trainer.py``).

A meeting of only some of the processes goes through their own group:
:func:`subgroup` makes the ``torch.distributed`` group of a set of
processes once (``new_group`` is itself a collective of every process,
so every process asks for the same groups in the same order), and
:func:`all_gather_object` and :func:`gather_tensors` take the set of
processes they run over.  :func:`gather_tensors` sends tensors as tensors
(their shapes are known to every process) and counts what it sends;
:func:`all_gather_object` pickles values whose shapes are not.  A sum
over some of the processes is ``collectives.allreduce_processes(...,
ranks=)``.

Rendezvous: a ``TCPStore`` at ``MXTPU_COORDINATOR`` (``host:port``; process
0 hosts it), with ``MXTPU_NUM_PROC`` and ``MXTPU_PROC_ID``, as the JAX
module reads them.  The backend follows the layout, never a caught
failure: NCCL where every process owns one card and no two processes
share one; gloo on the CPU, where a process holds several members, and
where processes share a card (NCCL refuses that layout with "Duplicate
GPU detected").  :func:`backend` says which ran.  On a loopback
coordinator gloo is pinned to the loopback device
(``GLOO_SOCKET_IFNAME=lo`` unless set).  ``watchdog=True`` or
``MXTPU_WATCHDOG`` starts the heartbeat watchdog (:mod:`.watchdog`) once
the group is up; it is kept in ``_watchdog``.
"""
from __future__ import annotations

import datetime
import os
import pickle
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from ..context import Context, as_context, gpu, num_devices

__all__ = ["init_distributed", "is_initialized", "process_index",
           "process_count", "backend", "global_contexts", "shutdown",
           "all_gather_object", "gather_tensors", "subgroup",
           "transport", "choose_backend"]

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


class _World:
    """The joined process group: this process's rank, the world size,
    the backend, the rendezvous store and every process's local
    contexts (as ``(device_type, device_id)`` pairs)."""

    def __init__(self, rank: int, size: int, backend: str, store,
                 layout: List[List[tuple]]):
        self.rank, self.size, self.backend = rank, size, backend
        self.store, self.layout = store, layout
        # the process groups of sets of processes, by their sorted ranks
        self.groups: Dict[Tuple[int, ...], Any] = {}


_world: Optional[_World] = None
# the collective-tier watchdog init_distributed started, if any
_watchdog = None


# how long the rendezvous and each collective wait for the other processes
_TIMEOUT = datetime.timedelta(seconds=300)


def _local_contexts(device) -> List[Context]:
    """This process's members: ``device`` (a context, a device string or
    a list of them)."""
    ctxs = ([as_context(d) for d in device]
            if isinstance(device, (list, tuple)) else [as_context(device)])
    if not ctxs:
        raise MXNetError("init_distributed: no local context given")
    return ctxs


def choose_backend(layout: Sequence[Sequence[tuple]]) -> str:
    """``"nccl"`` when every process holds one member, on a card, and no
    two processes hold the same card (of the same host); else
    ``"gloo"``.  ``layout[p]`` lists process ``p``'s members as
    ``(host, device_type, device_id)``."""
    cards = []
    for members in layout:
        if len(members) != 1 or members[0][1] != "gpu":
            return "gloo"
        cards.append((members[0][0], members[0][2]))
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     watchdog=None, device=None) -> None:
    """Join the process group from the arguments or the environment
    (``MXTPU_COORDINATOR`` = host:port, ``MXTPU_NUM_PROC``,
    ``MXTPU_PROC_ID``).  ``device``: this process's members (a context,
    a device string or a list; default the card ``gpu(process_id %
    card count)``, ``"cpu"`` for ``cpu(0)``).

    ``watchdog=True`` (or env ``MXTPU_WATCHDOG=host:port``) starts the
    collective-tier heartbeat failure detector
    (:class:`~mxnet_tpu_torch.parallel.watchdog.Watchdog`) once the
    process group is up: a lost peer is declared dead after missed
    heartbeats and every surviving process aborts instead of hanging in
    its next collective.  The watchdog address defaults to the
    coordinator host with port+1.  ``watchdog`` may also be a dict of
    :class:`~mxnet_tpu_torch.parallel.watchdog.Watchdog` keyword
    arguments (``interval``, ``timeout``, ``on_failure``, ``on_death``)."""
    global _world, _watchdog
    if _world is not None:
        return
    import torch.distributed as tdist
    coordinator_address = (coordinator_address
                           or os.environ.get("MXTPU_COORDINATOR"))
    wd_env = os.environ.get("MXTPU_WATCHDOG")
    want_watchdog = bool(watchdog or (watchdog is None and wd_env))
    if want_watchdog and not wd_env and not coordinator_address:
        raise MXNetError("watchdog requires MXTPU_WATCHDOG or a "
                         "coordinator address")
    if num_processes is None and "MXTPU_NUM_PROC" in os.environ:
        num_processes = int(os.environ["MXTPU_NUM_PROC"])
    if process_id is None and "MXTPU_PROC_ID" in os.environ:
        process_id = int(os.environ["MXTPU_PROC_ID"])
    if not coordinator_address or num_processes is None \
            or process_id is None:
        raise MXNetError(
            "init_distributed needs a coordinator address, a process "
            "count and a process id (MXTPU_COORDINATOR, MXTPU_NUM_PROC, "
            "MXTPU_PROC_ID)")
    host, port = coordinator_address.rsplit(":", 1)
    rank, size = int(process_id), int(num_processes)
    if device is None:
        cards = num_devices("gpu")
        if not cards:
            raise MXNetError("init_distributed: no CUDA device; pass "
                             "device='cpu' (or CPU contexts) to run on "
                             "the CPU")
        device = gpu(rank % cards)
    ctxs = _local_contexts(device)
    if host in _LOOPBACK:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        store = tdist.TCPStore(host, int(port), size, rank == 0,
                               timeout=_TIMEOUT)
        me = [(socket.gethostname(), c.device_type, c.device_id)
              for c in ctxs]
        store.set(f"mxtpu/layout/{rank}", pickle.dumps(me))
        layout = [pickle.loads(store.get(f"mxtpu/layout/{p}"))
                  for p in range(size)]
        chosen = choose_backend(layout)
        if ctxs[0].device_type == "gpu":
            # this process's first card is its current device (NCCL's
            # communicator and an unthreaded member's launches use it)
            import torch
            torch.cuda.set_device(ctxs[0].device_id)
        tdist.init_process_group(chosen,
                                 store=tdist.PrefixStore("pg", store),
                                 rank=rank, world_size=size,
                                 timeout=_TIMEOUT)
    except (RuntimeError, ValueError) as e:
        raise MXNetError(f"torch.distributed initialization failed "
                         f"(process {rank} of {size} at "
                         f"{coordinator_address}): {e}") from e
    _world = _World(rank, size, chosen, store,
                    [[(t, i) for _, t, i in m] for m in layout])
    if want_watchdog:
        from .watchdog import Watchdog
        if wd_env:
            wd_host, wd_port = wd_env.rsplit(":", 1)
        else:
            wd_host, wd_port = host, int(port) + 1
        kw = dict(watchdog) if isinstance(watchdog, dict) else {}
        _watchdog = Watchdog(rank=rank, world=size,
                             monitor_addr=(wd_host, int(wd_port)),
                             **kw).start()


def is_initialized() -> bool:
    return _world is not None


def process_index() -> int:
    return 0 if _world is None else _world.rank


def process_count() -> int:
    return 1 if _world is None else _world.size


def backend() -> Optional[str]:
    """The process group's backend (``"nccl"`` or ``"gloo"``), None
    before :func:`init_distributed`."""
    return None if _world is None else _world.backend


def global_contexts() -> List[Context]:
    """Every process's members in process order: this process's as plain
    contexts, the others' tagged with their process
    (``Context(..., process=p)``)."""
    if _world is None:
        raise MXNetError("global_contexts() before init_distributed()")
    out = []
    for p, members in enumerate(_world.layout):
        for t, i in members:
            out.append(Context(t, i) if p == _world.rank
                       else Context(t, i, process=p))
    return out


def _ranks(ranks: Optional[Sequence[int]]) -> Tuple[int, ...]:
    return (tuple(range(_world.size)) if ranks is None
            else tuple(sorted({int(r) for r in ranks})))


def subgroup(ranks: Sequence[int]):
    """The ``torch.distributed`` group of the processes ``ranks`` (None,
    the default group, when they are every process), made at the first
    call.  ``new_group`` is a collective of every process: each process
    asks for the same sets in the same order, including the sets it is
    not part of."""
    import torch.distributed as tdist
    ranks = _ranks(ranks)
    if len(ranks) == _world.size:
        return None
    if ranks not in _world.groups:
        _world.groups[ranks] = tdist.new_group(list(ranks))
    return _world.groups[ranks]


def transport(t):
    """``t`` where the backend moves it: on the host for gloo, on this
    process's card for NCCL."""
    import torch
    if _world.backend == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t.detach().to("cpu")


def all_gather_object(obj: Any, ranks: Optional[Sequence[int]] = None
                      ) -> List[Any]:
    """Every process's ``obj`` in process order, through the process
    group of ``ranks`` (default every process; a process outside
    ``ranks`` must not call).  Values are pickled: tensors travel as
    host tensors."""
    import torch.distributed as tdist
    ranks = _ranks(ranks)
    out: List[Any] = [None] * len(ranks)
    tdist.all_gather_object(out, obj, group=subgroup(ranks))
    return out


# types gloo does not carry: sent as their bytes
_AS_BYTES = ("bool", "float8_e4m3fn", "float8_e5m2")


def gather_tensors(tensors: Sequence, specs: Dict[int, Sequence],
                   ranks: Optional[Sequence[int]] = None,
                   axis: Optional[str] = None, device=None
                   ) -> Dict[int, list]:
    """Every process's tensors over ``ranks`` (default every process), as
    tensors: ``specs[q]`` lists process ``q``'s ``(shape, dtype)`` in
    order, known to every process, and ``tensors`` are this process's.
    One all-gather a type, each process's tensors of that type end to end
    and padded to the largest (bool and fp8 as their bytes, which gloo
    does not carry), each counted by ``count_collectives`` as kind
    ``"process"`` along ``axis``.  Returns ``{q: [tensor, ...]}``: the
    others' on ``device`` (default where they arrive), this process's own
    as given."""
    import numpy as np
    import torch
    import torch.distributed as tdist
    from .collectives import record_process_call
    ranks = _ranks(ranks)
    me = _world.rank
    out: Dict[int, list] = {q: [None] * len(specs[q]) for q in ranks}
    out[me] = list(tensors)
    dtypes = sorted({dt for q in ranks for _, dt in specs[q]}, key=str)
    for dtype in dtypes:
        raw = str(dtype).split(".")[-1] in _AS_BYTES
        wire = torch.uint8 if raw else dtype
        size = torch.empty((), dtype=dtype).element_size() if raw else 1
        mine = [t.reshape(-1) for t in tensors if t.dtype == dtype]
        mine = [t.to(torch.uint8) if dtype == torch.bool
                else t.view(torch.uint8) if raw else t for t in mine]
        flat = (torch.cat([transport(t) for t in mine]) if mine
                else transport(torch.empty(0, dtype=wire)))
        counts = [sum(int(np.prod(shape, dtype=np.int64)) * size
                      for shape, dt in specs[q] if dt == dtype)
                  for q in ranks]
        if flat.numel() < max(counts):
            flat = torch.nn.functional.pad(flat,
                                           (0, max(counts) - flat.numel()))
        bufs = [torch.empty_like(flat) for _ in ranks]
        tdist.all_gather(bufs, flat.contiguous(), group=subgroup(ranks))
        record_process_call(axis, counts[ranks.index(me)]
                            * flat.element_size(), len(ranks))
        for q, buf in zip(ranks, bufs):
            if q == me:
                continue
            off = 0
            for j, (shape, dt) in enumerate(specs[q]):
                if dt != dtype:
                    continue
                n = int(np.prod(shape, dtype=np.int64)) * size
                piece = buf[off:off + n]
                piece = (piece.to(torch.bool) if dtype == torch.bool
                         else piece.view(dtype) if raw else piece)
                piece = piece.reshape(shape)
                out[q][j] = piece if device is None else piece.to(device)
                off += n
    return out


def shutdown() -> None:
    """Leave the process group (the store closes with it).  A running
    watchdog stops first, after a barrier, so that no rank's monitor
    reads another's orderly exit as a death."""
    global _world, _watchdog
    if _world is None:
        return
    import torch.distributed as tdist
    if _watchdog is not None:
        tdist.barrier()
        _watchdog.stop()
        _watchdog = None
    tdist.destroy_process_group()
    _world = None
