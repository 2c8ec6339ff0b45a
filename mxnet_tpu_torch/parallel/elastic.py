"""Elastic fault-tolerant training: live mesh resize over membership views.

Counterpart of ``mxnet_tpu/parallel/elastic.py``, with the same names,
signatures, telemetry and resize records.  It composes what the port
already has -- exact resharding restore (the ZeRO flat-pad lengths follow
the data axis, ``checkpoint/reader.py``), the SIGTERM preemption hook
(``checkpoint/manager.py``), :meth:`ShardedTrainer.compile` and the
scheduler's epoch-numbered membership views (``dist_kvstore``) -- into
a trainer that keeps going when the worker set changes.

The view-change state machine:

  train --(epoch bump)--> drain --> snapshot --> rebuild --> restore
        --> warm restart --> train

* **drain**: every member's card finishes its queued work
  (``torch.cuda.synchronize`` on each of the old mesh's cards; nothing
  on the CPU).  A resize runs between steps, never inside one, so the
  snapshot never takes :meth:`ShardedTrainer.save_state`'s mid-step
  deferral; the update counter is exact and no completed update is lost;
* **snapshot**: :meth:`ShardedTrainer.save_state` through the
  :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager`: the copy from
  the card completes before it returns, the files are written on the
  manager's thread while the new trainer binds;
* **rebuild**: a fresh :class:`ShardedTrainer` over
  ``make_mesh({"data": n}, devices[:n])``;
* **restore**: :meth:`ShardedTrainer.restore_state` reshards every array
  onto the new mesh inside ``manager.restoring()``, so a SIGTERM landing
  mid-restore skips the forced save (committed checkpoints stay the
  source of truth);
* **warm restart**: :meth:`ShardedTrainer.compile` of the new
  generation.  A captured program belongs to its trainer (its owner is
  in the program key), so each generation captures its own; what
  carries over between generations is what this process already built:
  the kernel libraries, and the CUDA contexts, library handles and
  allocator pools of the cards.  ``retraces`` in the resize record
  counts the kernel libraries built or first loaded during the resize
  (:func:`mxnet_tpu_torch._build.build_count`): 0 once the first
  generation has run.

Degradation guarantee: post-resize heads are bitwise those of a fresh
trainer on the new mesh restored from the same snapshot.  Growing back
re-expands the same way.
"""
from __future__ import annotations

import copy
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import _build, telemetry
from ..base import MXNetError
from ..context import as_context, cpu
from .mesh import local_contexts, make_mesh
from .trainer import ShardedTrainer

__all__ = ["ElasticTrainer", "default_mesh_size", "pow2_floor",
           "wire_watchdog"]


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (1 for n < 1): keeps the global batch
    divisible by the data axis across every resize, so resizing never
    changes program shapes beyond the mesh itself."""
    n = int(n)
    if n < 1:
        return 1
    return 1 << (n.bit_length() - 1)


def default_mesh_size(view: Dict[str, Any], max_devices: int) -> int:
    """Mesh size for a membership view: the power-of-two floor of the
    members' total device capacity, clipped to the local device count.
    4 members x capacity 2 -> 8; lose one (capacity 6) -> 4; grow back
    -> 8."""
    total = sum(int(m.get("capacity", 1))
                for m in view.get("members", {}).values())
    return pow2_floor(min(max(total, 1), int(max_devices)))


def _prewarm_enabled() -> bool:
    raw = os.environ.get("MXNET_TPU_ELASTIC_PREWARM", "").strip()
    return raw not in ("0", "false", "off") if raw else True


def wire_watchdog(watchdog, membership) -> Any:
    """Feed watchdog death verdicts into the membership view: the
    ``on_death`` observer reports the dead rank over ``mdead``, so the
    verdict raises the same epoch-bump event as a graceful leave or a
    heartbeat expiry -- one "membership changed" signal for every
    failure class."""
    prev = watchdog.on_death

    def feed(dead_rank: int) -> None:
        if prev is not None:
            prev(dead_rank)
        membership.report_dead(str(dead_rank), reason="watchdog-death")

    watchdog.on_death = feed
    return watchdog


def _resolve_devices(devices, device) -> List:
    """The contexts meshes are cut from: ``devices`` as given, else every
    card (``device`` None or ``"cuda"``), ``cpu(0)`` for ``"cpu"``, or the
    one context ``device`` names."""
    if devices is not None:
        return [as_context(d) for d in devices]
    if device is None or device == "cuda":
        cards = local_contexts("gpu") if torch.cuda.is_available() else []
        if not cards:
            raise MXNetError("ElasticTrainer: no CUDA device; pass "
                             "device='cpu' (or CPU contexts as devices) to "
                             "run on the CPU")
        return cards
    if isinstance(device, str) and device == "cpu":
        return [cpu(0)]
    return [as_context(device)]


class ElasticTrainer:
    """A :class:`ShardedTrainer` that resizes its mesh on membership
    changes (drain -> snapshot -> reshard restore -> warm restart).

    Parameters
    ----------
    symbol : the network (rebuilt per generation; the symbol itself is
        shared -- it is immutable config).
    optimizer, optimizer_params : forwarded to every generation.  Pass
        the optimizer by NAME (string): instances are deep-copied per
        generation so one generation's mutation cannot leak into the
        next.
    manager : the :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager`
        the resize pipeline snapshots/restores through (shared with the
        SIGTERM preemption hook -- install that with
        ``install_preemption_hook(et.save_now, exit_after=True)``).
    membership : optional :class:`~mxnet_tpu_torch.parallel.dist_kvstore.
        MembershipClient`; when present, :meth:`step` checks the view
        epoch and resizes automatically.  ``None`` = resize only via
        explicit :meth:`resize` calls (the in-process test mode).
    devices : contexts (default: every card, see ``device``).  Meshes are
        always built over ``devices[:n]``.  A mesh's members are distinct
        contexts of one type, so on one card the largest mesh has one
        member.
    mesh_size_fn : ``(view, max_devices) -> n`` (default
        :func:`default_mesh_size`).
    programs : program kinds to compile per generation (default
        ``("train",)``).
    trainer_kwargs : extra :class:`ShardedTrainer` kwargs applied to
        every generation (``shard_optimizer=True`` etc.).
    prewarm : pre-warm likely resize targets (half / double the current
        size) on background threads (default ``MXNET_TPU_ELASTIC_PREWARM``,
        on); see :meth:`prewarm`.
    device : without ``devices``: None or ``"cuda"`` for every card,
        ``"cpu"`` for ``cpu(0)``, or one context.
    """

    def __init__(self, symbol, optimizer="sgd",
                 optimizer_params: Optional[Dict[str, Any]] = None,
                 manager=None, membership=None,
                 devices: Optional[Sequence] = None,
                 mesh_size_fn: Optional[
                     Callable[[Dict[str, Any], int], int]] = None,
                 programs: Sequence[str] = ("train",),
                 trainer_kwargs: Optional[Dict[str, Any]] = None,
                 prewarm: Optional[bool] = None,
                 logger=None, device=None):
        self.symbol = symbol
        self._optimizer = optimizer
        self._optimizer_params = dict(optimizer_params or {})
        self.manager = manager
        self.membership = membership
        self._devices = _resolve_devices(devices, device)
        self._mesh_size_fn = mesh_size_fn or default_mesh_size
        self._programs = tuple(programs)
        self._trainer_kwargs = dict(trainer_kwargs or {})
        self.prewarm_enabled = (_prewarm_enabled() if prewarm is None
                                else bool(prewarm))
        self.logger = logger or logging.getLogger(__name__)
        self._tr: Optional[ShardedTrainer] = None
        self._size = 0
        self._view_epoch = -1
        self._data_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
        self._label_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
        self._warmed: set = set()
        # cards whose context, handles and pools this process has set up
        self._warm_cards: set = set()
        self._prewarm_threads: Dict[int, threading.Thread] = {}
        self._prewarm_lock = threading.Lock()
        self.generation = 0
        self.resizes: List[Dict[str, Any]] = []

    # -- construction ---------------------------------------------------

    def _make_optimizer(self):
        if isinstance(self._optimizer, str):
            return self._optimizer
        return copy.deepcopy(self._optimizer)

    def _build(self, n: int) -> ShardedTrainer:
        if n < 1 or n > len(self._devices):
            raise MXNetError(f"elastic: mesh size {n} out of range "
                             f"(1..{len(self._devices)})")
        mesh = make_mesh({"data": n}, self._devices[:n])
        tr = ShardedTrainer(self.symbol, optimizer=self._make_optimizer(),
                            optimizer_params=self._optimizer_params,
                            mesh=mesh, **self._trainer_kwargs)
        tr.bind(self._data_shapes, self._label_shapes)
        self._warm_cards.update(self._cards(n))
        return tr

    def _cards(self, n: int) -> List[int]:
        return [c.device_id for c in self._devices[:n]
                if c.device_type == "gpu"]

    def bind(self, data_shapes: Dict[str, Tuple[int, ...]],
             label_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
             initial_size: Optional[int] = None) -> "ElasticTrainer":
        """Build + bind + compile the first generation.  The initial mesh
        size comes from the membership view (wait for peers BEFORE
        calling, e.g. ``membership.wait_for(lambda v: len(v["members"])
        >= expected)``), or from ``initial_size``/all devices without
        one."""
        self._data_shapes = dict(data_shapes)
        self._label_shapes = (dict(label_shapes) if label_shapes else None)
        if initial_size is not None:
            n = int(initial_size)
        elif self.membership is not None and self.membership.view is not None:
            view = self.membership.view
            self._view_epoch = view["epoch"]
            n = self._mesh_size_fn(view, len(self._devices))
        else:
            n = pow2_floor(len(self._devices))
        self._tr = self._build(n)
        self._size = n
        self.generation = 1
        telemetry.gauge("elastic.mesh_devices").set(n)
        if self.membership is not None:
            telemetry.gauge("elastic.view_epoch").set(
                max(0, self._view_epoch))
        self._tr.compile(programs=self._programs)
        self._warmed.add(n)
        if self.prewarm_enabled:
            self.prewarm(self._prewarm_targets(n))
        return self

    # -- surface --------------------------------------------------------

    @property
    def trainer(self) -> ShardedTrainer:
        if self._tr is None:
            raise MXNetError("call bind() first")
        return self._tr

    @property
    def size(self) -> int:
        return self._size

    @property
    def num_update(self) -> int:
        return self.trainer._num_update

    def step(self, batch):
        """One training step, resizing first if the membership epoch
        moved.  The resize happens BETWEEN steps -- a worker lost at
        step k costs detection latency (heartbeat/connection) plus one
        drain, never a torn update."""
        self.maybe_resize()
        return self.trainer.step(batch)

    def save_now(self) -> str:
        """Blocking snapshot of the current generation -- the body for
        ``manager.install_preemption_hook`` (the SIGTERM notice and a
        membership change thereby share one checkpoint path).  From a
        signal that lands inside a step, the trainer saves at the step's
        end (:meth:`ShardedTrainer.save_state`)."""
        return self.trainer.save_state(self.manager, blocking=True)

    def shutdown(self, final: bool = True) -> None:
        """Leave the membership (``final=True`` flips the view's closing
        flag so every other member winds down too)."""
        if self.membership is not None:
            self.membership.leave(final=final)

    # -- resize pipeline ------------------------------------------------

    def maybe_resize(self) -> bool:
        """Resize if the membership view changed; returns whether a
        resize ran.  Epoch bumps that do not change the computed mesh
        size (e.g. a capacity-neutral replacement join, or any change
        when one card bounds the mesh) are absorbed without touching the
        trainer."""
        if self.membership is None:
            return False
        view = self.membership.view
        if view is None or view["epoch"] <= self._view_epoch:
            return False
        self._view_epoch = view["epoch"]
        telemetry.gauge("elastic.view_epoch").set(view["epoch"])
        n = self._mesh_size_fn(view, len(self._devices))
        if n == self._size:
            return False
        self.resize(n)
        return True

    def _drain(self, tr: ShardedTrainer) -> None:
        """The old generation's queued work completes: every card of its
        mesh synchronizes (the state arrays' last writers included)."""
        for dev in sorted({d.index for d in tr._devices
                           if d.type == "cuda"}):
            torch.cuda.synchronize(dev)

    def resize(self, n: int) -> Dict[str, Any]:
        """Drain -> snapshot -> rebuild on ``n`` devices -> reshard
        restore -> warm restart.  Returns the resize record (also
        appended to :attr:`resizes` and emitted as telemetry)."""
        if self._tr is None:
            raise MXNetError("call bind() first")
        if n == self._size:
            return {}
        if self.manager is None:
            raise MXNetError("elastic resize needs a CheckpointManager "
                             "(the snapshot/restore transport)")
        old = self._tr
        if old._in_step:
            raise MXNetError("elastic: resize inside a training step (the "
                             "snapshot would be deferred to the step's end)")
        direction = "shrink" if n < self._size else "grow"
        builds = _build.build_count()
        t0 = time.perf_counter()
        with telemetry.span("elastic.resize", direction=direction,
                            from_devices=self._size, to_devices=n):
            # drain: the in-flight step's outputs become real before the
            # snapshot reads them -- bounded by one step time
            self._drain(old)
            drain_ms = (time.perf_counter() - t0) * 1000.0
            saved_update = old._num_update
            old.save_state(self.manager)  # async: writes overlap the bind
            new = self._build(n)
            # no pre-warm thread runs while the new generation captures
            self._join_prewarm()
            r0 = time.perf_counter()
            # restoring(): a SIGTERM landing inside this window must NOT
            # force-save the half-restored state -- the snapshot above
            # (and every committed checkpoint before it) stays valid
            with self.manager.restoring():
                _, restored_step = new.restore_state(self.manager)
            restore_ms = (time.perf_counter() - r0) * 1000.0
            new.compile(programs=self._programs)
        retraces = _build.build_count() - builds
        steps_lost = int(saved_update - restored_step)
        total_ms = (time.perf_counter() - t0) * 1000.0
        rec = {"direction": direction, "from_devices": self._size,
               "to_devices": n, "epoch": self._view_epoch,
               "drain_ms": drain_ms, "restore_ms": restore_ms,
               "pause_ms": total_ms, "steps_lost": steps_lost,
               "retraces": retraces, "num_update": new._num_update}
        self._tr = new
        self._size = n
        self._warmed.add(n)
        self.generation += 1
        self.resizes.append(rec)
        telemetry.counter("elastic.resizes").inc(direction=direction)
        telemetry.histogram("elastic.drain_ms").observe(drain_ms)
        telemetry.histogram("elastic.restore_ms").observe(restore_ms)
        telemetry.counter("elastic.steps_lost").inc(steps_lost)
        telemetry.gauge("elastic.mesh_devices").set(n)
        telemetry.emit("elastic", dict(rec, event="resize"))
        self.logger.info(
            "elastic: %s %d->%d devices in %.0f ms (drain %.0f, restore "
            "%.0f), %d steps lost, %d retraces", direction,
            rec["from_devices"], n, total_ms, drain_ms, restore_ms,
            steps_lost, retraces)
        if self.prewarm_enabled:
            self.prewarm(self._prewarm_targets(n))
        return rec

    # -- pre-warm -------------------------------------------------------

    def _prewarm_targets(self, n: int) -> List[int]:
        """The two likely next meshes: half (the next shrink) and double
        (the grow-back), clipped to the device count."""
        out = []
        if n // 2 >= 1:
            out.append(n // 2)
        if n * 2 <= pow2_floor(len(self._devices)):
            out.append(n * 2)
        return out

    def prewarm(self, sizes: Sequence[int], wait: bool = False) -> None:
        """Prepare other mesh sizes, each on a daemon thread: on every
        card of ``devices[:n]`` that this process has not used yet, the
        CUDA context, the cuBLAS handle (returned to torch's pool for the
        next generation when the thread ends) and an allocator segment of
        the current generation's state size, freed into the caching
        allocator.  The kernel libraries need nothing: the first
        generation's compile built and loaded them for the whole process.
        A pre-warm captures no program (a program belongs to its trainer)
        and :meth:`resize` joins these threads before the new generation
        captures its own."""
        started = []
        nbytes = self._state_bytes()
        with self._prewarm_lock:
            for n in sizes:
                n = int(n)
                if (n in self._warmed or n == self._size
                        or n in self._prewarm_threads):
                    continue
                th = threading.Thread(target=self._prewarm_one,
                                      args=(n, nbytes), daemon=True,
                                      name=f"elastic-prewarm[{n}]")
                self._prewarm_threads[n] = th
                started.append(th)
        for th in started:
            th.start()
        if wait:
            for th in started:
                th.join()

    def _state_bytes(self) -> int:
        """Bytes of the current generation's parameters and aux states
        (host metadata only: no read of the card)."""
        if self._tr is None:
            return 0
        tr = self._tr
        return sum(v.numel() * v.element_size()
                   for v in list(tr._params.values())
                   + list(tr._aux.values()))

    def _prewarm_one(self, n: int, nbytes: int) -> None:
        try:
            for idx in self._cards(n):
                if idx in self._warm_cards:
                    continue
                with torch.cuda.device(idx):
                    torch.cuda.current_blas_handle()
                    # allocated and freed at once: the segment stays in
                    # the caching allocator for the next generation
                    torch.empty(nbytes, dtype=torch.uint8,
                                device=f"cuda:{idx}")
                    torch.cuda.synchronize(idx)
                with self._prewarm_lock:
                    self._warm_cards.add(idx)
            with self._prewarm_lock:
                self._warmed.add(n)
        except Exception:
            self.logger.exception("elastic: pre-warm of %d-device mesh "
                                  "failed (resize will set it up cold)", n)

    def _join_prewarm(self) -> None:
        with self._prewarm_lock:
            threads = list(self._prewarm_threads.values())
            self._prewarm_threads.clear()
        for th in threads:
            if th.is_alive():
                th.join(timeout=120.0)
