"""CheckpointManager: save policies, auto-resume, preemption safety.

Counterpart of ``mxnet_tpu/checkpoint/manager.py``.  One manager owns one
checkpoint root directory and provides:

* **save policies** -- ``save_interval_steps`` / ``save_interval_seconds``
  drive :meth:`should_save`; :meth:`save` snapshots synchronously (the
  copies from the card and one stream synchronize) and commits on the
  background writer thread, then runs retention GC (``keep_last`` +
  ``keep_every`` milestones);
* **discovery** -- :meth:`latest_step` / :meth:`all_steps` see only
  COMMITTED checkpoints (atomic-rename protocol, torn writes invisible);
* **auto-resume** -- :meth:`restore_or_initialize` restores the newest
  checkpoint if one exists, else runs the initializer;
* **preemption** -- :meth:`install_preemption_hook` registers a SIGTERM
  handler that forces a final save and drains the writer, and sets
  :attr:`preempted` so training loops stop at the next batch.  A save
  that lands mid-step is deferred to the step's end (:meth:`defer_save`).

:meth:`save_model` / :meth:`load_model` store a Symbol with its arg/aux
params (the ``FeedForward``/``Module`` surface; ``load_model`` gives
host NDArrays); trainer state goes through ``ShardedTrainer.save_state``
/ ``restore_state``, built on :meth:`save` / :meth:`restore`.
:meth:`restore` gives host numpy arrays, or each mesh member's piece
for the arrays it is given a sharding for (any saving mesh).
"""
from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from . import layout, reader, writer

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 keep_every: Optional[int] = None,
                 save_interval_steps: Optional[int] = None,
                 save_interval_seconds: Optional[float] = None,
                 async_write: bool = True, verify_on_restore: bool = True,
                 logger=None):
        self.directory = str(directory)
        self.keep_last = int(keep_last)
        self.keep_every = int(keep_every) if keep_every else None
        self.save_interval_steps = (int(save_interval_steps)
                                    if save_interval_steps else None)
        self.save_interval_seconds = (float(save_interval_seconds)
                                      if save_interval_seconds else None)
        self.async_write = async_write
        self.verify_on_restore = verify_on_restore
        self.logger = logger or logging.getLogger(__name__)
        self.preempted = False
        self._restoring = False
        self._writer = writer.AsyncCheckpointWriter(logger=self.logger)
        self._last_save_step: Optional[int] = None
        self._last_save_time: Optional[float] = None
        self._prev_handlers: Dict[int, Any] = {}
        self._exit_after = False
        self._save_deferred = False
        self._pending_signal: Optional[Tuple[int, Any]] = None
        os.makedirs(self.directory, exist_ok=True)
        swept = writer.sweep_staging(self.directory)
        if swept:
            self.logger.info("checkpoint: swept %d stale staging dir(s) "
                             "from a previous crashed writer", len(swept))

    # ------------------------------------------------------------------
    # Discovery
    # ------------------------------------------------------------------

    def all_steps(self) -> List[int]:
        return layout.committed_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_path(self, step: int) -> str:
        return layout.step_path(self.directory, step)

    # ------------------------------------------------------------------
    # Save
    # ------------------------------------------------------------------

    def should_save(self, step: int) -> bool:
        """Step/time policy gate; a preemption always says yes."""
        if step == self._last_save_step:
            return False  # already captured (e.g. by the preemption hook)
        if self.preempted:
            return True
        now = time.monotonic()
        if (self.save_interval_steps
                and step % self.save_interval_steps == 0):
            return True
        if self.save_interval_seconds is not None:
            if self._last_save_time is None:
                self._last_save_time = now  # arm the clock on first ask
                return False
            return now - self._last_save_time >= self.save_interval_seconds
        return False

    def save(self, step: int, arrays: Dict[str, Any],
             meta: Optional[Dict[str, Any]] = None,
             blocking: Optional[bool] = None) -> str:
        """Checkpoint ``{name: array}`` at ``step``.

        The device->host snapshot happens NOW, on this thread (it must
        precede the next donating train step); serialization, fsync,
        atomic commit, and retention GC run on the writer thread unless
        ``blocking`` (or the manager is configured sync).  Returns the
        final checkpoint path (which exists only after the write lands --
        ``wait_until_finished`` is the barrier).  ``meta`` may be a
        zero-argument callable, called after the snapshot.
        """
        step = int(step)
        snap = writer.snapshot(arrays)
        if callable(meta):
            # read only now: values the caller queued for the host before
            # the snapshot's synchronize have landed with it
            meta = meta()
        self._last_save_step = step
        self._last_save_time = time.monotonic()

        def commit():
            writer.write_checkpoint(self.directory, step, snap, meta=meta)
            writer.gc_checkpoints(self.directory, self.keep_last,
                                  self.keep_every, logger=self.logger)
            self.logger.info("checkpoint: committed step %d -> %s", step,
                             layout.step_dir_name(step))

        if blocking or (blocking is None and not self.async_write):
            commit()
        else:
            self._writer.submit(commit)
        return self.step_path(step)

    def save_shards(self, step: int,
                    shards: Dict[str, Tuple[Sequence[int], list]],
                    meta: Optional[Dict[str, Any]] = None, exchange=None,
                    process_index: int = 0, process_count: int = 1) -> str:
        """Checkpoint ``step`` written by several processes at once, each
        calling with its ``shards`` (``{name: (global shape, [(index,
        array)])}``, the pieces it writes: ``writer.
        write_process_checkpoint``) and ``exchange`` (an all-gather of
        objects over the processes).  Runs on the calling thread, where
        the processes meet, and returns the committed path; earlier
        saves of this manager commit first.  ``meta`` may be a
        zero-argument callable, called after the snapshot (the trainer's
        reads scalars it queued for the host before it)."""
        step = int(step)
        self.wait_until_finished()
        flat = {(name, k): arr for name, (_, pieces) in shards.items()
                for k, (_, arr) in enumerate(pieces)}
        snap = writer.snapshot(flat)
        host = {name: (shape, [(index, snap[(name, k)][0][1])
                               for k, (index, _) in enumerate(pieces)])
                for name, (shape, pieces) in shards.items()}
        if callable(meta):
            meta = meta()
        self._last_save_step = step
        self._last_save_time = time.monotonic()
        path = writer.write_process_checkpoint(
            self.directory, step, host, meta, exchange, process_index,
            process_count)
        if process_index == 0:
            writer.gc_checkpoints(self.directory, self.keep_last,
                                  self.keep_every, logger=self.logger)
        self.logger.info("checkpoint: committed step %d -> %s (%d "
                         "processes)", step, layout.step_dir_name(step),
                         process_count)
        return path

    def maybe_save(self, step: int, state_fn: Callable[[], Tuple],
                   blocking: Optional[bool] = None) -> bool:
        """Policy-gated save: when :meth:`should_save` fires, call
        ``state_fn() -> (arrays, meta)`` and save.  The lazy callable
        keeps state capture off the no-save fast path."""
        if not self.should_save(step):
            return False
        arrays, meta = state_fn()
        self.save(step, arrays, meta=meta,
                  blocking=True if self.preempted else blocking)
        return True

    def wait_until_finished(self) -> None:
        self._writer.wait_until_finished()

    # ------------------------------------------------------------------
    # Restore
    # ------------------------------------------------------------------

    def restore(self, step: Optional[int] = None,
                shardings: Optional[Dict[str, Any]] = None,
                target_shapes: Optional[Dict[str, Sequence[int]]] = None,
                names: Optional[Sequence[str]] = None
                ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
        """Load checkpoint ``step`` (default: newest): ``(arrays, meta,
        step)``, each array host numpy, or with a sharding in
        ``shardings`` (name -> ``NamedSharding`` of the current mesh) each
        member's piece on its device, whatever mesh saved it.
        ``target_shapes`` overrides per-name shapes for the ZeRO flat-pad
        case; ``names`` picks the arrays (default: all).  Raises
        MXNetError if no committed checkpoint exists or verification
        fails."""
        shardings = shardings or {}
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise MXNetError(
                    f"no committed checkpoint under {self.directory!r}")
        dirpath = self.step_path(step)
        manifest = layout.read_manifest(dirpath)
        entries = manifest["arrays"]
        names = list(entries) if names is None else list(names)
        target_shapes = target_shapes or {}
        out = {}
        for name in names:
            if name not in entries:
                raise MXNetError(
                    f"checkpoint step {step} has no array {name!r}")
            out[name] = reader.restore_array(
                dirpath, name, entries[name],
                sharding=shardings.get(name),
                target_shape=target_shapes.get(name),
                verify=self.verify_on_restore)
        return out, manifest.get("meta", {}), step

    @contextlib.contextmanager
    def restoring(self):
        """Mark a restore-in-progress window (divergence rollback).

        While active, the preemption hook will NOT force a save: trainer
        state mid-restore is a mix of old and new arrays, and persisting
        it would corrupt the newest-checkpoint invariant the rollback is
        trying to return to.  The signal still sets :attr:`preempted` and
        drains the writer, so shutdown semantics are otherwise unchanged.
        """
        self._restoring = True
        try:
            yield self
        finally:
            self._restoring = False

    def restore_or_initialize(self, restore_fn: Callable[[int], Any],
                              init_fn: Optional[Callable[[], Any]] = None):
        """Auto-resume: newest committed checkpoint -> ``restore_fn(step)``;
        none -> ``init_fn()`` (default no-op returning None).  This is the
        idempotent startup call for preemptible jobs: the same script line
        does the right thing on first launch and on every restart."""
        step = self.latest_step()
        if step is not None:
            self.logger.info("checkpoint: resuming from step %d", step)
            return restore_fn(step)
        return init_fn() if init_fn is not None else None

    # ------------------------------------------------------------------
    # Preemption
    # ------------------------------------------------------------------

    def install_preemption_hook(self, save_fn: Callable[[], Any],
                                signals: Sequence[int] = (signal.SIGTERM,),
                                exit_after: bool = False) -> None:
        """On SIGTERM (the cluster's preemption notice): set
        :attr:`preempted`, run ``save_fn`` (e.g. ``lambda:
        trainer.save_state(manager, blocking=True)``), drain the writer,
        then chain to the previous handler (and exit 143 if
        ``exit_after``).  Training loops that poll :attr:`preempted`
        (``ShardedTrainer.fit(checkpoint_manager=...)`` does) stop at the
        next batch boundary instead.

        A signal that lands inside a training step finds the state half
        updated; the trainer's ``save_state`` then calls
        :meth:`defer_save` instead of saving, and the chaining and exit
        wait for :meth:`deferred_save_done` at the step's end."""

        def handler(signum, frame):
            already = self.preempted
            self.preempted = True
            if not already:
                # postmortem evidence first: the forced save (or a chained
                # handler) may be the last thing this process ever does
                from .. import telemetry
                telemetry.dump_flight(
                    "sigterm", extra={"signum": int(signum),
                                      "restoring": self._restoring})
                if self._restoring:
                    # mid-rollback state is a mix of old and new arrays;
                    # saving it would clobber the good checkpoint.  The
                    # committed set on disk is already consistent.
                    self.logger.warning(
                        "checkpoint: signal %d received during a restore "
                        "— skipping the forced save (committed "
                        "checkpoints on disk remain the source of truth)",
                        signum)
                    self.wait_until_finished()
                else:
                    self.logger.warning(
                        "checkpoint: signal %d received — forcing a final "
                        "save before shutdown", signum)
                    self._save_deferred = False
                    try:
                        save_fn()
                    finally:
                        self.wait_until_finished()
                    if self._save_deferred:
                        self._pending_signal = (signum, frame)
                        return
            self._after_signal(signum, frame)

        if threading.current_thread() is not threading.main_thread():
            raise MXNetError("install_preemption_hook must run on the "
                             "main thread (signal module restriction)")
        self._exit_after = exit_after
        for sig in signals:
            self._prev_handlers[sig] = signal.getsignal(sig)
            signal.signal(sig, handler)

    def _after_signal(self, signum, frame) -> None:
        prev = self._prev_handlers.get(signum)
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)
        if self._exit_after:
            raise SystemExit(128 + signum)

    def defer_save(self) -> None:
        """Called by a trainer whose ``save_state`` the preemption hook
        reached mid-step: the hook then leaves the chaining (and the
        exit) to :meth:`deferred_save_done`, which the trainer calls once
        the step is whole and saved."""
        self._save_deferred = True

    def deferred_save_done(self) -> None:
        """Finish a signal whose save was deferred: chain to the previous
        handler and exit if the hook was installed with ``exit_after``.
        A no-op when nothing is pending."""
        pending, self._pending_signal = self._pending_signal, None
        self._save_deferred = False
        if pending is not None:
            self._after_signal(*pending)

    def uninstall_preemption_hook(self) -> None:
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()

    # ------------------------------------------------------------------
    # Model-level convenience (FeedForward / Module surface)
    # ------------------------------------------------------------------

    def save_model(self, step: int, symbol, arg_params: Dict[str, Any],
                   aux_params: Optional[Dict[str, Any]] = None,
                   meta: Optional[Dict[str, Any]] = None,
                   extra_arrays: Optional[Dict[str, Any]] = None,
                   blocking: Optional[bool] = None) -> str:
        """Save a Symbol + params the way ``model.save_checkpoint`` does,
        but atomic and async.  The symbol JSON rides in the manifest
        meta, so one checkpoint dir is self-contained.  ``extra_arrays``
        (unprefixed names) carries side state like Module optimizer
        blobs."""
        arrays = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
        arrays.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
        arrays.update(extra_arrays or {})
        meta = dict(meta or {})
        if symbol is not None:
            meta["symbol_json"] = symbol.tojson()
        return self.save(step, arrays, meta=meta, blocking=blocking)

    def load_model(self, step: Optional[int] = None):
        """Inverse of :meth:`save_model`: returns ``(symbol, arg_params,
        aux_params, step)`` with host NDArray params (the load_checkpoint
        contract)."""
        from .. import symbol as sym_mod
        from ..context import cpu
        from ..model import split_param_dict
        from ..ndarray import array as nd_array
        arrays, meta, step = self.restore(step)
        symbol = (sym_mod.load_json(meta["symbol_json"])
                  if "symbol_json" in meta else None)
        # unprefixed names are side state (e.g. Module optimizer blobs),
        # not parameters — load those explicitly via restore()/load_arrays
        nds = {k: nd_array(v, ctx=cpu()) for k, v in arrays.items()
               if k.startswith(("arg:", "aux:"))}
        arg_params, aux_params = split_param_dict(nds)
        return symbol, arg_params, aux_params, step

    def close(self) -> None:
        self._writer.close()
        self.uninstall_preemption_hook()
