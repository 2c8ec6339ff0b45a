"""Async checkpoint writer: snapshot -> staging dir -> atomic rename.

Counterpart of ``mxnet_tpu/checkpoint/writer.py``.  A save is split at
the device/host boundary so only the cheap half stalls the step loop:

1. :func:`snapshot` runs on the CALLING thread.  Every tensor on the card
   is copied into a pinned host buffer with ``non_blocking=True``, all of
   them queued on the current stream, and then ONE stream synchronize
   waits for them: the only synchronizing call a save makes.  The copy
   must be complete before ``save`` returns, because the trainer's fused
   update (K2) writes weights and moments in place: the next step would
   overwrite what is being saved.  Host values (CPU tensors, NDArrays on
   the CPU, numpy arrays) are copied, never aliased.  bfloat16 has no
   numpy dtype string here (no ``ml_dtypes``), so a bfloat16 array is
   refused with its name; the trainer's state is float32, int32 and
   uint32 only.
2. :class:`AsyncCheckpointWriter` serializes, checksums, writes, fsyncs
   and commits on a background thread, overlapping the following steps.

Commit protocol: all shard files then the manifest are written into
``<root>/.tmp-step-N-pid``, each fsynced, and the directory is moved into
place with ``os.replace`` -- readers see a complete checkpoint or none.
A process killed mid-write leaves only a staging dir, which discovery
(:func:`layout.committed_steps`) ignores and the next writer sweeps.
One device holds every array whole, so each array is one shard
(``<array>.00.bin``), as the JAX package writes an unsharded one.

Over a mesh that spans processes (:func:`write_process_checkpoint`) each
process writes the pieces it is the first to hold, named
``<array>.<shard>.p<process>.bin`` (``layout.shard_file_name``), into
one staging directory that process 0 makes; after every process has
written, process 0 writes the manifest of all their pieces, with
``process_count``, and commits the directory.
"""
from __future__ import annotations

import logging
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import telemetry
from ..base import MXNetError
from . import layout

__all__ = ["snapshot", "write_checkpoint", "write_process_checkpoint",
           "AsyncCheckpointWriter", "gc_checkpoints", "sweep_staging"]


def snapshot(arrays: Dict[str, Any]) -> Dict[str, List[Tuple]]:
    """Device -> host snapshot of ``{name: array}`` (tensors, NDArrays or
    numpy arrays): ``{name: [(None, host numpy array)]}``.  Returns only
    when every copy from the card has landed."""
    import torch
    from ..ndarray import NDArray
    with telemetry.span("ckpt.snapshot", arrays=len(arrays)):
        staged = {}
        on_card = False
        for name, v in arrays.items():
            if isinstance(v, NDArray):
                v = v.data
            if isinstance(v, torch.Tensor):
                v = v.detach()
                if v.dtype == torch.bfloat16:
                    raise MXNetError(
                        f"checkpoint snapshot: array {name!r} is bfloat16, "
                        "which has no numpy dtype string; save it as "
                        "float32")
                if v.device.type == "cuda":
                    buf = torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=True)
                    buf.copy_(v, non_blocking=True)
                    on_card = True
                else:
                    buf = v.clone()
                staged[name] = buf
            else:
                # np.asarray would alias a host array the next step may
                # write: a snapshot copies
                staged[name] = np.array(v, copy=True)
        if on_card:
            # the one synchronizing call of a save: every copy above was
            # queued on this stream
            torch.cuda.current_stream().synchronize()
        return {name: [(None, v.numpy() if isinstance(v, torch.Tensor)
                        else v)] for name, v in staged.items()}


def _write_shard(staging: str, fname: str, host: np.ndarray) -> Tuple:
    """One shard's raw C-contiguous bytes into ``staging/fname``,
    fsynced: ``(nbytes, checksum)``."""
    payload = np.ascontiguousarray(host).tobytes()
    with open(os.path.join(staging, fname), "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    return len(payload), layout.checksum_bytes(payload)


def write_checkpoint(root: str, step: int, snap: Dict[str, List[Tuple]],
                     meta: Optional[Dict[str, Any]] = None,
                     process_index: int = 0, process_count: int = 1) -> str:
    """Write a snapshot into a staging dir and atomically commit it.
    Returns the committed path.  Pure host code, safe on any thread."""
    final = layout.step_path(root, step)
    staging = layout.staging_path(root, step)
    if os.path.exists(staging):
        shutil.rmtree(staging)
    os.makedirs(staging)
    written = 0
    with telemetry.span("ckpt.write", step=step, arrays=len(snap)):
        try:
            entries: Dict[str, Any] = {}
            for ai, (name, leaves) in enumerate(sorted(snap.items())):
                shards = []
                shape = dtype_str = None
                for si, (index, host) in enumerate(leaves):
                    if index is None:
                        index = [[0, int(d)] for d in host.shape]
                        shape, dtype_str = list(host.shape), host.dtype.str
                    fname = layout.shard_file_name(ai, si, process_index)
                    nbytes, crc = _write_shard(staging, fname, host)
                    written += nbytes
                    shards.append({"file": fname,
                                   "index": index,
                                   "nbytes": nbytes,
                                   "checksum": crc})
                if shape is None:
                    # sharded leaves: global shape = max stop per dim
                    shape = [max(s["index"][d][1] for s in shards)
                             for d in range(len(shards[0]["index"]))]
                    dtype_str = np.dtype(leaves[0][1].dtype).str
                entries[name] = layout.make_array_entry(shape, dtype_str,
                                                        shards)
            # manifest last: its presence is the commit marker inside the dir
            layout.write_manifest(staging, step, entries, meta=meta,
                                  process_count=process_count)
            if os.path.exists(final):
                shutil.rmtree(final)  # overwrite a same-step checkpoint
            os.replace(staging, final)
        except BaseException:
            telemetry.counter("ckpt.write_errors").inc()
            shutil.rmtree(staging, ignore_errors=True)
            raise
        # make the rename itself durable
        dirfd = os.open(root, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    telemetry.counter("ckpt.saves").inc()
    telemetry.counter("ckpt.bytes").inc(written)
    return final


def write_process_checkpoint(root: str, step: int,
                             shards: Dict[str, Tuple[Sequence[int], list]],
                             meta: Optional[Dict[str, Any]], exchange,
                             process_index: int, process_count: int) -> str:
    """One process's part of a checkpoint that several processes write,
    every process calling at once.  ``shards`` maps every array name to
    ``(global shape, [(index, host array)])``: the pieces this process
    writes (``index`` ``[[start, stop], ...]``, None for the whole
    array; an empty list where other processes write it).
    ``exchange(obj)`` gathers an object from every process, in process
    order.  Process 0 makes the staging directory, writes the manifest of
    every process's pieces and commits it; every process returns the
    committed path once the commit is done, or raises if any part
    failed."""
    final = layout.step_path(root, step)
    staging = None
    # every process is here, its manager made (which sweeps the staging
    # directories of other writers), before process 0 makes its own
    exchange(None)
    if process_index == 0:
        staging = layout.staging_path(root, step)
        if os.path.exists(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
    staging = exchange(staging)[0]
    entries: Dict[str, Any] = {}
    error = None
    written = 0
    with telemetry.span("ckpt.write", step=step, arrays=len(shards)):
        try:
            for ai, name in enumerate(sorted(shards)):
                shape, pieces = shards[name]
                out = []
                for si, (index, host) in enumerate(pieces):
                    if index is None:
                        index = [[0, int(d)] for d in shape]
                    fname = layout.shard_file_name(ai, si, process_index)
                    nbytes, crc = _write_shard(staging, fname, host)
                    written += nbytes
                    out.append({"file": fname, "index": index,
                                "nbytes": nbytes, "checksum": crc,
                                "dtype": np.dtype(host.dtype).str})
                entries[name] = out
        except Exception as exc:    # the others must hear of it
            error = f"process {process_index}: {exc!r}"
        parts = exchange((entries, error))
        errors = [e for _, e in parts if e is not None]
        if process_index == 0 and not errors:
            try:
                arrays = {}
                for name in sorted(shards):
                    got = [sh for ent, _ in parts for sh in ent[name]]
                    dtype = got[0].pop("dtype")
                    for sh in got[1:]:
                        sh.pop("dtype")
                    arrays[name] = layout.make_array_entry(
                        shards[name][0], dtype, got)
                layout.write_manifest(staging, step, arrays, meta=meta,
                                      process_count=process_count)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(staging, final)
                dirfd = os.open(root, os.O_RDONLY)
                try:
                    os.fsync(dirfd)
                finally:
                    os.close(dirfd)
            except Exception as exc:
                errors.append(f"process 0's commit: {exc!r}")
        if process_index == 0 and errors:
            shutil.rmtree(staging, ignore_errors=True)
        committed = exchange(errors if process_index == 0 else None)[0]
    if committed:
        telemetry.counter("ckpt.write_errors").inc()
        raise MXNetError(f"checkpoint step {step} over {process_count} "
                         f"processes failed: {committed}")
    telemetry.counter("ckpt.saves").inc()
    telemetry.counter("ckpt.bytes").inc(written)
    return final


def gc_checkpoints(root: str, keep_last: int = 3,
                   keep_every: Optional[int] = None,
                   logger=None) -> List[int]:
    """Retention: keep the newest ``keep_last`` steps plus every step
    divisible by ``keep_every`` (permanent milestones); delete the rest.
    Returns the deleted steps."""
    steps = layout.committed_steps(root)
    if keep_last < 1:
        raise MXNetError("keep_last must be >= 1")
    keep = set(steps[-keep_last:])
    if keep_every:
        keep.update(s for s in steps if s % int(keep_every) == 0)
    deleted = []
    for s in steps:
        if s not in keep:
            shutil.rmtree(layout.step_path(root, s), ignore_errors=True)
            deleted.append(s)
    if deleted and logger:
        logger.info("checkpoint GC: removed steps %s (kept %s)", deleted,
                    sorted(keep))
    return deleted


def sweep_staging(root: str) -> List[str]:
    """Remove leftover staging dirs from crashed writers (never this
    process's own in-flight dir — staging names embed the pid)."""
    me = f"-{os.getpid()}"
    swept = []
    for path in layout.staging_dirs(root):
        if path.endswith(me):
            continue
        shutil.rmtree(path, ignore_errors=True)
        swept.append(path)
    return swept


class AsyncCheckpointWriter:
    """Single background thread that drains a queue of snapshot-write
    jobs.  One writer per manager: saves commit in submission order, and
    ``wait_until_finished`` is the barrier the preemption hook and tests
    use.  Errors from the worker are re-raised on the next submit/wait
    (same propagation contract as DevicePrefetchIter)."""

    def __init__(self, logger=None):
        self.logger = logger or logging.getLogger(__name__)
        self._queue: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._pending = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="ckpt-writer")
            self._thread.start()

    def _worker(self):
        telemetry.name_thread("ckpt-writer")
        while True:
            job = self._queue.get()
            if job is None:
                return
            fn = job
            try:
                fn()
            except BaseException as exc:
                with self._lock:
                    self._error = exc
                self.logger.error("async checkpoint write failed: %r", exc)
            finally:
                with self._lock:
                    self._pending -= 1
                    self._idle.notify_all()

    def _raise_pending_error(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise MXNetError(
                f"a previous async checkpoint write failed: {err!r}") from err

    def submit(self, fn) -> None:
        """Enqueue ``fn`` (a zero-arg write job) for the worker."""
        self._raise_pending_error()
        self._ensure_thread()
        with self._lock:
            self._pending += 1
        self._queue.put(fn)

    def wait_until_finished(self) -> None:
        """Block until every submitted write committed; re-raise the first
        worker error if one occurred."""
        with self._lock:
            while self._pending:
                self._idle.wait()
        self._raise_pending_error()

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._pending

    def close(self) -> None:
        self.wait_until_finished()
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=5.0)
            self._thread = None
