# coding: utf-8
"""Deterministic fault injection: the chaos spec and its environment.

Counterpart of the spec half of ``mxnet_tpu/chaos.py`` (host code, kept
as a copy so the port imports nothing of the JAX package).  Injection
points are positional and deterministic, so a failure reproduces bit for
bit across runs.

Spec syntax (``MXNET_TPU_CHAOS`` or :meth:`ChaosSpec.parse`)::

    kind:idx[,idx...][|kind:idx...]     e.g.  "serve_crash:4|serve_hang:7"

Every kind of the JAX package parses.  Data kinds (``nan``,
``overflow``, ``crash``) are consumed by :class:`ChaosIter`, which
``ShardedTrainer.fit`` wraps around its training iterator (upstream of
the prefetch thread) when ``MXNET_TPU_CHAOS`` is set
(:func:`maybe_wrap`): ``nan``/``overflow`` poison a batch's data at a
global batch index, ``crash`` raises :class:`ChaosError` before the inner
``next()``, so a prefetch retry pulls the next batch and none is lost.

Serve kinds, consumed by :class:`mxnet_tpu_torch.serve.engine.Engine` at
exact step indices: ``serve_crash`` (the replica's step raises
:class:`ChaosError` — process death), ``serve_hang`` (the step wedges
permanently: no progress, no heartbeat — only the router's timeout gets
the requests out), ``serve_poison_logits`` (one step runs on NaN-filled
weights; the engine's finite check must catch it).  With several router
replicas, ``MXNET_TPU_CHAOS_REPLICA`` picks which replica the spec
applies to (default 0).

Elastic-training kinds (``worker_kill``, ``partition``) parse and filter
(:func:`elastic_from_env`, ``MXNET_TPU_CHAOS_WORKER``); their consumer,
the multi-process membership harness, belongs to the port's multi-GPU
slice.

On-disk corruption helpers for the tolerant RecordIO reader's tests:
:func:`flip_byte`, :func:`record_offsets` and :func:`corrupt_record`.
"""
from __future__ import annotations

import copy
import logging
import os
import struct
from typing import Dict, Optional, Set

import numpy as np
import torch

__all__ = ["KINDS", "SERVE_KINDS", "ELASTIC_KINDS", "OVERFLOW_VALUE",
           "ChaosError", "ChaosSpec", "ChaosIter", "from_env",
           "serve_from_env", "elastic_from_env", "chaos_replica",
           "chaos_worker", "maybe_wrap", "flip_byte", "record_offsets",
           "corrupt_record"]

_LOGGER = logging.getLogger(__name__)

KINDS = ("nan", "overflow", "crash")
SERVE_KINDS = ("serve_crash", "serve_hang", "serve_poison_logits")
ELASTIC_KINDS = ("worker_kill", "partition")

OVERFLOW_VALUE = 1e30  # squares past f32 max, flushes f16/bf16 to inf


class ChaosError(RuntimeError):
    """The injected failure (distinguishable from real ones)."""


class ChaosSpec(object):
    def __init__(self, points: Dict[str, Set[int]]):
        known = KINDS + SERVE_KINDS + ELASTIC_KINDS
        for kind in points:
            if kind not in known:
                raise ValueError("unknown chaos kind %r (know %s)"
                                 % (kind, ", ".join(known)))
        self.points = {k: set(v) for k, v in points.items() if v}

    def __bool__(self) -> bool:
        return bool(self.points)

    def at(self, kind: str, index: int) -> bool:
        return index in self.points.get(kind, ())

    @classmethod
    def parse(cls, spec: str) -> "ChaosSpec":
        points: Dict[str, Set[int]] = {}
        for part in spec.split("|"):
            part = part.strip()
            if not part:
                continue
            try:
                kind, idxs = part.split(":", 1)
            except ValueError:
                raise ValueError("bad chaos spec %r (want kind:i,j|...)"
                                 % spec)
            points.setdefault(kind.strip(), set()).update(
                int(i) for i in idxs.split(",") if i.strip())
        return cls(points)


def from_env() -> Optional[ChaosSpec]:
    raw = os.environ.get("MXNET_TPU_CHAOS")
    if not raw or not raw.strip():
        return None
    spec = ChaosSpec.parse(raw)
    return spec if spec else None


def _slice_from_env(kinds) -> Optional[ChaosSpec]:
    spec = from_env()
    if spec is None:
        return None
    points = {k: v for k, v in spec.points.items() if k in kinds}
    return ChaosSpec(points) if points else None


def serve_from_env() -> Optional[ChaosSpec]:
    """The serve-side slice of ``MXNET_TPU_CHAOS`` (``serve_*`` kinds
    only), or ``None``: a mixed spec feeds every consumer without any of
    them seeing another's points."""
    return _slice_from_env(SERVE_KINDS)


def elastic_from_env() -> Optional[ChaosSpec]:
    """The elastic-training slice of ``MXNET_TPU_CHAOS`` (``worker_kill``
    / ``partition`` only), or ``None`` — :func:`serve_from_env`'s
    contract."""
    return _slice_from_env(ELASTIC_KINDS)


def chaos_replica() -> int:
    """Which router replica ``MXNET_TPU_CHAOS`` targets (default 0)."""
    raw = os.environ.get("MXNET_TPU_CHAOS_REPLICA", "").strip()
    return int(raw) if raw else 0


def chaos_worker() -> int:
    """Which worker id the elastic kinds target (default 1 — worker 0 is
    the trainer, whose loss is a preemption, not a membership change)."""
    raw = os.environ.get("MXNET_TPU_CHAOS_WORKER", "").strip()
    return int(raw) if raw else 1


def _poison_array(arr, value: float):
    """A same-shape, same-dtype, same-device array filled with ``value``
    (an NDArray, tensor or numpy array in, the same kind out)."""
    from .ndarray import NDArray
    if isinstance(arr, NDArray):
        return NDArray(torch.full_like(arr.data, value), ctx=arr.context)
    if isinstance(arr, torch.Tensor):
        return torch.full_like(arr, value)
    data = np.asarray(arr)
    return np.full(data.shape, value, dtype=data.dtype)


def _is_integral(v) -> bool:
    from .ndarray import NDArray
    if isinstance(v, NDArray):
        v = v.data
    if isinstance(v, torch.Tensor):
        return not (v.dtype.is_floating_point or v.dtype.is_complex)
    return np.asarray(v).dtype.kind in "iub"


class ChaosIter(object):
    """Iterator wrapper injecting faults at fixed global batch indices.

    Poisoning replaces every array of ``batch.data`` (a ``DataBatch``) or
    every float-typed value of a dict batch; labels are left alone
    (integer and bool values of a dict batch are skipped) so the metric
    code stays exercised.  ``injected`` counts firings per kind; the
    global batch index is not reset by :meth:`reset`."""

    def __init__(self, data_iter, spec: ChaosSpec, logger=None):
        self._iter = data_iter
        self.spec = spec
        self.logger = logger or _LOGGER
        self._count = 0  # global batch index; NOT reset by reset()
        self.injected = {k: 0 for k in KINDS}

    # -- the DataIter surface: delegate what is not intercepted --
    def __getattr__(self, name):
        return getattr(self._iter, name)

    def __iter__(self):
        return self

    def reset(self):
        self._iter.reset()

    def _fire(self, kind: str, index: int):
        self.injected[kind] += 1
        self.logger.warning("chaos: injecting %s at global batch %d",
                            kind, index)

    def _poison_batch(self, batch, value: float):
        if isinstance(batch, dict):
            return {k: (v if _is_integral(v) else _poison_array(v, value))
                    for k, v in batch.items()}
        if hasattr(batch, "data"):  # DataBatch
            out = copy.copy(batch)
            out.data = [_poison_array(d, value) for d in batch.data]
            return out
        return _poison_array(batch, value)

    def next(self):
        i = self._count
        self._count += 1
        if self.spec.at("crash", i):
            self._fire("crash", i)
            raise ChaosError("chaos: injected pipeline crash at global "
                             "batch %d" % i)
        batch = self._iter.next()
        if self.spec.at("nan", i):
            self._fire("nan", i)
            batch = self._poison_batch(batch, float("nan"))
        elif self.spec.at("overflow", i):
            self._fire("overflow", i)
            batch = self._poison_batch(batch, OVERFLOW_VALUE)
        return batch

    def __next__(self):
        return self.next()


def maybe_wrap(data_iter, logger=None):
    """Wrap ``data_iter`` in a :class:`ChaosIter` when ``MXNET_TPU_CHAOS``
    sets any point; otherwise return it unchanged."""
    spec = from_env()
    if spec is None or isinstance(data_iter, ChaosIter):
        return data_iter
    return ChaosIter(data_iter, spec, logger=logger)


# --------------------------------------------------------------------
# On-disk corruption helpers (RecordIO tolerant-reader tests)
# --------------------------------------------------------------------

def flip_byte(path: str, offset: int, mask: int = 0xFF) -> int:
    """XOR the byte at ``offset`` with ``mask``; returns the old value."""
    with open(path, "r+b") as f:
        f.seek(offset)
        old = f.read(1)
        if len(old) != 1:
            raise ValueError("offset %d past end of %s" % (offset, path))
        f.seek(offset)
        f.write(bytes([old[0] ^ (mask & 0xFF)]))
    return old[0]


def record_offsets(path: str):
    """Byte offsets of every top-level record header in a RecordIO
    pack file (walks the framing without decoding payloads)."""
    from .recordio import _MAGIC, _LEN_MASK
    offsets = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        in_multi = False
        while pos + 8 <= size:
            f.seek(pos)
            header = f.read(8)
            magic, lrec = struct.unpack("<II", header)
            if magic != _MAGIC:
                raise ValueError("%s: bad magic at %d (already corrupt?)"
                                 % (path, pos))
            cflag = lrec >> 29
            length = lrec & _LEN_MASK
            if not in_multi:
                offsets.append(pos)
            in_multi = cflag in (1, 2)
            pos += 8 + length + ((-length) % 4)
    return offsets


def corrupt_record(path: str, record_index: int) -> int:
    """Bit-flip the magic of the ``record_index``-th record so a reader
    hits a framing error there; returns the corrupted byte offset."""
    off = record_offsets(path)[record_index]
    flip_byte(path, off, 0x01)
    return off
