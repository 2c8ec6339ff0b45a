# coding: utf-8
"""Deterministic fault injection: the chaos spec and its environment.

Counterpart of the spec half of ``mxnet_tpu/chaos.py`` (host code, kept
as a copy so the port imports nothing of the JAX package).  Injection
points are positional and deterministic, so a failure reproduces bit for
bit across runs.

Spec syntax (``MXNET_TPU_CHAOS`` or :meth:`ChaosSpec.parse`)::

    kind:idx[,idx...][|kind:idx...]     e.g.  "serve_crash:4|serve_hang:7"

Every kind of the JAX package parses.  Data kinds (``nan``,
``overflow``, ``crash``) are consumed by the JAX package's ``ChaosIter``,
which the port does not have yet.

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
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Set

__all__ = ["KINDS", "SERVE_KINDS", "ELASTIC_KINDS", "OVERFLOW_VALUE",
           "ChaosError", "ChaosSpec", "from_env", "serve_from_env",
           "elastic_from_env", "chaos_replica", "chaos_worker"]

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
