"""Bucket ladders for dynamic shapes.

Counterpart of ``BucketPolicy`` and ``bucket_for`` in
``mxnet_tpu/compile_cache.py``.  PyTorch runs eagerly, so the port keeps no
executable store; the serve engine still pads prompts to the geometric
ladder and decode batches to fixed buckets, so every step has one of a
few shapes; :func:`pad_to_bucket` pads one host array to its bucket
(``io.pad_batch_to_bucket``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .base import MXNetError

__all__ = ["BucketPolicy", "bucket_for", "pad_to_bucket"]


def _round_up(x: int, to: int) -> int:
    return -(-int(x) // int(to)) * int(to)


class BucketPolicy:
    """Geometric padded-bucket ladder: starts at ``min_bucket``, multiplies
    by ``factor``, each rung rounded up to a multiple of ``round_to``.
    ``buckets=[...]`` pins an explicit set instead."""

    def __init__(self, min_bucket: int = 16, factor: float = 2.0,
                 round_to: int = 16, buckets: Optional[Sequence[int]] = None):
        if factor <= 1.0:
            raise MXNetError(f"BucketPolicy factor must be > 1, got {factor}")
        if min_bucket < 1 or round_to < 1:
            raise MXNetError("BucketPolicy min_bucket/round_to must be >= 1")
        self.min_bucket = int(min_bucket)
        self.factor = float(factor)
        self.round_to = int(round_to)
        self.buckets = sorted(int(b) for b in buckets) if buckets else None

    @classmethod
    def fixed(cls, size: int) -> "BucketPolicy":
        """A single-rung policy: every length pads to ``size``."""
        if size < 1:
            raise MXNetError(f"BucketPolicy.fixed: size must be >= 1, "
                             f"got {size}")
        return cls(min_bucket=int(size), round_to=1, buckets=[int(size)])

    def _ladder(self, upto: int) -> List[int]:
        rungs = [_round_up(self.min_bucket, self.round_to)]
        while rungs[-1] < upto:
            nxt = _round_up(max(rungs[-1] + 1,
                                int(rungs[-1] * self.factor)), self.round_to)
            rungs.append(nxt)
        return rungs


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length from an explicit set."""
    for b in sorted(buckets):
        if b >= length:
            return int(b)
    raise MXNetError(
        f"length {length} exceeds the largest bucket {max(buckets)}")


def pad_to_bucket(arr, bucket: int, axis: int = 1, pad_value=0):
    """Pad one array along ``axis`` up to ``bucket`` (host numpy in,
    host numpy out; no-op when already at the bucket size)."""
    a = np.asarray(arr)
    if axis >= a.ndim:
        raise MXNetError(
            f"pad_to_bucket: axis {axis} out of range for shape {a.shape}")
    cur = a.shape[axis]
    if cur > bucket:
        raise MXNetError(
            f"pad_to_bucket: length {cur} exceeds bucket {bucket}")
    if cur == bucket:
        return a
    cfg = [(0, 0)] * a.ndim
    cfg[axis] = (0, bucket - cur)
    return np.pad(a, cfg, constant_values=pad_value)
