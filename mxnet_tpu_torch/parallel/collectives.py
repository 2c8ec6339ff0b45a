"""Gradient bucketing: the bucket plan the fused update streams over.

Counterpart of the bucket-planning part of
``mxnet_tpu/parallel/collectives.py`` (``plan_buckets``,
``DEFAULT_BUCKET_BYTES``).  The collectives themselves come with the
multi-GPU slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = ["DEFAULT_BUCKET_BYTES", "plan_buckets"]

DEFAULT_BUCKET_BYTES = 4 << 20  # ~4 MiB, the classic DDP default


def plan_buckets(elem_counts: Sequence[int], itemsize: int,
                 bucket_bytes: int) -> List[List[Tuple[int, int, int]]]:
    """Slice tensors (given in dispatch order) into flat buckets.

    Returns a list of buckets; each bucket is a list of
    ``(tensor_index, start_elem, stop_elem)`` pieces.  Tensors straddling
    a bucket boundary are split, so the plan always has exactly
    ``ceil(total_elems / elems_per_bucket)`` buckets, and the buckets in
    order tile the concatenation of the tensors.
    """
    elems_per_bucket = max(1, int(bucket_bytes) // max(1, itemsize))
    buckets: List[List[Tuple[int, int, int]]] = []
    cur: List[Tuple[int, int, int]] = []
    cur_elems = 0
    for idx, n in enumerate(elem_counts):
        start = 0
        while start < n:
            take = min(n - start, elems_per_bucket - cur_elems)
            cur.append((idx, start, start + take))
            cur_elems += take
            start += take
            if cur_elems == elems_per_bucket:
                buckets.append(cur)
                cur, cur_elems = [], 0
    if cur:
        buckets.append(cur)
    return buckets
