"""Collectives over per-member tensors: bucketed, prioritised and
optionally compressed all-reduce.

Counterpart of ``mxnet_tpu/parallel/collectives.py``.  The JAX package
forms a global array whose shards are the per-device values and runs one
``shard_map``/``psum`` program a bucket; here a reduction takes one tensor
a mesh member (members are contexts: :func:`member_of`) and returns one a
member:

* members on **distinct CUDA devices** sum through NCCL within the process
  (``torch.cuda.nccl.all_reduce``, in place on a private copy of each
  member's buffer, on each device's current stream);
* members on **distinct contexts of the CPU** (``cpu(0)`` ... ``cpu(7)``,
  one torch device: the CPU tests' counterpart of the JAX tests' virtual
  devices) take the same bucketed branch with a copy as the transport:
  the pieces are summed in member order on the first member's device
  (bf16/f16 in f32, rounded once, as XLA's all-reduce sums them);
* members that are **not distinct** (two arrays on one context) take the
  JAX package's co-resident tree sum: no buckets, no compression.

Along one axis of a 2-D mesh (the members that share every other
coordinate: ``mesh.axis_groups``), :func:`psum`, :func:`pmax`,
:func:`all_gather` and :func:`reduce_scatter` run over each group
(:func:`over_axis`); given ``axis=`` a call is counted by
:func:`count_collectives` under that axis (``CollectiveStats.by_axis``).
Between distinct cards each group reduces through NCCL on a communicator
of its own devices (``torch.cuda.nccl`` keeps one per device set).
Across processes (``dist.init_distributed``), :func:`allreduce_processes`
sums through the process group, or the group of some of the processes;
every value that crosses processes is counted by :func:`count_collectives`
as kind ``"process"`` along the axis it crosses
(:func:`record_process_call`).

Gradient fusion: :func:`allreduce_sum`/:func:`allreduce_mean` take a list
of gradient groups (one tensor a member each), lay them end to end in
priority order (higher ``priority`` first, ties in submission order),
split them into ~``bucket_bytes`` flat buckets per dtype class
(:func:`plan_buckets`) and reduce one bucket at a time: exactly
``ceil(total_bytes / bucket_bytes)`` reductions per dtype class, each
recorded by :func:`count_collectives` with the JAX package's record keys.

Each reduction of :func:`psum` over several members and each bucket of
:func:`allreduce_processes` leaves a ``reduce`` collective note for the
program auditor (``analysis.program.note_kernel``; nothing when no
recording is active), whose wire rows read the payload's width.

:func:`psum_compressed` is the JAX function's reduction over the members'
tensors: ``"int8"`` (one f32 scale a 128-element block shared by every
member: the max of the members' block absmax; round half to even of
``y / scale`` onto [-127, 127], summed on int32 lanes), ``"fp8"`` (e4m3
payload pinned to 448 at the block absmax, summed on f32 lanes) and
``"bf16"``, with an optional error-feedback residual a member that
returns the quantization error each member just committed.  Non-float
inputs take the plain sum.  Over members of several processes
(``gather=``) each process sends its members' payloads in the wire
format, and every process sums every member's in member order: the
result is bitwise the one-process sum.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import program as _program
from ..base import MXNetError
from ..context import Context, as_context
from .. import quant

__all__ = ["allreduce_sum", "allreduce_mean", "distinct_devices",
           "psum_compressed", "count_collectives", "CollectiveStats",
           "DEFAULT_BUCKET_BYTES", "COMPRESSIONS", "plan_buckets",
           "check_compression", "member_of", "psum", "pmax", "all_gather",
           "reduce_scatter", "over_axis", "allreduce_processes",
           "record_process_call"]

DEFAULT_BUCKET_BYTES = 4 << 20  # ~4 MiB, the classic DDP default
COMPRESSIONS = (None, "int8", "bf16", "fp8")
_NCCL_MAX = 2                   # ncclMax in ncclRedOp_t


def check_compression(compression: Optional[str]) -> Optional[str]:
    if compression not in COMPRESSIONS:
        raise MXNetError(f"unknown compression {compression!r}; "
                         f"expected one of {COMPRESSIONS}")
    return compression


def member_of(a) -> Context:
    """The context a value belongs to: an NDArray's context, or the
    context of a tensor's device (every CPU tensor is ``cpu(0)``)."""
    ctx = getattr(a, "context", None)
    if isinstance(ctx, Context):
        return ctx
    return as_context(a.device)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else a.data


def distinct_devices(arrays: Sequence) -> bool:
    """True when each value belongs to its own context."""
    seen = set()
    for a in arrays:
        m = member_of(a)
        if m in seen:
            return False
        seen.add(m)
    return True


# ---------------------------------------------------------------------------
# counting hook: how many reductions a call dispatched, and how big

_dispatch_hooks: List[Callable[[dict], None]] = []
_hook_lock = threading.Lock()


class CollectiveStats:
    """Record of reductions seen inside a :func:`count_collectives`
    scope."""

    def __init__(self):
        self.records: List[dict] = []

    def _record(self, rec: dict) -> None:
        self.records.append(rec)

    @property
    def count(self) -> int:
        return len(self.records)

    @property
    def total_bytes(self) -> int:
        return sum(r["nbytes"] for r in self.records)

    def by_axis(self) -> dict:
        """``{axis: reductions}`` over the records of calls made along a
        named mesh axis (:func:`over_axis` and the trainer's meetings)."""
        out: dict = {}
        for r in self.records:
            if r.get("axis") is not None:
                out[r["axis"]] = out.get(r["axis"], 0) + 1
        return out

    @property
    def total_wire_bytes(self) -> int:
        """Bytes that cross between members (compressed width)."""
        return sum(r.get("wire_nbytes", r["nbytes"]) for r in self.records)

    def __repr__(self):
        return f"CollectiveStats(count={self.count}, bytes={self.total_bytes})"


@contextlib.contextmanager
def count_collectives():
    """``with count_collectives() as stats: ...`` counts every reduction
    this module dispatches (one a bucket, one a co-resident group)."""
    stats = CollectiveStats()
    with _hook_lock:
        _dispatch_hooks.append(stats._record)
    try:
        yield stats
    finally:
        with _hook_lock:
            _dispatch_hooks.remove(stats._record)


def _emit(rec: dict) -> None:
    from .. import telemetry
    telemetry.counter("collectives.dispatches").inc()
    nbytes = rec.get("nbytes", 0)
    telemetry.counter("collectives.bytes").inc(nbytes)
    telemetry.counter("collectives.wire_bytes").inc(
        rec.get("wire_nbytes", nbytes))
    if _dispatch_hooks:
        with _hook_lock:
            hooks = list(_dispatch_hooks)
        for h in hooks:
            h(rec)


# ---------------------------------------------------------------------------
# the transport: a sum (or max) over one tensor a member

def _on_distinct_cards(parts: Sequence[torch.Tensor]) -> bool:
    devs = [p.device for p in parts]
    return (len(parts) > 1 and all(d.type == "cuda" for d in devs)
            and len({d.index for d in devs}) == len(devs))


def _nccl(parts: Sequence[torch.Tensor], op: int) -> List[torch.Tensor]:
    """NCCL all-reduce of one tensor a card, in place on private copies
    (the inputs may be views of buffers the caller keeps)."""
    from torch.cuda import nccl
    outs = [p.contiguous().clone() for p in parts]
    nccl.all_reduce(outs, op=op)
    return outs


def record_axis_call(kind: str, axis: str, t: torch.Tensor,
                     members: int) -> None:
    """Count one call of ``kind`` over a group of ``members`` along mesh
    ``axis`` (``CollectiveStats.by_axis``)."""
    nbytes = t.numel() * t.element_size()
    _emit({"nbytes": nbytes, "wire_nbytes": nbytes, "num_pieces": members,
           "tensor_indices": [], "dtype": _dtype_name(t.dtype),
           "compression": None, "mean": False, "kind": kind, "axis": axis})


def record_process_call(axis: Optional[str], what,
                        processes: int) -> None:
    """Count one exchange between ``processes`` processes along mesh
    ``axis`` (kind ``"process"`` in :func:`count_collectives`' records):
    ``what`` is the tensor sent in its wire format, or its byte
    count."""
    if isinstance(what, torch.Tensor):
        dtype = _dtype_name(what.dtype)
        what = what.numel() * what.element_size()
    else:
        dtype = None
    _emit({"nbytes": int(what), "wire_nbytes": int(what),
           "num_pieces": processes, "tensor_indices": [], "dtype": dtype,
           "compression": None, "mean": False, "kind": "process",
           "axis": axis})


def psum(parts: Sequence[torch.Tensor],
         axis: Optional[str] = None) -> List[torch.Tensor]:
    """The sum of one tensor a member, one result a member on its
    member's device.  Distinct cards reduce through NCCL; otherwise the
    parts are summed in member order on the first part's device.  With
    ``axis`` (the mesh axis the members differ along) the call is
    counted by :func:`count_collectives`."""
    parts = list(parts)
    if axis is not None:
        record_axis_call("psum", axis, parts[0], len(parts))
    if len(parts) == 1:
        return parts
    # the program auditor's reduce collective: its wire rows (both
    # branches, NCCL and the summing loop)
    _program.note_kernel("psum", reads=parts, collective="reduce")
    if _on_distinct_cards(parts):
        return _nccl(parts, 0)
    # half-width floats accumulate in float32 and round once, as XLA's
    # all-reduce does
    wide = parts[0].dtype in (torch.bfloat16, torch.float16)
    acc = parts[0].float() if wide else parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device, acc.dtype)
    if wide:
        acc = acc.to(parts[0].dtype)
    return [acc if acc.device == p.device else acc.to(p.device)
            for p in parts]


def pmax(parts: Sequence[torch.Tensor],
         axis: Optional[str] = None) -> List[torch.Tensor]:
    """The elementwise max of one tensor a member, one result a member
    (counted along ``axis`` as :func:`psum`)."""
    parts = list(parts)
    if axis is not None:
        record_axis_call("pmax", axis, parts[0], len(parts))
    if len(parts) == 1:
        return parts
    if _on_distinct_cards(parts):
        return _nccl(parts, _NCCL_MAX)
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(acc.device))
    return [acc if acc.device == p.device else acc.to(p.device)
            for p in parts]


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0,
               axis: Optional[str] = None) -> List[torch.Tensor]:
    """The members' tensors end to end along ``dim``, one copy a member
    on its member's device.  Distinct cards gather through NCCL (along a
    leading axis, moved to ``dim``); otherwise the pieces are copied to
    the first member's device and concatenated."""
    parts = list(parts)
    if axis is not None:
        record_axis_call("all_gather", axis, parts[0], len(parts))
    if len(parts) == 1:
        return parts
    dim = dim % parts[0].dim()
    if _on_distinct_cards(parts):
        from torch.cuda import nccl
        ins = [p.movedim(dim, 0).contiguous() for p in parts]
        outs = [torch.empty((len(parts),) + tuple(t.shape), dtype=t.dtype,
                            device=t.device) for t in ins]
        nccl.all_gather(ins, outs)
        return [o.reshape((-1,) + tuple(o.shape[2:])).movedim(0, dim)
                .contiguous() for o in outs]
    full = torch.cat([p.to(parts[0].device) for p in parts], dim)
    return [full if full.device == p.device else full.to(p.device)
            for p in parts]


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int = 0,
                   axis: Optional[str] = None) -> List[torch.Tensor]:
    """The sum of the members' tensors cut into as many pieces along
    ``dim`` as there are members: member ``i`` gets piece ``i`` on its
    device.  Distinct cards reduce-scatter through NCCL; otherwise the
    sum is taken as :func:`psum` takes it and cut."""
    parts = list(parts)
    n = len(parts)
    if axis is not None:
        record_axis_call("reduce_scatter", axis, parts[0], n)
    dim = dim % parts[0].dim()
    if parts[0].shape[dim] % n:
        raise MXNetError(f"reduce_scatter: dimension {dim} of size "
                         f"{parts[0].shape[dim]} does not split into {n}")
    if n == 1:
        return parts
    if _on_distinct_cards(parts):
        from torch.cuda import nccl
        ins = [p.movedim(dim, 0).contiguous() for p in parts]
        outs = [torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                            dtype=t.dtype, device=t.device) for t in ins]
        nccl.reduce_scatter(ins, outs)
        return [o.movedim(0, dim).contiguous() for o in outs]
    total = psum(parts)[0]
    return [piece.to(p.device) for piece, p in
            zip(total.chunk(n, dim), parts)]


def allreduce_processes(tensors: Sequence[torch.Tensor],
                        bucket_bytes: Optional[int] = None,
                        axis: Optional[str] = None,
                        ranks: Optional[Sequence[int]] = None
                        ) -> List[torch.Tensor]:
    """Each tensor summed over every process of the process group, or
    over the processes ``ranks`` (``dist.init_distributed``): the tensors
    of one dtype laid end to end in order, cut into ~``bucket_bytes``
    flat buckets, one ``torch.distributed.all_reduce`` a bucket (NCCL or
    gloo, as the group was made); counted by :func:`count_collectives`
    (kind ``"process"``, along ``axis``).  Returns one result a tensor,
    on its device, the same bits on every process."""
    import torch.distributed as tdist
    from . import dist
    bucket_bytes = bucket_bytes or DEFAULT_BUCKET_BYTES
    tensors = list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for (dtype, _), idxs in by_dtype.items():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        itemsize = flat.element_size()
        plan = plan_buckets([tensors[i].numel() for i in idxs], itemsize,
                            bucket_bytes)
        start = 0
        for bucket in plan:
            n = sum(stop - lo for _, lo, stop in bucket)
            piece = flat[start:start + n]
            _program.note_kernel("all_reduce", reads=(piece,),
                                 collective="reduce")
            tdist.all_reduce(piece, group=(None if ranks is None
                                           else dist.subgroup(ranks)))
            _emit({"nbytes": n * itemsize, "wire_nbytes": n * itemsize,
                   "num_pieces": len(bucket),
                   "tensor_indices": [idxs[pi] for pi, _, _ in bucket],
                   "dtype": _dtype_name(dtype), "compression": None,
                   "mean": False, "kind": "process", "axis": axis})
            start += n
        off = 0
        for i in idxs:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out  # type: ignore[return-value]


def over_axis(groups: Sequence[Sequence[int]], fn, parts, axis: str,
              **kw) -> List[torch.Tensor]:
    """``fn`` (:func:`psum`, :func:`pmax`, :func:`all_gather`,
    :func:`reduce_scatter`) over each group of members of a mesh axis
    (``mesh.axis_groups(mesh, axis)``): ``parts`` holds one tensor a
    member in row-major member order, and so does the result."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for group in groups:
        res = fn([parts[i] for i in group], axis=axis, **kw)
        for i, r in zip(group, res):
            out[i] = r
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# quantized psum

def _recip(c: float) -> float:
    """``1 / c`` rounded to float32 (exact in a float32 multiply)."""
    return float(np.float32(1.0) / np.float32(c))


def _block_view(flat: torch.Tensor, block: int) -> torch.Tensor:
    """Pad a flat f32 vector to a whole number of scale blocks and view
    it as ``[nblocks, block]``."""
    n = flat.numel()
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(nb, block)


def psum_compressed(xs: Sequence[torch.Tensor],
                    compression: Optional[str] = None, *,
                    block: Optional[int] = None,
                    residuals: Optional[Sequence[torch.Tensor]] = None,
                    gather: Optional[Callable] = None):
    """All-reduce-sum one tensor a member (each on its member's device),
    optionally through a quantized wire format; returns one result a
    member, and with ``residuals`` (one flat f32 a member, ``x.numel()``
    elements) also the new residuals: each member compresses ``x +
    residual`` and keeps exactly the quantization error it committed
    (error feedback).

    ``"int8"``: one f32 scale a ``block`` (default
    ``quant.default_block_size()``) shared by every member (the max of
    the members' block absmax), ``round(y / scale)`` half to even,
    clipped to [-127, 127], summed on int32 lanes, one dequantize
    multiply.  ``"fp8"``: ``y / scale`` cast onto the e4m3 grid with the
    block absmax pinned to 448, summed on f32 lanes.  ``"bf16"``: cast,
    sum on bf16 lanes, cast back.  Non-float inputs ignore
    ``compression`` and take the plain sum.  The block scale is the
    absmax times the float32 reciprocal of 127 (or 448) and the residual
    ``y - q * scale`` is rounded once: XLA compiles the JAX function so,
    and the results here are bitwise its.

    ``gather``: when the members span processes, a function that maps
    this process's members' tensors (one a member, one shape) to every
    member's in member order, on the first tensor's device; the wire
    payloads, the block maxima and the plain values go through it, and
    each process sums every member's."""
    check_compression(compression)
    xs = list(xs)

    def over(fn, parts, lanes=None):
        # ``fn`` (psum or pmax) over every member's part, on lanes of
        # ``lanes`` once the payloads have crossed
        widen = (lambda ps: ps) if lanes is None else (
            lambda ps: [p.to(lanes) for p in ps])
        if gather is None:
            return fn(widen(parts))
        total = fn(widen(gather(parts)))[0]
        return [total if total.device == p.device else total.to(p.device)
                for p in parts]

    if compression is None or not xs[0].is_floating_point():
        red = over(psum, xs)
        return red if residuals is None else (red, list(residuals))
    if compression == "bf16" and residuals is None:
        return [r.to(x.dtype) for r, x in
                zip(over(psum, [x.to(torch.bfloat16) for x in xs]), xs)]

    ys = []
    for i, x in enumerate(xs):
        y = x.to(torch.float32).reshape(-1)
        if residuals is not None:
            y = y + residuals[i].reshape(y.shape)
        ys.append(y)
    if compression == "bf16":
        qs = [y.to(torch.bfloat16) for y in ys]
        reds = [r.to(torch.float32) for r in over(psum, qs)]
        new_res = [y - q.to(torch.float32) for y, q in zip(ys, qs)]
    else:
        if block is None:
            block = quant.default_block_size()
        ybs = [_block_view(y, block) for y in ys]
        absmax = over(pmax, [yb.abs().amax(dim=1, keepdim=True)
                             for yb in ybs])
        qs, scales = [], []
        for yb, am in zip(ybs, absmax):
            # the block scale times the format's f32 reciprocal: XLA
            # compiles the JAX package's division by the constant so
            if compression == "int8":
                scale = torch.clamp_min(am, 1e-30) * _recip(127.0)
                q = torch.clamp(torch.round(yb / scale), -127.0,
                                127.0).to(torch.int8)
            else:  # fp8: e4m3 payload, exact f32 accumulation lanes
                scale = (torch.clamp_min(am, 1e-30)
                         * _recip(quant.FP8_MAX["e4m3"]))
                q = (yb / scale).to(torch.float8_e4m3fn)
            qs.append(q)
            scales.append(scale)
        lanes = torch.int32 if compression == "int8" else torch.float32
        sums = over(psum, qs, lanes)
        n = ys[0].numel()
        reds = [(sm.to(torch.float32) * s).reshape(-1)[:n]
                for sm, s in zip(sums, scales)]
        # the residual y - q * scale with one rounding (the fused
        # multiply-add XLA compiles it to): the product is exact in
        # float64, and so is the difference of these near values
        new_res = ([] if residuals is None else
                   [(y.double() - (q.double() * s.double())
                     .reshape(-1)[:n]).float()
                    for y, q, s in zip(ys, qs, scales)])
    outs = [r.reshape(x.shape).to(x.dtype) for r, x in zip(reds, xs)]
    if residuals is None:
        return outs
    return outs, [nr.reshape(r.shape) for nr, r in zip(new_res, residuals)]


# ---------------------------------------------------------------------------
# bucket planning

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


def _allreduce_bucketed(groups: List[List[torch.Tensor]],
                        members: Tuple[Context, ...], mean: bool,
                        priorities: Optional[Sequence[int]],
                        bucket_bytes: int,
                        compression: Optional[str]
                        ) -> List[List[torch.Tensor]]:
    """Reduce many gradient groups (each: one tensor a member, in
    ``members`` order) through fused flat buckets.  Returns the reduced
    groups in the input order, each member's result on its device."""
    ngroups = len(groups)
    if priorities is not None and len(priorities) != ngroups:
        raise MXNetError("allreduce: priorities length mismatch")
    for g in groups:
        shape, dtype = g[0].shape, g[0].dtype
        for a in g[1:]:
            if a.shape != shape or a.dtype != dtype:
                raise MXNetError("allreduce: mismatched shapes/dtypes")

    # dispatch order: higher priority first; stable for ties
    order = sorted(range(ngroups),
                   key=(lambda i: -priorities[i]) if priorities is not None
                   else (lambda i: 0))
    by_dtype: dict = {}
    for i in order:
        by_dtype.setdefault(groups[i][0].dtype, []).append(i)

    n = len(members)
    results: List[Optional[List[torch.Tensor]]] = [None] * ngroups
    pieces_out: dict = {i: [] for i in range(ngroups)}
    for dtype, idxs in by_dtype.items():
        counts = [groups[i][0].numel() for i in idxs]
        # zero-size tensors contribute nothing; pass them through
        sized = [(i, c) for i, c in zip(idxs, counts) if c > 0]
        for i, c in zip(idxs, counts):
            if c == 0:
                results[i] = list(groups[i])
        if not sized:
            continue
        itemsize = groups[sized[0][0]][0].element_size()
        plan = plan_buckets([c for _, c in sized], itemsize, bucket_bytes)
        flats = {i: [a.reshape(-1) for a in groups[i]] for i, _ in sized}
        for bucket in plan:
            per_dev = []
            for d_i in range(n):
                segs = []
                for pi, start, stop in bucket:
                    flat = flats[sized[pi][0]][d_i]
                    segs.append(flat if (start == 0 and stop == flat.numel())
                                else flat[start:stop])
                per_dev.append(segs[0] if len(segs) == 1
                               else torch.cat(segs))
            reduced = psum_compressed(per_dev, compression)
            if mean:
                reduced = [r * _recip(n) if r.is_floating_point() else r / n
                           for r in reduced]
            wire_item = quant.wire_itemsize(
                compression if dtype.is_floating_point else None, itemsize)
            _emit({"nbytes": per_dev[0].numel() * itemsize,
                   "wire_nbytes": per_dev[0].numel() * wire_item,
                   "num_pieces": len(bucket),
                   "tensor_indices": [sized[pi][0] for pi, _, _ in bucket],
                   "dtype": _dtype_name(dtype), "compression": compression,
                   "mean": mean, "kind": "bucket"})
            # carve the reduced flat buffer back into tensor pieces
            off = 0
            for pi, start, stop in bucket:
                ln = stop - start
                pieces_out[sized[pi][0]].append(
                    [r[off:off + ln] for r in reduced])
                off += ln

    for idx in range(ngroups):
        if results[idx] is not None:
            continue
        shape = tuple(groups[idx][0].shape)
        outs = []
        for d_i in range(n):
            parts = [p[d_i] for p in pieces_out[idx]]
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            outs.append(flat.reshape(shape))
        results[idx] = outs
    return results  # type: ignore[return-value]


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name JAX records (``float32``, ``bfloat16``, ``int32``)."""
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# public API

def _wrap(like, t: torch.Tensor, ctx: Context):
    if isinstance(like, torch.Tensor):
        return t
    from ..ndarray import NDArray
    return NDArray(t, ctx=ctx)


def _allreduce(arrays, mean: bool, priorities=None,
               bucket_bytes: Optional[int] = None,
               compression: Optional[str] = None):
    check_compression(compression)
    if bucket_bytes is None:
        bucket_bytes = DEFAULT_BUCKET_BYTES
    arrays = list(arrays)
    if not arrays:
        return []
    grouped = isinstance(arrays[0], (list, tuple))
    groups = [list(g) for g in arrays] if grouped else [arrays]

    flat_out: List[list] = [None] * len(groups)  # type: ignore
    bucketable: List[int] = []
    for gi, g in enumerate(groups):
        if len(g) == 1:
            flat_out[gi] = list(g)
        elif not distinct_devices(g):
            # co-resident members: a plain tree sum on the first one
            acc = _tensor(g[0])
            for a in g[1:]:
                acc = acc + _tensor(a).to(acc.device)
            if mean:
                acc = acc / len(g)
            _emit({"nbytes": acc.numel() * acc.element_size(),
                   "wire_nbytes": acc.numel() * acc.element_size(),
                   "num_pieces": 1, "tensor_indices": [gi],
                   "dtype": _dtype_name(acc.dtype), "compression": None,
                   "mean": mean, "kind": "tree"})
            ctx0 = member_of(g[0])
            flat_out[gi] = [_wrap(a, acc, ctx0) for a in g]
        else:
            bucketable.append(gi)

    if bucketable:
        members = tuple(member_of(a) for a in groups[bucketable[0]])
        for gi in bucketable[1:]:
            if tuple(member_of(a) for a in groups[gi]) != members:
                raise MXNetError("allreduce: bucketed groups must share one "
                                 "device set in one order")
        sub_prior = ([priorities[gi] for gi in bucketable]
                     if priorities is not None else None)
        reduced = _allreduce_bucketed(
            [[_tensor(a) for a in groups[gi]] for gi in bucketable],
            members, mean, sub_prior, bucket_bytes, compression)
        for gi, r in zip(bucketable, reduced):
            flat_out[gi] = [_wrap(a, t, m) for a, t, m
                            in zip(groups[gi], r, members)]

    return flat_out if grouped else flat_out[0]


def allreduce_sum(arrays, *, priorities=None,
                  bucket_bytes: Optional[int] = None,
                  compression: Optional[str] = None):
    """All-reduce-sum one value a member; each member gets the total.

    ``arrays`` is either one group (a list of same-shaped NDArrays or
    tensors, one a member) or a list of groups (one a gradient).  Groups
    are fused into ~``bucket_bytes`` flat buckets reduced in descending
    ``priorities`` order; ``compression`` selects the quantized wire
    format (:func:`psum_compressed`).  Results have the inputs' kind:
    NDArrays on their members' contexts, or tensors."""
    return _allreduce(arrays, mean=False, priorities=priorities,
                      bucket_bytes=bucket_bytes, compression=compression)


def allreduce_mean(arrays, *, priorities=None,
                   bucket_bytes: Optional[int] = None,
                   compression: Optional[str] = None):
    return _allreduce(arrays, mean=True, priorities=priorities,
                      bucket_bytes=bucket_bytes, compression=compression)
