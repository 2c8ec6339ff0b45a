"""The program auditor of the port: the aten ops and kernel launches of
one execution of a program's body, held to the JAX package's program
rules (``mxnet_tpu/analysis/program.py``) with its rule ids, report
schema and metric keys.

A JAX program is a closed jaxpr; a program of the port is a body that a
:class:`~mxnet_tpu_torch.compile_cache.CapturedProgram` captures as a
CUDA graph (a trainer step, an executor's forward and backward, a serving
bucket).  Its counterpart of a trace is a :class:`ProgramTrace`: a
``TorchDispatchMode`` (the recorder) runs around one execution of the
body and keeps, per aten op, the op's name, the metadata of every input
and output tensor (dtype, shape, device, a buffer identity) and the user
frame that issued it, plus the body's declared inputs, state and outputs.
The recorder keeps metadata only, never a tensor, and reads no value: it
runs inside a capture as well as eagerly.  The mode reaches autograd's
threads, so the backward half of a step is in the trace.

The hand-written kernels launch through ``ctypes``, which no dispatch
mode sees.  Each kernel wrapper therefore leaves a *kernel note*
(:func:`note_kernel`: the kernel's name and the tensors it reads and
writes) once per launch, inside a *kernel region* (:func:`kernel_region`)
that covers both branches of the wrapper: the kernel on the card and
its plain version on the CPU.  The plain version's aten ops count for
``program.widen``, ``program.host-transfer`` and
``program.captured-const`` and not for gradient passes, as the JAX
auditor treats ``pallas_call``.  :func:`~mxnet_tpu_torch.parallel.
collectives.psum` notes each reduction over several members as a
``reduce`` collective (one tensor a member; both its branches, the loop
of adds and NCCL), and ``allreduce_processes`` each bucket it reduces
over processes.  ``pmax`` reduces block scales, never gradients, and
leaves no note (the JAX auditor's reduce collectives are its ``psum``
primitives too).

Rules (ids and severities are the JAX package's):

- ``program.widen``          an op whose 64-bit float or int output comes
                             from narrower inputs: an error when the value
                             reaches a program output or is written into
                             a buffer the body did not allocate (state), a
                             warn for an intermediate of at least
                             ``widen_bytes_threshold`` bytes, else silent
                             (PyTorch's int64 defaults: ``argmax``, a sum
                             of bools, ``arange``)
- ``program.carry-widen``    a carried value leaves with another dtype or
                             shape than it entered (``fit``'s metric
                             carry, an executor's aux outputs); state
                             written in place with ``copy_`` cannot change
                             dtype, and its narrowing is ``widen``'s
- ``program.captured-const`` a tensor the body reads that is none of its
                             declared inputs or state and no output of an
                             earlier op: a CUDA graph bakes in its address
- ``program.host-transfer``  ``.item()`` (``_local_scalar_dense``), an op
                             whose output size depends on data
                             (``nonzero``, ``masked_select``, ``unique``),
                             or, in a program on the card, a copy to or
                             from the host
- ``program.fused-update``   a fused-update program that touches a tagged
                             gradient bucket outside the fused kernel
                             (more than 1 read / 1 write) or tags none
- ``program.hbm-bytes``      a reduce collective whose bucket-scale
                             payload is wider than the configured
                             compression, or a paged KV read wider than
                             the pool's quantized width

and the HBM-pass metric (:func:`update_passes`): gradients are tagged
(:func:`tag`, ``grad:<name>`` or ``gradbucket:<i>``) and the auditor
counts the ops that read each gradient or a same-size value derived from
it, outside kernel regions; a kernel note counts exactly 1 read and 1
write for each tagged operand and passes nothing on.

The JAX rules ``program.donation-miss``, ``program.donation-alias`` and
``program.carry-sharding`` have no meaning here (a graph donates nothing;
a mesh member holds whole tensors): they stay data in
:data:`~mxnet_tpu_torch.analysis.findings.RESERVED_RULES`.

Buffer identity: a tensor's storage address plus a generation that is
bumped each time an op's output takes a fresh storage, so a freed block
that the caching allocator hands to an unrelated tensor is a new buffer;
a view adds its storage offset and element count.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import re
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Set, Tuple)

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from .findings import Finding, Report, apply_inline, parse_inline_suppressions

__all__ = [
    "AuditConfig", "tag", "mark_grads", "audit_traced", "audit_trainer",
    "audit_executor", "audit_module", "audit_optimizer",
    "audit_on_compile", "assert_program_clean", "update_passes",
    "collective_wire_rows", "kv_read_rows", "bucket_passes",
    "ProgramTrace", "record_program", "recording", "note_kernel",
    "kernel_region",
]


# ----------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------

#: aten ops that wait for the card and read a value back, or whose
#: output size depends on data (a read back to size it)
HOST_TRANSFER_OPS = frozenset({
    "_local_scalar_dense", "item", "nonzero", "nonzero_static",
    "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive",
})

#: aten ops that copy between devices: a host transfer when one side is
#: the host and the program runs on the card
COPY_OPS = frozenset({"_to_copy", "copy_", "_copy_from",
                      "_copy_from_and_resize"})

#: view ops: the output aliases the input and moves no bucket bytes
#: (the counterpart of the JAX auditor's FREE_PASS_PRIMS)
FREE_PASS_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "slice",
    "select", "as_strided", "detach", "alias", "split", "split_with_sizes",
    "unbind", "t", "transpose", "expand", "squeeze", "unsqueeze",
    "view_as", "lift_fresh",
})

#: aten ops that read rows of a table by index: over a pool-shaped
#: operand (rank >= 4) they are a paged KV read
GATHER_OPS = frozenset({"index", "index_select", "embedding", "gather"})

_64BIT = frozenset({torch.float64, torch.int64, torch.uint64,
                    torch.complex64})


@dataclass
class AuditConfig:
    """Knobs for one audit run (defaults match the CI gate)."""
    const_bytes_threshold: int = 1024      # captured-const floor
    widen_bytes_threshold: int = 65536     # large 64-bit intermediate floor
    count_hbm: bool = True
    # reduce collectives whose f32-width payload is below this many bytes
    # are exempt from the hbm-bytes rule (loss/grad-norm scalars ride
    # plain psum by design; only bucket-scale payloads must quantize)
    collective_bytes_floor: int = 1024
    host_transfer_ops: frozenset = HOST_TRANSFER_OPS
    free_pass_ops: frozenset = FREE_PASS_OPS


# ----------------------------------------------------------------------
# The trace: events over tensor metadata
# ----------------------------------------------------------------------

class TensorMeta(NamedTuple):
    """What the recorder keeps of a tensor: no reference to it."""
    dtype: torch.dtype
    shape: Tuple[int, ...]
    device: str
    buf: Tuple[int, int]              # (storage address, generation)
    key: Tuple[int, int, int, int]    # buf + (storage offset, numel)

    @property
    def numel(self) -> int:
        return self.key[3]

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def nbytes(self) -> int:
        return self.key[3] * self.dtype.itemsize

    @property
    def produced(self) -> bool:
        """Whether an op of the trace allocated this buffer."""
        return self.buf[1] != 0

    def describe(self) -> str:
        return f"{_dt(self.dtype)}{list(self.shape)}"


@dataclass
class OpEvent:
    op: str                           # aten overload packet, e.g. "mul"
    ins: Tuple[TensorMeta, ...]
    outs: Tuple[TensorMeta, ...]
    path: str
    line: int
    region: Optional[int]             # kernel region the op ran in
    backward: bool                    # issued by an autograd node


@dataclass
class TagEvent:
    label: str
    meta: TensorMeta


@dataclass
class NoteEvent:
    kernel: str
    reads: Tuple[TensorMeta, ...]
    writes: Tuple[TensorMeta, ...]
    attrs: Dict[str, Any]
    path: str
    line: int
    region: Optional[int]
    backward: bool


@dataclass
class ProgramTrace:
    """One execution of a program's body: its events in order, and its
    declared inputs (``(name, meta)`` pairs, named as the flattened
    tree's paths: ``['aux']['bn_moving_mean']``), state and outputs."""
    label: str
    device: str
    events: List[Any]
    inputs: List[Tuple[str, TensorMeta]]
    state: List[TensorMeta]
    outputs: List[Tuple[str, TensorMeta]] = field(default_factory=list)

    @property
    def ops(self) -> List[OpEvent]:
        return [e for e in self.events if isinstance(e, OpEvent)]

    @property
    def notes(self) -> List[NoteEvent]:
        return [e for e in self.events if isinstance(e, NoteEvent)]

    def declared(self) -> Set[int]:
        """Storage addresses of the declared inputs and state."""
        return ({m.buf[0] for _, m in self.inputs}
                | {m.buf[0] for m in self.state})

    def kernel_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.notes:
            out[n.kernel] = out.get(n.kernel, 0) + 1
        return out


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _is64(dtype) -> bool:
    return dtype in _64BIT


def _storage_ptr(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):   # no storage (sparse ...)
        return 0


_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_STDLIB_DIR = os.path.dirname(os.__file__) + os.sep
_THIS_FILE = os.path.abspath(__file__)


def _user_frame(depth: int = 2) -> Tuple[str, int]:
    """(file, line) of the first frame outside torch, the standard
    library and this module: the counterpart of the JAX auditor's
    ``_src_of``."""
    f = sys._getframe(depth)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith(_TORCH_DIR) or fn.startswith(_STDLIB_DIR)
                or fn.startswith("<") or fn == _THIS_FILE):
            return fn, f.f_lineno
        f = f.f_back
    return "", 0


def _flat_tensors(tree, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` leaves of nested dicts (sorted keys), lists and
    tuples, paths spelled as the JAX package's ``keystr``."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    out: List[Tuple[str, torch.Tensor]] = []
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            out += _flat_tensors(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += _flat_tensors(v, f"{path}[{i}]")
    return out


_live_lock = threading.Lock()
_live = [0]        # recorders active in any thread


class _Recorder(TorchDispatchMode):
    """The dispatch mode of one recording: appends an event per aten op.
    Its Python code reads metadata only (no value, no sync)."""

    def __init__(self):
        super().__init__()
        self.events: List[Any] = []
        self._gen: Dict[int, int] = {}
        self._ids = itertools.count(1)
        self._regions = itertools.count(1)
        self._local = threading.local()

    def meta(self, t: torch.Tensor, fresh: bool = False) -> TensorMeta:
        ptr = _storage_ptr(t)
        if ptr == 0:                # empty storage: never the same buffer
            gen = next(self._ids)
        elif fresh:
            gen = self._gen[ptr] = next(self._ids)
        else:
            gen = self._gen.get(ptr, 0)
        return TensorMeta(t.dtype, tuple(t.shape), str(t.device), (ptr, gen),
                          (ptr, gen, t.storage_offset(), t.numel()))

    def region_stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _region(self) -> Optional[int]:
        stack = self.region_stack()
        return stack[-1] if stack else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [self.meta(t) for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        out = func(*args, **kwargs)
        in_ptrs = {m.buf[0] for m in ins}
        outs = [self.meta(t, fresh=_storage_ptr(t) not in in_ptrs)
                for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        path, line = _user_frame()
        self.events.append(OpEvent(
            func.overloadpacket.__name__, tuple(ins), tuple(outs), path,
            line, self._region(),
            torch._C._current_autograd_node() is not None))
        return out

    def note(self, kernel: str, reads, writes, attrs) -> None:
        path, line = _user_frame(3)
        self.events.append(NoteEvent(
            str(kernel),
            tuple(self.meta(t) for t in reads if isinstance(t, torch.Tensor)),
            tuple(self.meta(t) for t in writes
                  if isinstance(t, torch.Tensor)),
            {k: (_dt(v) if isinstance(v, torch.dtype) else v)
             for k, v in attrs.items()},
            path, line, self._region(),
            torch._C._current_autograd_node() is not None))


def _active() -> Optional[_Recorder]:
    """The recorder of this thread (autograd's threads inherit the
    dispatch modes of the backward's caller), or None."""
    if not _live[0]:
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _Recorder):
            return mode
    return None


# ----------------------------------------------------------------------
# Hooks for the framework: tags, kernel notes, kernel regions
# ----------------------------------------------------------------------

def tag(x, label: str):
    """Identity: with a recorder active, mark ``x``'s buffer as the
    gradient ``label`` for the HBM-pass counter.  Adds no op, no copy and
    no launch."""
    rec = _active()
    if rec is not None and isinstance(x, torch.Tensor):
        rec.events.append(TagEvent(str(label), rec.meta(x)))
    return x


def mark_grads(grads: Dict[str, Any]) -> Dict[str, Any]:
    """Tag each gradient ``grad:<name>`` (used by ShardedTrainer)."""
    if _active() is None:
        return grads
    return {n: tag(g, label=f"grad:{n}") for n, g in grads.items()}


def note_kernel(kernel: str, reads: Sequence = (), writes: Sequence = (),
                **attrs) -> None:
    """Record one launch of ``kernel`` over the tensors it ``reads`` and
    ``writes`` (``attrs`` are plain values: ``collective="reduce"``,
    ``kv_elems=...``).  Does nothing, and touches no tensor, when no
    recorder is active in this thread."""
    rec = _active()
    if rec is not None:
        rec.note(kernel, reads, writes, attrs)


def kernel_region(fn: Callable) -> Callable:
    """Decorate a kernel wrapper: the ops it issues (its plain version's,
    on the CPU) belong to the kernel for the gradient-pass count.  The
    wrapper's own attributes (launch counters) live on the decorated
    function."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        rec = _active()
        if rec is None:
            return fn(*args, **kwargs)
        stack = rec.region_stack()
        stack.append(next(rec._regions))
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop()
    return wrapper


# ----------------------------------------------------------------------
# Recording a body
# ----------------------------------------------------------------------

class recording:
    """Context manager: record the aten ops (and notes and tags) this
    thread and autograd's threads issue until exit; ``trace`` holds the
    :class:`ProgramTrace` afterwards.  ``inputs`` (a tree of tensors) and
    ``state`` (a sequence) are declared; :meth:`set_outputs` declares the
    body's result.  Inside a CUDA-graph capture it records the captured
    iteration (metadata only)."""

    def __init__(self, label: str, device, inputs=None,
                 state: Sequence[torch.Tensor] = ()):
        self.label = label
        self.device = str(torch.device(device))
        self._inputs = inputs
        self._state = state
        self._rec: Optional[_Recorder] = None
        self.trace: Optional[ProgramTrace] = None

    def __enter__(self) -> "recording":
        rec = self._rec = _Recorder()
        self.trace = ProgramTrace(
            self.label, self.device, rec.events,
            [(n, rec.meta(t)) for n, t in _flat_tensors(self._inputs or {})],
            [rec.meta(t) for t in self._state
             if isinstance(t, torch.Tensor)])
        self._inputs = self._state = None
        with _live_lock:
            _live[0] += 1
        rec.__enter__()
        return self

    def set_outputs(self, out) -> None:
        self.trace.outputs = [(n, self._rec.meta(t))
                              for n, t in _flat_tensors(out)]

    def __exit__(self, *exc) -> None:
        try:
            self._rec.__exit__(*exc)
        finally:
            with _live_lock:
                _live[0] -= 1
            self._rec = None


def _snapshot_random() -> Callable[[], None]:
    """The port's key sequence and generators, torch's CPU generator and
    the CUDA default generators, as they are now; the returned function
    puts them back (the executors draw ``random.next_key()`` per
    forward)."""
    from .. import random as _random
    saved = dict(_random._state)
    gens = {d: g.get_state() for d, g in _random._generators.items()}
    cpu = torch.random.get_rng_state()
    cuda = (torch.cuda.get_rng_state_all()
            if torch.cuda.is_available() and torch.cuda.is_initialized()
            else None)

    def restore():
        _random._state.update(saved)
        for d in list(_random._generators):
            if d in gens:
                _random._generators[d].set_state(gens[d])
            else:
                del _random._generators[d]
        torch.random.set_rng_state(cpu)
        if cuda is not None:
            torch.cuda.set_rng_state_all(cuda)
    return restore


def record_program(label: str, body: Callable[[], Any], device,
                   inputs=None, state: Sequence[torch.Tensor] = (),
                   preserve: Optional[Callable[[], Callable[[], None]]]
                   = None) -> ProgramTrace:
    """Run ``body()`` once under the recorder and return its trace.
    ``preserve()`` (called first) returns the function that restores
    what the body writes; the random state is restored as well, so the
    owner is left as it was."""
    restore = preserve() if preserve is not None else None
    undo_random = _snapshot_random()
    try:
        with recording(label, device, inputs, state) as rec:
            rec.set_outputs(body())
    finally:
        if restore is not None:
            restore()
        undo_random()
    return rec.trace


# ----------------------------------------------------------------------
# Rules over one trace
# ----------------------------------------------------------------------

def _check_widen(trace: ProgramTrace, program: str, report: Report,
                 config: AuditConfig) -> None:
    """Flag ops that *introduce* 64-bit values from narrower inputs.  An
    introduction that reaches a program output, or is written into a
    buffer the body did not allocate (state, a declared input: an
    in-place write of a same-shape or one-element value, so an int64
    index into a pool is not a write of it), is an error; a large
    intermediate a warn; the rest is silent."""
    src: Dict[Tuple, Set[int]] = {}
    intros: List[OpEvent] = []
    escaped: Set[int] = set()
    for ev in trace.ops:
        outs64 = [m for m in ev.outs if _is64(m.dtype)]
        if outs64 and not any(_is64(m.dtype) for m in ev.ins):
            for m in outs64:
                src.setdefault(m.key, set()).add(len(intros))
            intros.append(ev)
            continue
        flowed = [(m, src[m.key]) for m in ev.ins if m.key in src]
        if not flowed:
            continue
        flow = set().union(*(f for _, f in flowed))
        for m in outs64:
            src.setdefault(m.key, set()).update(flow)
        for o in ev.outs:
            if o.produced:
                continue
            for m, f in flowed:
                if m.shape == o.shape or m.numel == 1:
                    escaped |= f
    for _, m in trace.outputs:
        escaped |= src.get(m.key, set())
    for k, ev in enumerate(intros):
        outs64 = [m for m in ev.outs if _is64(m.dtype)]
        nbytes = sum(m.nbytes for m in outs64)
        does_escape = k in escaped
        if not does_escape and nbytes < config.widen_bytes_threshold:
            continue
        in_dts = sorted({_dt(m.dtype) for m in ev.ins})
        what = ("escapes to a program output or state" if does_escape
                else f"is a {nbytes}-byte 64-bit intermediate")
        report.add(Finding(
            "program.widen",
            f"op `{ev.op}` produces "
            f"{'/'.join(_dt(m.dtype) for m in outs64)} from "
            f"{'/'.join(in_dts) or 'no'} inputs and {what}",
            path=ev.path, line=ev.line, program=program,
            severity="error" if does_escape else "warn",
            details={"op": ev.op,
                     "out_dtypes": [_dt(m.dtype) for m in outs64],
                     "in_dtypes": in_dts, "bytes": nbytes,
                     "escapes": does_escape}))


def _check_host_transfers(trace: ProgramTrace, program: str,
                          report: Report, config: AuditConfig) -> None:
    on_card = trace.device.startswith("cuda")
    for ev in trace.ops:
        if ev.op in config.host_transfer_ops:
            why = "reads a value back to the host"
        elif on_card and ev.op in COPY_OPS and any(
                m.device == "cpu" for m in ev.ins + ev.outs):
            why = "copies between the host and the card"
        else:
            continue
        report.add(Finding(
            "program.host-transfer",
            f"op `{ev.op}` inside the program {why} on every call",
            path=ev.path, line=ev.line, program=program,
            details={"op": ev.op}))


def _check_captured_consts(trace: ProgramTrace, program: str,
                           report: Report, config: AuditConfig) -> int:
    declared = trace.declared()
    found: Dict[Tuple[int, int], Tuple[TensorMeta, Any]] = {}
    for ev in trace.events:
        metas = (ev.ins if isinstance(ev, OpEvent)
                 else ev.reads if isinstance(ev, NoteEvent) else ())
        for m in metas:
            if m.produced or m.buf[0] in declared or m.buf[0] == 0:
                continue
            seen = found.get(m.buf)
            if seen is None or m.nbytes > seen[0].nbytes:
                found[m.buf] = (m, ev if seen is None else seen[1])
    total = 0
    for m, ev in found.values():
        total += m.nbytes
        if m.nbytes >= config.const_bytes_threshold:
            report.add(Finding(
                "program.captured-const",
                f"closed-over tensor {m.describe()} on {m.device} "
                f"({m.nbytes} bytes) is none of the program's inputs or "
                "state — a captured graph reads the address it had at "
                "capture, so rebinding it leaves the replay on stale "
                "memory",
                path=ev.path, line=ev.line, program=program,
                details={"shape": list(m.shape), "dtype": _dt(m.dtype),
                         "bytes": m.nbytes, "device": m.device}))
    return total


def _check_carry_dtypes(trace: ProgramTrace, pairs, program: str,
                        report: Report) -> None:
    for in_idx, out_idx, name in pairs:
        a, b = trace.inputs[in_idx][1], trace.outputs[out_idx][1]
        if a.dtype != b.dtype or a.shape != b.shape:
            report.add(Finding(
                "program.carry-widen",
                f"carried value `{name}` enters as {a.describe()} but "
                f"leaves as {b.describe()} — the next call sees another "
                "program signature",
                program=program,
                details={"carry": name, "in": a.describe(),
                         "out": b.describe()}))


# ----------------------------------------------------------------------
# HBM-pass counter
# ----------------------------------------------------------------------

def update_passes(trace: ProgramTrace, config: Optional[AuditConfig] = None
                  ) -> Dict[str, Dict[str, int]]:
    """Count how many ops traverse each tagged gradient on the update
    path: ``{label: {reads, writes}}``.

    ``reads`` counts the ops outside kernel regions that consume the
    gradient or a same-size value derived from it; ``writes`` counts the
    same-size buffers those ops produce.  View ops pass the tag on for
    free.  A kernel note counts 1 read and 1 write for each tagged
    operand (once per kernel call) and passes nothing on.  A single-pass
    fused update reads 1 / writes 1.
    """
    config = config or AuditConfig()
    free = config.free_pass_ops
    roots: Dict[str, Set[int]] = {}                 # label -> numels
    derived: Dict[Tuple, Set[str]] = {}             # view key -> labels
    reads: Dict[str, int] = {}
    writes: Dict[str, int] = {}
    counted: Dict[int, Set[str]] = {}               # region -> labels
    for ev in trace.events:
        if isinstance(ev, TagEvent):
            roots.setdefault(ev.label, set()).add(ev.meta.numel)
            derived.setdefault(ev.meta.key, set()).add(ev.label)
            reads.setdefault(ev.label, 0)
            writes.setdefault(ev.label, 0)
            continue
        if isinstance(ev, NoteEvent):
            hit: Set[str] = set()
            for m in ev.reads:
                hit |= derived.get(m.key, set())
            if ev.region is not None:
                hit -= counted.setdefault(ev.region, set())
                counted[ev.region] |= hit
            for label in hit:
                reads[label] += 1
                writes[label] += 1
            continue
        if ev.region is not None:
            continue
        hit = set()
        for m in ev.ins:
            hit |= derived.get(m.key, set())
        if not hit:
            continue
        if ev.op in free:
            for m in ev.outs:
                derived.setdefault(m.key, set()).update(hit)
            continue
        for label in hit:
            reads[label] += 1
        for m in ev.outs:
            prop = {lb for lb in hit if m.numel in roots[lb]}
            if prop:
                derived.setdefault(m.key, set()).update(prop)
                for label in prop:
                    writes[label] += 1
    return {label: {"reads": reads[label], "writes": writes[label]}
            for label in roots}


def bucket_passes(per_param: Dict[str, Dict[str, int]],
                  params: Dict[str, Any],
                  param_order: Sequence[str],
                  bucket_bytes: int) -> List[Dict[str, Any]]:
    """Aggregate per-gradient pass counts onto the flat comm buckets
    (the trainer's bucket plan: last-declared-first, grouped by dtype,
    split at ``grad_bucket_bytes``).  ``params`` maps names to anything
    with ``shape`` and ``dtype``."""
    from ..parallel.collectives import plan_buckets
    out: List[Dict[str, Any]] = []
    order = [n for n in reversed(list(param_order))
             if f"grad:{n}" in per_param]
    by_dtype: Dict[Any, List[str]] = {}
    for n in order:
        by_dtype.setdefault(params[n].dtype, []).append(n)
    for dtype, names in by_dtype.items():
        counts = [int(torch.Size(params[n].shape).numel()) for n in names]
        plan = plan_buckets(counts, dtype.itemsize, bucket_bytes)
        for bucket in plan:
            members = sorted({names[pi] for pi, _, _ in bucket})
            nbytes = sum((s1 - s0) * dtype.itemsize for _, s0, s1 in bucket)
            rds = [per_param[f"grad:{n}"]["reads"] for n in members]
            wrs = [per_param[f"grad:{n}"]["writes"] for n in members]
            out.append({
                "index": len(out),
                "dtype": _dt(dtype),
                "bytes": nbytes,
                "params": members,
                "reads": max(rds) if rds else 0,
                "writes": max(wrs) if wrs else 0,
            })
    return out


def _fused_bucket_passes(per_label: Dict[str, Dict[str, int]],
                         plan) -> List[Dict[str, Any]]:
    """Bucket rows for a fused-update program: the trainer tags its
    gradients ``gradbucket:<i>`` by the plan bucket they lie in, so
    counts map 1:1 onto the plan's buckets."""
    out: List[Dict[str, Any]] = []
    for i, segs in enumerate(plan.buckets):
        c = per_label.get(f"gradbucket:{i}", {"reads": 0, "writes": 0})
        out.append({
            "index": i,
            "dtype": "float32",
            "bytes": sum(s1 - s0 for _, s0, s1 in segs) * 4,
            "params": sorted({n for n, _, _ in segs}),
            "reads": c["reads"],
            "writes": c["writes"],
        })
    return out


def _check_fused_update(per: Dict[str, Dict[str, int]], program: str,
                        report: Report) -> None:
    """A program audited with ``expect_fused`` must tag its buckets and
    traverse each exactly once (1 read / 1 write)."""
    labels = [lb for lb in per if lb.startswith("gradbucket:")]
    if not labels:
        report.add(Finding(
            "program.fused-update",
            "expect_fused was set but no `gradbucket:<i>` tags exist in "
            "the program — the fused update path is not in the trace",
            program=program))
        return
    for lb in sorted(labels):
        c = per[lb]
        if c["reads"] > 1 or c["writes"] > 1:
            report.add(Finding(
                "program.fused-update",
                f"fused bucket `{lb}` is traversed {c['reads']} reads / "
                f"{c['writes']} writes — the single-pass contract is "
                "1R/1W, so an op outside the fused kernel is touching the "
                "bucket",
                program=program, details={"label": lb, **c}))


# ----------------------------------------------------------------------
# HBM-bytes: reduce collectives and paged KV reads
# ----------------------------------------------------------------------

_WIRE_CONE_DEPTH = 8


def collective_wire_rows(trace: ProgramTrace,
                         config: Optional[AuditConfig] = None
                         ) -> List[Dict[str, Any]]:
    """One row per operand of a reduce-collective note: ``{primitive,
    shape, dtype, elems, wire_itemsize, wire_bytes, f32_bytes,
    float_payload}``.

    ``wire_itemsize`` is the narrowest element width among same-shape
    values in the operand's producer cone (at most 8 ops deep): a
    quantized payload sums on wide lanes (int8 on int32, fp8 on f32), so
    the operand's own dtype is the lane width and the narrow cast that
    formed the payload is what crosses the wire.  ``float_payload``
    marks rows whose cone carries floating data (gradient buckets)."""
    rows: List[Dict[str, Any]] = []
    producer: Dict[Tuple, OpEvent] = {}
    for ev in trace.events:
        if isinstance(ev, OpEvent):
            for m in ev.outs:
                producer[m.key] = ev
            continue
        if not (isinstance(ev, NoteEvent)
                and ev.attrs.get("collective") == "reduce"):
            continue
        for m in ev.reads:
            wire = m.itemsize
            floaty = m.dtype.is_floating_point
            seen = {m.key}
            frontier = [m.key]
            for _ in range(_WIRE_CONE_DEPTH):
                nxt = []
                for k in frontier:
                    pe = producer.get(k)
                    if pe is None:
                        continue
                    for iv in pe.ins:
                        if iv.key in seen:
                            continue
                        seen.add(iv.key)
                        if iv.shape != m.shape:
                            continue
                        wire = min(wire, iv.itemsize)
                        floaty = floaty or iv.dtype.is_floating_point
                        nxt.append(iv.key)
                frontier = nxt
                if not frontier:
                    break
            rows.append({
                "primitive": ev.kernel,
                "shape": list(m.shape),
                "dtype": _dt(m.dtype),
                "elems": m.numel,
                "wire_itemsize": int(wire),
                "wire_bytes": m.numel * int(wire),
                "f32_bytes": m.numel * 4,
                "float_payload": bool(floaty),
            })
    return rows


def _check_hbm_bytes(rows: List[Dict[str, Any]], expect_itemsize: int,
                     program: str, report: Report,
                     config: AuditConfig) -> None:
    """With ``expect_wire_itemsize`` set (a quantized
    ``grad_compression``), every bucket-scale floating reduce collective
    must put a payload at most that wide on the wire."""
    big = [r for r in rows if r["float_payload"]
           and r["f32_bytes"] >= config.collective_bytes_floor]
    if not big:
        report.add(Finding(
            "program.hbm-bytes",
            "expect_wire_itemsize was set but the program has no bucket-"
            "scale floating reduce collective — the quantized grad "
            "reduction is not in the trace",
            program=program,
            details={"expect_wire_itemsize": expect_itemsize}))
        return
    for r in big:
        if r["wire_itemsize"] > expect_itemsize:
            report.add(Finding(
                "program.hbm-bytes",
                f"reduce collective `{r['primitive']}` over "
                f"{r['dtype']}{r['shape']} puts {r['wire_itemsize']} "
                f"bytes/elem on the wire — expected <= {expect_itemsize} "
                "(quantized); the bucket silently widened back to full "
                "precision",
                program=program,
                details={**{k: r[k] for k in
                            ("primitive", "dtype", "wire_itemsize",
                             "wire_bytes", "f32_bytes")},
                         "expect_wire_itemsize": expect_itemsize}))


def _kv_row(m: TensorMeta, elems: int) -> Dict[str, Any]:
    return {"shape": list(m.shape), "dtype": _dt(m.dtype),
            "itemsize": m.itemsize, "elems": int(elems),
            "bytes": int(elems) * m.itemsize, "f32_bytes": int(elems) * 4}


def kv_read_rows(trace: ProgramTrace, config: Optional[AuditConfig] = None
                 ) -> List[Dict[str, Any]]:
    """One row per paged KV-pool read: ``{shape, dtype, itemsize, elems,
    bytes, f32_bytes}``.

    A pool read is a decode-kernel note's pool operand (rank >= 4; the
    note's ``kv_elems`` are the elements its block tables can address,
    counted from shapes) or, outside kernel regions, a gather op
    (``index``, ``index_select``, ...) whose table is pool-shaped (rank
    >= 4), charged over the gathered elements.  The rank filter keeps
    embedding lookups and the fp8 per-position scales out."""
    rows: List[Dict[str, Any]] = []
    for ev in trace.events:
        if isinstance(ev, NoteEvent) and "kv_elems" in ev.attrs:
            rows += [_kv_row(m, ev.attrs["kv_elems"]) for m in ev.reads
                     if len(m.shape) >= 4]
        elif (isinstance(ev, OpEvent) and ev.region is None
              and ev.op in GATHER_OPS and ev.ins and ev.outs
              and len(ev.ins[0].shape) >= 4):
            rows.append(_kv_row(ev.ins[0], ev.outs[0].numel))
    return rows


def _check_kv_bytes(rows: List[Dict[str, Any]], expect_itemsize: int,
                    program: str, report: Report) -> None:
    """With ``expect_kv_itemsize`` set (a quantized pool), every paged KV
    read must read elements at most that wide."""
    if not rows:
        report.add(Finding(
            "program.hbm-bytes",
            "expect_kv_itemsize was set but the program has no paged KV "
            "read — the cache read is not in the trace",
            program=program,
            details={"expect_kv_itemsize": expect_itemsize}))
        return
    for r in rows:
        if r["itemsize"] > expect_itemsize:
            report.add(Finding(
                "program.hbm-bytes",
                f"paged KV read over {r['dtype']}{r['shape']} reads "
                f"{r['itemsize']} bytes/elem — expected <= "
                f"{expect_itemsize} (quantized pool); the cache "
                "silently widened back to full precision",
                program=program,
                details={**{k: r[k] for k in
                            ("dtype", "itemsize", "bytes", "f32_bytes")},
                         "expect_kv_itemsize": expect_itemsize}))


# ----------------------------------------------------------------------
# Generic entry: audit one trace
# ----------------------------------------------------------------------

_inline_cache: Dict[str, Dict[int, Tuple[List[str], str]]] = {}


def _apply_inline_suppressions(findings: Sequence[Finding]) -> None:
    """Honour ``# staticcheck: disable=...`` on the line a finding names."""
    for f in findings:
        if not f.path:
            continue
        inline = _inline_cache.get(f.path)
        if inline is None:
            try:
                with open(f.path, encoding="utf-8") as fh:
                    inline = parse_inline_suppressions(fh.read())
            except OSError:
                inline = {}
            _inline_cache[f.path] = inline
        apply_inline([f], inline)


def audit_traced(trace: ProgramTrace, program: str,
                 carry_pairs: Optional[Sequence[Tuple[int, int, str]]] = None,
                 expect_fused: bool = False,
                 expect_wire_itemsize: Optional[int] = None,
                 expect_kv_itemsize: Optional[int] = None,
                 config: Optional[AuditConfig] = None,
                 report: Optional[Report] = None) -> Report:
    """Run every program rule over one :class:`ProgramTrace`.

    ``carry_pairs``: ``(input index, output index, name)`` of carried
    values (indices into ``trace.inputs`` and ``trace.outputs``).
    ``expect_fused``: assert the single-pass fused-update contract.
    ``expect_wire_itemsize``: every bucket-scale floating reduce
    collective puts at most this many bytes/elem on the wire.
    ``expect_kv_itemsize``: every paged KV read reads elements at most
    this wide.  The metrics (``report.metrics[program]``) carry the JAX
    keys ``eqns`` (ops plus kernel notes), ``consts_bytes``,
    ``hbm_passes``, ``hbm_bytes`` and ``kv_reads``, and the port's
    ``kernel_notes`` (notes per kernel) and ``backward_ops``."""
    config = config or AuditConfig()
    report = report if report is not None else Report(mode="audit")
    t0 = time.perf_counter()
    n0 = len(report.findings)
    _check_widen(trace, program, report, config)
    _check_host_transfers(trace, program, report, config)
    consts_bytes = _check_captured_consts(trace, program, report, config)
    if carry_pairs:
        _check_carry_dtypes(trace, carry_pairs, program, report)
    ops = trace.ops
    metrics: Dict[str, Any] = {
        "eqns": len(ops) + len(trace.notes),
        "consts_bytes": consts_bytes,
        "kernel_notes": trace.kernel_counts(),
        "backward_ops": sum(1 for e in ops if e.backward),
    }
    if config.count_hbm:
        per = update_passes(trace, config)
        if per:
            metrics["hbm_passes"] = {"per_grad": per}
        if expect_fused:
            _check_fused_update(per, program, report)
        rows = collective_wire_rows(trace, config)
        if rows:
            frows = [r for r in rows if r["float_payload"]]
            wire = sum(r["wire_bytes"] for r in frows)
            full = sum(r["f32_bytes"] for r in frows)
            metrics["hbm_bytes"] = {
                "collectives": rows,
                "wire_bytes": wire,
                "f32_bytes": full,
                "ratio": (full / wire) if wire else None,
            }
        if expect_wire_itemsize is not None:
            _check_hbm_bytes(rows, expect_wire_itemsize, program, report,
                             config)
        krows = kv_read_rows(trace, config)
        if krows:
            metrics["kv_reads"] = {
                "reads": krows,
                "read_bytes": sum(r["bytes"] for r in krows),
                "f32_bytes": sum(r["f32_bytes"] for r in krows),
            }
        if expect_kv_itemsize is not None:
            _check_kv_bytes(krows, expect_kv_itemsize, program, report)
    _apply_inline_suppressions(report.findings[n0:])
    report.metrics[program] = metrics
    from .. import profiler
    profiler.record_audit(program, len(report.findings) - n0,
                          time.perf_counter() - t0)
    return report


# ----------------------------------------------------------------------
# ShardedTrainer audit
# ----------------------------------------------------------------------

def audit_trainer(trainer, programs: Sequence[str] = ("train", "train_acc"),
                  batch_spec=None, config: Optional[AuditConfig] = None,
                  report: Optional[Report] = None) -> Report:
    """Audit a bound :class:`~mxnet_tpu_torch.parallel.trainer.
    ShardedTrainer`'s step programs, recorded on the trainer's device by
    :meth:`~mxnet_tpu_torch.parallel.trainer.ShardedTrainer.trace_program`
    (the trainer is left bitwise as it was).  ``fit``'s metric carry is
    checked as a dtype fixed point (the other carried state is written in
    place), a fused trainer is held to the single-pass contract, a
    compressed one to its wire width, and the HBM-pass metric is
    aggregated onto the fused plan's buckets or the comm buckets."""
    config = config or AuditConfig()
    report = report if report is not None else Report(mode="audit")
    train_kinds = ("train", "train_acc")
    for kind in programs:
        label = f"trainer.{kind}"
        trace, _ = trainer.trace_program(kind, batch_spec=batch_spec)
        carry_pairs: List[Tuple[int, int, str]] = []
        if kind == "train_acc":
            in_idx = [n for n, _ in trace.inputs].index("['_carry']")
            carry_pairs.append((in_idx, len(trace.outputs) - 1,
                                "metric carry"))
        fused_plan = trainer._fused_plan if trainer._fused else None
        expect_wire = None
        if kind in train_kinds and trainer.grad_compression is not None:
            from .. import quant
            expect_wire = quant.wire_itemsize(trainer.grad_compression)
        audit_traced(
            trace, label, carry_pairs=carry_pairs,
            expect_fused=fused_plan is not None and kind in train_kinds,
            expect_wire_itemsize=expect_wire, config=config, report=report)
        hbm = report.metrics[label].get("hbm_passes")
        if config.count_hbm and kind in train_kinds and hbm:
            per = hbm["per_grad"]
            if fused_plan is not None:
                buckets = _fused_bucket_passes(per, fused_plan)
            else:
                buckets = bucket_passes(per, trainer._params,
                                        trainer._param_names,
                                        trainer.grad_bucket_bytes)
            hbm["buckets"] = buckets
            hbm["max_reads"] = max((b["reads"] for b in buckets), default=0)
            hbm["max_writes"] = max((b["writes"] for b in buckets),
                                    default=0)
    return report


# ----------------------------------------------------------------------
# Executor / Module audit (legacy layer)
# ----------------------------------------------------------------------

_AUX_OUT_RE = re.compile(r"^\[1\]\['([^']+)'\]$")


def _executor_aux_pairs(trace: ProgramTrace) -> List[Tuple[int, int, str]]:
    """A training forward returns ``(heads, aux updates)``: pair each aux
    output with its declared aux input by name."""
    index = {n: i for i, (n, _) in enumerate(trace.inputs)}
    pairs = []
    for out_idx, (name, _) in enumerate(trace.outputs):
        m = _AUX_OUT_RE.match(name)
        if m and f"['aux'][{m.group(1)!r}]" in index:
            pairs.append((index[f"['aux'][{m.group(1)!r}]"], out_idx,
                          f"aux:{m.group(1)}"))
    return pairs


def audit_executor(exc, train: Optional[bool] = None,
                   config: Optional[AuditConfig] = None,
                   report: Optional[Report] = None,
                   label: str = "executor") -> Report:
    """Audit an :class:`~mxnet_tpu_torch.executor.Executor`'s programs on
    its device (the inference forward and, when gradients are bound, the
    training forward and the fused forward/backward).  The training
    forward's aux updates are checked as a dtype fixed point against the
    aux states it read.  The bound arrays are left as they were."""
    from ..context import resolve_device
    config = config or AuditConfig()
    report = report if report is not None else Report(mode="audit")
    if exc._placement is not None:
        return report  # eagerly-placed executors have no programs
    dev = resolve_device(exc._ctx)
    for kind, body, inputs, state, preserve in exc._audit_programs(train):
        name = f"{label}.{kind}"
        trace = record_program(name, body, dev, inputs=inputs, state=state,
                               preserve=preserve)
        audit_traced(trace, name, carry_pairs=_executor_aux_pairs(trace),
                     config=config, report=report)
    return report


def audit_module(mod, config: Optional[AuditConfig] = None,
                 report: Optional[Report] = None) -> Report:
    """Audit every executor in a bound Module's executor group."""
    report = report if report is not None else Report(mode="audit")
    group = getattr(mod, "_exec_group", None)
    execs = getattr(group, "execs", None) or []
    for i, exc in enumerate(execs):
        audit_executor(exc, config=config, report=report,
                       label=f"module.exec{i}")
    return report


# ----------------------------------------------------------------------
# Legacy optimizer update audit
# ----------------------------------------------------------------------

def audit_optimizer(opt, weight_shape: Tuple[int, ...] = (16,),
                    dtype=torch.float32, device=None,
                    config: Optional[AuditConfig] = None,
                    report: Optional[Report] = None) -> Report:
    """Audit one ``Optimizer._functional_step`` update over a weight of
    ``weight_shape`` on ``device`` (default: the card).  The shared rules
    only: the JAX audit's donation contract has no counterpart (the port
    donates no buffer), so no ``donation`` metric is written."""
    from ..context import resolve_device
    config = config or AuditConfig()
    report = report if report is not None else Report(mode="audit")
    dev = resolve_device(device)
    w = torch.zeros(weight_shape, dtype=dtype, device=dev)
    g = torch.zeros(weight_shape, dtype=dtype, device=dev)
    state = opt.state_zeros_like(w)
    hyper = opt._hyper()
    rng = (torch.Generator(device=dev).manual_seed(0)
           if opt._needs_rng else None)
    step = type(opt)._functional_step
    label = f"optimizer.{type(opt).__name__}"
    trace = record_program(
        label, lambda: step(hyper, w, g, state, 0.1, 0.0, 1, rng), dev,
        inputs={"w": w, "g": g, "state": state})
    audit_traced(trace, label, config=config, report=report)
    return report


# ----------------------------------------------------------------------
# pytest helper
# ----------------------------------------------------------------------

def assert_program_clean(target, programs: Sequence[str] = ("train",),
                         batch_spec=None,
                         config: Optional[AuditConfig] = None) -> Report:
    """Audit ``target`` (a ShardedTrainer, Module, Executor, Optimizer,
    or an already-built Report) and raise ``AssertionError`` listing
    every unsuppressed error if the program is not hazard-free.  Returns
    the report so tests can pin metrics (e.g. the HBM pass count)."""
    if isinstance(target, Report):
        report = target
    else:
        from ..optimizer import Optimizer
        from ..parallel.trainer import ShardedTrainer
        if isinstance(target, ShardedTrainer):
            report = audit_trainer(target, programs=programs,
                                   batch_spec=batch_spec, config=config)
        elif isinstance(target, Optimizer):
            report = audit_optimizer(target, config=config)
        elif hasattr(target, "_exec_group"):
            report = audit_module(target, config=config)
        elif hasattr(target, "_audit_programs"):
            report = audit_executor(target, config=config)
        else:
            raise TypeError(f"cannot audit {type(target).__name__}")
    bad = report.unsuppressed("error")
    if bad:
        lines = "\n".join(f.format() for f in bad)
        raise AssertionError(
            f"program audit found {len(bad)} hazard(s):\n{lines}")
    return report


# ----------------------------------------------------------------------
# Live audit of the compile path
# ----------------------------------------------------------------------

@contextlib.contextmanager
def audit_on_compile(report: Optional[Report] = None,
                     config: Optional[AuditConfig] = None):
    """Audit every program the framework builds while the context is
    active, through the compile cache's capture observers: on the card
    the recorded iteration is the captured one; on the CPU (and for a
    program that runs eagerly) the body runs once, recorded, with the
    owner's state and the random state restored.

    Only cache *misses* are seen (a hit builds nothing).  The shared
    rules run per program; the trainer's carry and bucket cross-checks
    need its index maps and remain :func:`audit_trainer`'s job.

        with analysis.audit_on_compile() as report:
            trainer.compile(programs=("train",))
        assert report.clean, report.format_text()
    """
    from .. import compile_cache as cc
    report = report if report is not None else Report(mode="audit")
    cfg = config or AuditConfig()

    def observer(label, trace):
        audit_traced(trace, label, config=cfg, report=report)

    cc.add_lowering_observer(observer)
    try:
        yield report
    finally:
        cc.remove_lowering_observer(observer)
