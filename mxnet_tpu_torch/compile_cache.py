"""Program cache: captured step programs, their keys, and bucket ladders.

Counterpart of ``mxnet_tpu/compile_cache.py``.  A program of the JAX
package is an XLA executable; here it is a :class:`CapturedProgram`: one
step's device work captured once per key as a ``torch.cuda.CUDAGraph``
and replayed with one launch.  Host inputs are copied into the program's
static device buffers before a replay; outputs are read from its static
output buffers.

* :class:`ProgramCache` is the in-process LRU the JAX class is, keyed by
  :func:`program_key` (graph fingerprint, tensor avals, donation set,
  mesh, backend, torch/CUDA versions), with the same ``lookup`` / ``put``
  / ``get_or_compile`` / ``entries`` / ``evict`` / ``clear`` surface and
  ``stats`` keys.
* :func:`enable_persistent_cache` points the nvcc builds of ``csrc/``
  at ``<dir>/cuda``: the counterpart of the JAX package's XLA cache
  under ``<dir>/xla``.
* :class:`BucketPolicy` / :func:`bucket_for` / :func:`pad_to_bucket`
  canonicalise dynamic shapes onto a few padded buckets, so a server or a
  bucketing module runs one of a few programs.

Three differences from the JAX package, by design:

1. **A graph is bound to the addresses it captured.**  A JAX executable
   takes the parameters as arguments, so a second trainer reuses the
   first one's program; a graph reads the storage it was captured over.
   Every key therefore carries its owner's token (:func:`owner_token`,
   unique for the process's life): a second trainer misses and captures
   its own graph, while a re-``compile()`` of the same trainer (or a
   re-``warmup()`` of the same engine) is a ``"memory"`` hit.  No replay
   reads another object's tensors.  The cache holds programs weakly: an
   owner that is gone takes its programs (and their graph memory) along.
2. **A graph cannot be serialized.**  The disk layer keeps the JSON
   sidecar of each key (``<dir>/programs/<digest>.json``: the JAX
   sidecar's fields, with no payload), so :meth:`ProgramCache.entries`
   and :meth:`ProgramCache.evict` work, and the kernel libraries under
   ``<dir>/cuda``: a restarted process skips nvcc and recaptures.
   ``stats["disk_hits"]`` counts kernel libraries loaded from disk.
3. **Sources of a resolution** are ``"capture"`` (a fresh graph on the
   card), ``"memory"`` (a hit) or ``"eager"``: on the CPU the same
   static-buffer program runs its body on every call without capture
   (the CPU tests exercise the plumbing so), and on the card a program
   that cannot be captured (a graph with a Python custom op or a
   sampling op, the engine's poison step) runs eagerly, with a
   ``reason`` and a ``compile_cache.uncaptured`` count.  A capture that
   fails for any other reason raises, naming the program.

The kernels count their launches in Python, and that code runs only at
capture.  A :class:`CapturedProgram` records the counts its capture
added (``launches``, ``launches_fp8``, ``launches_by_form``,
``launches_by_route``), takes them back (a capture launches nothing),
and adds them again on every replay, so the counts stay those of the
kernels that ran whether a step was replayed or eager.

Env knobs, read as the JAX package reads them:

* ``MXNET_TPU_CACHE_DIR`` — the disk layer, and the kernel builds under
  ``<dir>/cuda``.
* ``MXNET_TPU_CACHE=0`` — no program caching (memory or disk).
* ``MXNET_TPU_CACHE_MAX_ENTRIES`` — the LRU's capacity (default 64).
* ``MXNET_TPU_MAX_BUCKETS`` — the bucketing module's runaway threshold.

Capture observers (:func:`add_lowering_observer`,
:func:`notify_lowering`), the JAX package's lowering observers: with an
observer registered, :meth:`CapturedProgram.build` records the captured
iteration (on the CPU, or for a program with a ``reason``, one eager run
of the body with the owner's state and the random state restored) as a
:class:`~mxnet_tpu_torch.analysis.program.ProgramTrace` and offers it to
every observer (``analysis.audit_on_compile``).  With none, nothing is
recorded.  An observer's error is logged, counted in
``compile_cache.observer_errors`` and never raised.
"""
from __future__ import annotations

import gc
import hashlib
import itertools
import json
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError

__all__ = ["ProgramCache", "CacheKey", "CapturedProgram", "program_key",
           "describe_avals", "mesh_fingerprint", "backend_of",
           "owner_token", "graph_uncapturable", "snapshot_state",
           "get_cache", "configure", "add_lowering_observer",
           "remove_lowering_observer", "notify_lowering",
           "enable_persistent_cache", "BucketPolicy", "bucket_for",
           "pad_to_bucket"]

_log = logging.getLogger(__name__)

ENV_CACHE_DIR = "MXNET_TPU_CACHE_DIR"
ENV_CACHE = "MXNET_TPU_CACHE"
ENV_CACHE_MAX_ENTRIES = "MXNET_TPU_CACHE_MAX_ENTRIES"
ENV_MAX_BUCKETS = "MXNET_TPU_MAX_BUCKETS"


# ---------------------------------------------------------------------------
# Cache keys
# ---------------------------------------------------------------------------

def _versions() -> str:
    return f"torch={torch.__version__};cuda={torch.version.cuda}"


def _flatten(tree):
    """``(structure string, leaves)`` of nested dicts (sorted keys, as JAX
    flattens them), lists and tuples."""
    if isinstance(tree, dict):
        parts, leaves = [], []
        for k in sorted(tree):
            s, ls = _flatten(tree[k])
            parts.append(f"{k!r}:{s}")
            leaves += ls
        return "{" + ",".join(parts) + "}", leaves
    if isinstance(tree, (list, tuple)):
        parts, leaves = [], []
        for v in tree:
            s, ls = _flatten(v)
            parts.append(s)
            leaves += ls
        br = "[]" if isinstance(tree, list) else "()"
        return br[0] + ",".join(parts) + br[1], leaves
    if tree is None:
        return "None", []
    return "*", [tree]


def describe_avals(tree) -> str:
    """Canonical string for a tree of tensors (or anything with
    ``shape``/``dtype``; a ``device="meta"`` tensor describes a shape
    alone): per leaf ``index:shape:dtype:device``.  The device matters: a
    graph captured on one card never runs on another."""
    struct, leaves = _flatten(tree)
    parts = []
    for i, leaf in enumerate(leaves):
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = str(getattr(leaf, "dtype", type(leaf).__name__))
        dev = getattr(leaf, "device", None)
        parts.append(f"{i}:{shape}:{dtype}:{dev}")
    return f"{struct}|" + ";".join(parts)


def mesh_fingerprint(mesh) -> str:
    """Mesh identity for the key, the JAX package's string: axis names
    and sizes, device kinds (``cpu``, or the CUDA device's name) and
    context ids.  Two meshes of one shape over other devices key
    different programs."""
    if mesh is None:
        return "mesh=None"
    from .parallel.mesh import Mesh
    if not isinstance(mesh, Mesh):
        raise MXNetError(f"mesh_fingerprint: expected a parallel.Mesh, got "
                         f"{type(mesh).__name__}")
    members = list(mesh.members)
    kinds = sorted({"cpu" if m.device_type == "cpu"
                    else torch.cuda.get_device_name(m.device_id)
                    for m in members})
    ids = tuple(m.device_id for m in members)
    return (f"axes={tuple(mesh.axis_names)};shape={tuple(mesh.devices.shape)};"
            f"kinds={kinds};ids={ids}")


def backend_of(device=None) -> str:
    """``cuda:<device name>`` for a CUDA device (default: the card when
    there is one), else ``cpu``."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    return f"cuda:{torch.cuda.get_device_name(idx)}"


_owner_ids = itertools.count(1)


def owner_token(owner) -> str:
    """A token naming ``owner`` for the process's life (never reused, as
    ``id()`` is): the key field that binds a program to the storage it
    was captured over."""
    tok = getattr(owner, "_program_owner", None)
    if tok is None:
        tok = f"{type(owner).__name__}#{os.getpid()}.{next(_owner_ids)}"
        owner._program_owner = tok
    return tok


class CacheKey:
    """Hashable identity of one program.  ``digest`` is the sha256 over
    every field, in sorted order; ``fields`` stay readable."""

    def __init__(self, fields: Dict[str, str]):
        self.fields = dict(fields)
        h = hashlib.sha256()
        for k in sorted(self.fields):
            h.update(k.encode())
            h.update(b"\x00")
            h.update(str(self.fields[k]).encode())
            h.update(b"\x01")
        self.digest = h.hexdigest()

    def __hash__(self):
        return hash(self.digest)

    def __eq__(self, other):
        return isinstance(other, CacheKey) and other.digest == self.digest

    def __repr__(self):
        return f"CacheKey({self.digest[:12]})"

    def describe(self) -> Dict[str, str]:
        return dict(self.fields)


def program_key(fingerprint: str, avals=None, donate: Sequence[int] = (),
                mesh=None, backend: Optional[str] = None,
                extra: Optional[Dict[str, Any]] = None) -> CacheKey:
    """The :class:`CacheKey` of one program: ``fingerprint`` is the graph
    identity (:func:`mxnet_tpu_torch.graph_eval.graph_fingerprint` for
    symbols), ``avals`` a tree of the call's tensors, ``donate`` the
    donated argument positions (kept for the JAX key's shape), ``extra``
    every other setting that changes the program (the owner's token
    among them).  ``backend`` defaults to :func:`backend_of`."""
    fields = {
        "fingerprint": str(fingerprint),
        "avals": describe_avals(avals) if avals is not None else "",
        "donate": str(tuple(donate)),
        "mesh": mesh_fingerprint(mesh),
        "backend": backend or backend_of(),
        "versions": _versions(),
    }
    for k, v in (extra or {}).items():
        fields[f"x:{k}"] = str(v)
    return CacheKey(fields)


# ---------------------------------------------------------------------------
# Launch counters under replay
# ---------------------------------------------------------------------------

_COUNTER_ATTRS = ("launches", "launches_fp8", "launches_by_form",
                  "launches_by_route")


def _counted_kernels():
    """The wrappers that count their kernels' launches in Python."""
    from . import quant
    from .ops import fused_update, nn_ops
    from .parallel import flash_attention
    from .serve import flash_decode
    return (nn_ops.softmax_rows, fused_update.fused_update,
            flash_attention.flash_fwd, flash_attention.flash_bwd,
            flash_decode.flash_decode_attention, quant.block_dot)


def _counter_snapshot() -> Dict[Tuple[Any, str], Any]:
    snap = {}
    for fn in _counted_kernels():
        for attr in _COUNTER_ATTRS:
            v = getattr(fn, attr, None)
            if v is not None:
                snap[(fn, attr)] = dict(v) if isinstance(v, dict) else int(v)
    return snap


def _counter_delta(before, after) -> List[Tuple[Any, str, Any, int]]:
    """``[(wrapper, attribute, key or None, added)]`` between snapshots."""
    out = []
    for (fn, attr), now in after.items():
        was = before.get((fn, attr))
        if isinstance(now, dict):
            for k, v in now.items():
                d = v - (was or {}).get(k, 0)
                if d:
                    out.append((fn, attr, k, d))
        elif now - (was or 0):
            out.append((fn, attr, None, now - (was or 0)))
    return out


def _apply_delta(delta, sign: int) -> None:
    for fn, attr, key, d in delta:
        if key is None:
            setattr(fn, attr, getattr(fn, attr) + sign * d)
        else:
            counts = getattr(fn, attr)
            counts[key] = counts.get(key, 0) + sign * d


# ---------------------------------------------------------------------------
# Capture observers
# ---------------------------------------------------------------------------
#
# The program auditor (mxnet_tpu_torch.analysis) taps the build path
# here: every program built on its way INTO the cache is offered to the
# registered observers as a ProgramTrace of the iteration that was
# captured, so ``analysis.audit_on_compile()`` inspects the ops the graph
# holds.  Observers see cache misses only (a hit builds nothing).

_lowering_observers: List[Callable[[str, Any], None]] = []
_observer_lock = threading.Lock()


def add_lowering_observer(fn: Callable[[str, Any], None]) -> None:
    """Register ``fn(label, trace)`` to be called for every program built
    while registered."""
    with _observer_lock:
        if fn not in _lowering_observers:
            _lowering_observers.append(fn)


def remove_lowering_observer(fn: Callable[[str, Any], None]) -> None:
    with _observer_lock:
        if fn in _lowering_observers:
            _lowering_observers.remove(fn)


def lowering_observers() -> List[Callable[[str, Any], None]]:
    """The registered observers (a snapshot)."""
    with _observer_lock:
        return list(_lowering_observers)


def _observer_failed(what: str, label: str) -> None:
    from . import telemetry
    telemetry.counter("compile_cache.observer_errors").inc()
    _log.exception("%s failed on %r", what, label)


def notify_lowering(label: str, trace: Any) -> None:
    """Offer a freshly recorded program to the observers.  An observer's
    error is logged and counted (``compile_cache.observer_errors``),
    never raised: an analysis bug must not break a build."""
    observers = lowering_observers()
    if not observers:
        return
    from . import telemetry
    with telemetry.span("compile.lowering", label=label,
                        observers=len(observers)):
        for fn in observers:
            try:
                fn(label, trace)
            except Exception:
                _observer_failed(f"capture observer {fn!r}", label)


# ---------------------------------------------------------------------------
# Captured programs
# ---------------------------------------------------------------------------

_capture_streams: Dict[int, "torch.cuda.Stream"] = {}
_stream_lock = threading.Lock()


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per device for warm-up and capture.  Kernel
    wrappers that cache buffers per stream (flash decode's tickets) then
    allocate them during the warm-up, outside any graph's pool."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _stream_lock:
        s = _capture_streams.get(idx)
        if s is None:
            s = _capture_streams[idx] = torch.cuda.Stream(device=idx)
        return s


def snapshot_state(tensors: Sequence[torch.Tensor]) -> Callable[[], None]:
    """Clone ``tensors`` now; the returned function copies the clones back
    into the same storage (a program's warm-up must leave its owner's
    state bitwise as it found it)."""
    saved = [(t, t.detach().clone()) for t in tensors]

    def restore():
        with torch.no_grad():
            for t, c in saved:
                t.copy_(c)
    return restore


_HOST_OPS = ("_PythonOp", "Custom")


def graph_uncapturable(topo) -> Optional[str]:
    """Why a symbol graph's program cannot be captured, or None: a Python
    custom op runs its body on the host (the JAX executor likewise
    compiles no program for host-callback placement), and a sampling op
    draws from a generator the host seeds per call, so a replay would
    repeat the captured draws."""
    ops = [n.op for n in topo if not n.is_variable]
    host = sorted({op.name for op in ops if op.name in _HOST_OPS})
    if host:
        return f"the graph runs Python custom ops on the host ({host})"
    rng = sorted({op.name for op in ops if op.needs_rng})
    if rng:
        return (f"sampling ops {rng} draw from generators the host seeds "
                "per call; a replay would repeat the captured draws")
    return None


class CapturedProgram:
    """One step's device work as a program: the counterpart of the JAX
    package's AOT executable (``_AotProgram``).

    ``body()`` runs the step on the owner's static buffers (its inputs
    are copied in before each call) and returns its outputs (a tensor or
    a tree of them).  On the card, :meth:`build` runs ``warmup_iters``
    iterations on a side stream (autograd's lazy state, cuBLAS
    workspaces, cuDNN's algorithm search happen there, never in the
    capture), restores what they changed through ``preserve()`` (called
    before them; it returns the restoring function), then captures one
    iteration into a graph whose memory comes from ``pool`` (an owner's
    programs share one, ``torch.cuda.graph_pool_handle()``).  Calling the
    program replays the graph and returns the static outputs: read or
    clone them before the next replay of any program of the same pool.

    On the CPU, or with a ``reason`` (a program that cannot be captured),
    calling the program runs ``body()``.  ``inputs`` names the static
    input buffers the body reads (:meth:`stage` copies values in);
    ``state()`` returns the owner's tensors the body reads or writes
    (weights, optimizer state, pools): with the inputs, what a capture
    observer's trace declares, so only tensors no one declared count as
    captured constants.
    """

    #: eager iterations before the capture (side stream, undone)
    warmup_iters = 2

    def __init__(self, label: str, body: Callable[[], Any], device,
                 preserve: Optional[Callable[[], Callable[[], None]]] = None,
                 pool=None, reason: Optional[str] = None,
                 inputs: Optional[Dict[str, torch.Tensor]] = None,
                 state: Optional[Callable[[], Sequence[torch.Tensor]]]
                 = None):
        self.label = label
        self.body = body
        self.inputs = dict(inputs or {})
        self.state = state
        self.device = torch.device(device)
        self.preserve = preserve
        self.pool = pool
        self.reason = reason
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.outputs = None
        self.replays = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self._delta: List[Tuple[Any, str, Any, int]] = []

    @property
    def source(self) -> str:
        return "capture" if self.graph is not None else "eager"

    def build(self) -> "CapturedProgram":
        """Capture the graph (on the card, without a ``reason``); else
        nothing.  Raises :class:`MXNetError` naming the program when the
        capture fails."""
        if self.reason is not None:
            from . import telemetry
            telemetry.counter("compile_cache.uncaptured").inc()
            _log.info("program %s runs eagerly: %s", self.label, self.reason)
        observing = bool(lowering_observers())
        if self.device.type != "cuda" or self.reason is not None:
            if observing:
                self._observe_eager()
            return self
        t0 = time.perf_counter()
        dev = self.device
        side = _capture_stream(dev)
        restore = self.preserve() if self.preserve is not None else None
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(self.warmup_iters):
                self.body()
        torch.cuda.current_stream(dev).wait_stream(side)
        if restore is not None:
            restore()
        torch.cuda.synchronize(dev)
        # the capture empties the allocator's cache first; so does this,
        # so the reserved bytes grow by the graph's pool alone
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = _counter_snapshot()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collected cycle
        # that frees pinned host memory or event-tracked blocks makes
        # CUDA calls a capture forbids (the capture then fails at random,
        # after whatever left the cycle); dead cycles go first, here
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the port's own threads (a prefetcher staging
            # the next batch, a checkpoint writer, a profiler's) keep
            # making CUDA calls, which must not end a capture they never
            # touch; this thread's unsafe calls still fail it
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                if observing:
                    # metadata only: reading a value would end the capture
                    from .analysis import program
                    with program.recording(self.label, dev, self.inputs,
                                           self._declared_state()) as rec:
                        out = self.body()
                        rec.set_outputs(out)
                else:
                    out = self.body()
        except Exception as exc:
            raise MXNetError(f"capture of program {self.label!r} failed: "
                             f"{type(exc).__name__}: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
        self._delta = _counter_delta(before, _counter_snapshot())
        _apply_delta(self._delta, -1)        # the capture launched nothing
        self.graph, self.outputs = graph, out
        # bytes the capture reserved (0 when it reused a shared pool's)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_seconds = time.perf_counter() - t0
        if observing:
            notify_lowering(self.label, rec.trace)
        return self

    def _declared_state(self) -> Sequence[torch.Tensor]:
        return list(self.state()) if self.state is not None else []

    def _observe_eager(self) -> None:
        """For the observers of a program that is not captured: record one
        run of the body with the owner's state (``preserve``) and the
        random state restored."""
        from .analysis import program
        try:
            trace = program.record_program(
                self.label, self.body, self.device, inputs=self.inputs,
                state=self._declared_state(), preserve=self.preserve)
        except Exception:
            _observer_failed("recording for the capture observers",
                             self.label)
            return
        notify_lowering(self.label, trace)

    def stage(self, values: Dict[str, torch.Tensor]) -> None:
        """Copy ``values`` into the static input buffers of their names."""
        with torch.no_grad():
            for name, v in values.items():
                self.inputs[name].copy_(v, non_blocking=True)

    def __call__(self):
        if self.graph is None:
            return self.body()
        self.graph.replay()
        _apply_delta(self._delta, +1)
        self.replays += 1
        return self.outputs


# ---------------------------------------------------------------------------
# Program cache
# ---------------------------------------------------------------------------

def _atomic_write(path: str, payload: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


class ProgramCache:
    """LRU of programs with a sidecar-only disk layer.

    Memory entries refer to live programs (weakly, when a program can be
    referred to so: its owner keeps it alive); disk entries are the JSON
    sidecars of every key resolved with a ``cache_dir``.  Lookup order:
    memory -> build.  Every resolution is recorded in ``stats`` and as a
    profiler compile event (:func:`mxnet_tpu_torch.profiler.
    record_compile`)."""

    def __init__(self, cache_dir: Optional[str] = None,
                 max_entries: int = 64, enabled: bool = True):
        self.cache_dir = cache_dir
        self.max_entries = max(1, int(max_entries))
        self.enabled = enabled
        self._mem: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.RLock()
        self._disk_broken = False
        self.stats = {"memory_hits": 0, "disk_hits": 0, "misses": 0,
                      "puts": 0, "disk_errors": 0}

    # -- paths ----------------------------------------------------------

    def _progdir(self) -> Optional[str]:
        if self.cache_dir is None or self._disk_broken:
            return None
        d = os.path.join(self.cache_dir, "programs")
        try:
            os.makedirs(d, exist_ok=True)
        except OSError as e:
            _log.warning("program cache dir %s unusable (%s); disk layer off",
                         d, e)
            self._disk_broken = True
            return None
        return d

    # -- core -----------------------------------------------------------

    def lookup(self, key: CacheKey):
        """The live program of ``key`` in memory, or None."""
        if not self.enabled:
            return None
        with self._lock:
            ref = self._mem.get(key.digest)
            prog = ref() if isinstance(ref, weakref.ref) else ref
            if prog is None:
                self._mem.pop(key.digest, None)
                return None
            self._mem.move_to_end(key.digest)
        self._bump_stat("memory_hits")
        return prog

    def put(self, key: CacheKey, program, label: str = "",
            compile_seconds: float = 0.0) -> None:
        if not self.enabled:
            return
        self._mem_put(key.digest, program)
        self._bump_stat("puts")
        self._disk_store(key, label, compile_seconds)

    def get_or_compile(self, key: CacheKey, compile_fn: Callable[[], Any],
                       label: str = "") -> Tuple[Any, Dict[str, Any]]:
        """Resolve ``key`` -> program; ``compile_fn`` runs on a miss.
        Returns ``(program, info)``: ``info["source"]`` is ``"memory"``,
        else the built program's ``source`` (``"capture"`` or
        ``"eager"``, with its ``reason``), and ``info["seconds"]`` the
        time the resolution took."""
        t0 = time.perf_counter()
        prog = self.lookup(key)
        if prog is not None:
            info = {"source": "memory",
                    "seconds": time.perf_counter() - t0,
                    "digest": key.digest}
            self._record(label, info)
            return prog, info
        from . import telemetry
        with telemetry.span("compile.build", label=label or "program",
                            digest=key.digest[:12]):
            prog = compile_fn()
        seconds = time.perf_counter() - t0
        self._bump_stat("misses")
        self.put(key, prog, label=label, compile_seconds=seconds)
        info = {"source": getattr(prog, "source", "compile"),
                "seconds": seconds, "digest": key.digest}
        if getattr(prog, "reason", None):
            info["reason"] = prog.reason
        self._record(label, info)
        return prog, info

    def _bump_stat(self, key: str) -> None:
        """Increment a stat and its telemetry mirror
        (``compile_cache.<stat>``)."""
        self.stats[key] += 1
        from . import telemetry
        telemetry.counter(f"compile_cache.{key}").inc()

    def _record(self, label: str, info: Dict[str, Any]) -> None:
        from . import profiler
        profiler.record_compile(label or "program", info["seconds"],
                                source=info["source"],
                                digest=info["digest"])

    def _mem_put(self, digest: str, program) -> None:
        try:
            ref = weakref.ref(program)
        except TypeError:
            ref = program
        with self._lock:
            self._mem[digest] = ref
            self._mem.move_to_end(digest)
            while len(self._mem) > self.max_entries:
                self._mem.popitem(last=False)

    # -- disk layer: sidecars only (a graph cannot be serialized) --------

    def _disk_store(self, key: CacheKey, label: str,
                    compile_seconds: float) -> None:
        d = self._progdir()
        if d is None:
            return
        try:
            meta = {"digest": key.digest, "label": label,
                    "compile_seconds": round(compile_seconds, 4),
                    "created": time.time(),
                    # the JAX sidecar's size of the serialized executable
                    "payload_bytes": 0,
                    "fields": key.describe()}
            _atomic_write(os.path.join(d, f"{key.digest}.json"),
                          json.dumps(meta, indent=1).encode())
        except Exception as e:
            self._bump_stat("disk_errors")
            _log.debug("program cache: could not persist %s (%s)",
                       key.digest[:12], e)

    def note_disk_hit(self) -> None:
        """A kernel library loaded from ``<cache_dir>/cuda``."""
        self._bump_stat("disk_hits")

    # -- maintenance -----------------------------------------------------

    def clear_memory(self) -> None:
        """Drop the in-process LRU (sidecars survive)."""
        with self._lock:
            self._mem.clear()

    def clear(self) -> None:
        self.clear_memory()
        d = self._progdir()
        if d is None:
            return
        for name in os.listdir(d):
            if name.endswith(".json"):
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass

    def entries(self) -> List[Dict[str, Any]]:
        """Sidecar metadata, one dict per persisted key."""
        d = self._progdir()
        out = []
        if d is None:
            return out
        for name in sorted(os.listdir(d)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name)) as f:
                    out.append(json.load(f))
            except Exception:
                continue
        return out

    def evict(self, digest: str) -> bool:
        """Remove one entry (memory and sidecar) by digest prefix."""
        removed = False
        with self._lock:
            for full in [k for k in self._mem if k.startswith(digest)]:
                del self._mem[full]
                removed = True
        d = self._progdir()
        if d is not None:
            for name in os.listdir(d):
                if name.startswith(digest) and name.endswith(".json"):
                    try:
                        os.remove(os.path.join(d, name))
                        removed = True
                    except OSError:
                        pass
        return removed


# ---------------------------------------------------------------------------
# Global cache singleton + the persistent kernel builds
# ---------------------------------------------------------------------------

_global: Dict[str, Any] = {"cache": None}
_glock = threading.Lock()


def enable_persistent_cache(cache_dir: str) -> None:
    """Build (and load) the ``csrc/`` kernel libraries under
    ``<cache_dir>/cuda``: a restarted process with the same directory
    runs no nvcc."""
    from . import _build
    cuda_dir = os.path.join(cache_dir, "cuda")
    os.makedirs(cuda_dir, exist_ok=True)
    _build.set_build_dir(cuda_dir)


def configure(cache_dir: Optional[str] = None,
              max_entries: Optional[int] = None,
              enabled: Optional[bool] = None,
              wire_build_cache: bool = True) -> ProgramCache:
    """(Re)build the global :class:`ProgramCache`.  With ``cache_dir`` the
    sidecar layer turns on and (unless ``wire_build_cache=False``) the
    kernel builds go under the same root."""
    with _glock:
        cur = _global["cache"]
        cache = ProgramCache(
            cache_dir=cache_dir,
            max_entries=(max_entries if max_entries is not None
                         else (cur.max_entries if cur else 64)),
            enabled=(enabled if enabled is not None else True))
        if cache_dir and wire_build_cache and cache.enabled:
            enable_persistent_cache(cache_dir)
        _global["cache"] = cache
        return cache


def get_cache() -> ProgramCache:
    """Global cache, auto-configured from the environment on first use."""
    with _glock:
        if _global["cache"] is None:
            enabled = os.environ.get(ENV_CACHE, "1") != "0"
            cache_dir = os.environ.get(ENV_CACHE_DIR) or None
            max_entries = int(os.environ.get(ENV_CACHE_MAX_ENTRIES, "64"))
            cache = ProgramCache(cache_dir=cache_dir if enabled else None,
                                 max_entries=max_entries, enabled=enabled)
            if enabled and cache_dir:
                enable_persistent_cache(cache_dir)
            _global["cache"] = cache
        return _global["cache"]


# ---------------------------------------------------------------------------
# Bucket-shape canonicalization
# ---------------------------------------------------------------------------

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
