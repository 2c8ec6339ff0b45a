"""Runtime concurrency sanitizer for the port's threaded control plane.

Counterpart of ``mxnet_tpu/analysis/concurrency.py``; the analysis is
plain Python and the same (the crc32 schedule decisions, the
happens-before edges, the three rules).  The port runs real threads
beside the card's work — the async checkpoint writer (whose snapshot
copies CUDA tensors to pinned host memory before the next captured step
writes them in place), the device prefetcher (staging batches on a side
stream from a daemon thread), the telemetry emitter and flight ring, the
program cache, and the serving router (whose replicas replay CUDA graphs
while a client thread pulls tokens) — and every byte-identity guarantee
assumes they never race on shared state.  This module checks that
assumption: observe what actually runs, report typed findings, gate in
CI.

Three instruments behind one context manager::

    with audit_threads() as audit:        # or audit_threads(report=rep)
        audit.track(obj, "_ring", label="FlightRecorder._ring")
        ... run the threaded scenario ...
    audit.report    # conc.* findings

1. **Lockset race detection** (``conc.data-race``) — eraser-style: every
   read/write of a *tracked* shared object records the set of
   instrumented locks held; two conflicting accesses from different
   threads with an empty lockset intersection race, unless a
   happens-before edge orders them.  HB edges come only from real
   publication points — ``Event.set -> wait/is_set``, ``Queue.put ->
   get``, ``Condition.notify -> wait``, ``Thread.start -> run`` and
   ``run-end -> join`` — deliberately *not* from plain lock
   release/acquire, so a racy schedule that happened to serialize this
   run is still caught (the Eraser schedule-insensitivity property).
   A lock-free publish through an Event is therefore *benign by
   construction*, not by suppression.
2. **Lock-order audit** (``conc.lock-order``) — acquiring L while
   holding H adds edge H->L to the acquisition graph; a cycle is a
   potential deadlock even when this particular run got lucky.
   Reentrant re-acquires are excluded.
3. **Blocking-under-lock** (``conc.blocking-under-lock``) — queue
   get/put (bounded), ``Event.wait``, ``Thread.join``, ``time.sleep``
   and ``open()`` while holding an instrumented lock.  A
   ``Condition.wait`` releases its own lock and is exempt from it.

Instrumentation is scoped: only primitives *created* inside the
``audit_threads()`` window are instrumented (``threading.Lock/RLock/
Condition/Event/Thread`` and ``queue.Queue`` are monkey-patched for the
duration), plus whatever pre-existing framework objects the caller
registers via :meth:`ThreadAudit.track` / :meth:`ThreadAudit.wrap_lock`
/ :meth:`ThreadAudit.instrument_framework`.  Everything is restored on
exit.  The window sees host threads only: CUDA streams are invisible to
it, so an ordering between a copy and a kernel is checked by the bytes a
scenario compares, not by the lockset.  A CUDA-graph capture inside the
window is legal: a fuzzer preemption is a host sleep, and the port's
capture (``capture_error_mode="thread_local"``) is not ended by what
other threads do.

Findings carry the source site of the offending access, so the
existing inline plumbing (``# staticcheck: disable=conc.* -- reason``)
suppresses them exactly like lint findings.

The same instrumentation hooks drive the **deterministic schedule
fuzzer**: ``audit_threads(fuzzer=ScheduleFuzzer(seed), record=False)``
turns every lock boundary into a seeded preemption point
(:class:`ScheduleFuzzer` decides via ``crc32(seed:thread:counter)`` —
replayable by seed, unlike Python's randomized ``hash``), and
:func:`run_schedules` sweeps N seeds per scenario from
:mod:`.schedules` on a device (the card unless the caller passes
``device="cpu"``), asserting the byte-identity invariants under every
interleaving.  ``MXNET_TPU_CONC_SCHEDULES`` / ``MXNET_TPU_CONC_SEED``
set the sweep size and base seed (``mxnet_tpu_torch/ENV_VARS.md``).
"""

from __future__ import annotations

import binascii
import builtins
import itertools
import os
import queue as queue_mod
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

from .findings import (Finding, Report, apply_inline,
                       parse_inline_suppressions)

__all__ = ["ThreadAudit", "audit_threads", "ScheduleFuzzer",
           "run_schedules", "analyze_events"]

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
_THIS_FILE = os.path.abspath(__file__)

# captured at import so a patched time.sleep can never recurse into the
# fuzzer's own preemption sleeps
_ORIG_SLEEP = time.sleep
_ORIG_OPEN = builtins.open

# mutating / reading method names for tracked containers (list, dict,
# deque, set, OrderedDict); coarse granularity — the whole container is
# one shared location
_WRITE_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "remove", "clear", "update", "setdefault",
    "add", "discard", "sort", "reverse", "rotate", "move_to_end",
    "__setitem__", "__delitem__", "__iadd__", "__ior__",
})
_READ_METHODS = frozenset({
    "get", "keys", "values", "items", "count", "index", "copy",
    "__getitem__", "__len__", "__iter__", "__contains__", "__eq__",
    "__bool__", "__repr__", "__reversed__",
})


def _thread_name() -> str:
    """Current thread's name WITHOUT ``threading.current_thread()``:
    that call constructs a ``_DummyThread`` for unregistered threads,
    and with ``threading.Event`` patched the dummy's own ``_started``
    event re-enters the instrumentation — infinite recursion.  A plain
    dict read has no side effects; unregistered threads (a bootstrap
    window in ``Thread._bootstrap_inner``, foreign C threads) get a
    stable ident-derived name."""
    ident = threading.get_ident()
    th = threading._active.get(ident)
    return th.name if th is not None else f"t{ident}"


def _site() -> Tuple[str, int]:
    """(repo-relative path, line) of the innermost caller frame that
    lives inside the repo but outside this module.  ("", 0) when the
    access came from third-party / stdlib code."""
    import sys
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if fn != _THIS_FILE and not fn.startswith("<"):
            af = os.path.abspath(fn)
            if af.startswith(_REPO_ROOT + os.sep):
                return (os.path.relpath(af, _REPO_ROOT).replace(os.sep, "/"),
                        f.f_lineno)
            return ("", 0)
        f = f.f_back
    return ("", 0)


# ----------------------------------------------------------------------
# Deterministic schedule fuzzer
# ----------------------------------------------------------------------

class ScheduleFuzzer:
    """Seeded preemption-point injector (the chaos.py philosophy applied
    to thread schedules).  Every instrumented lock/container boundary
    calls :meth:`maybe_preempt`; the decision at the k-th boundary of a
    thread is a pure function of ``(seed, thread name, k)`` via
    ``crc32`` — Python's ``hash`` is per-process randomized and would
    make schedules unreplayable.  A "preempt" is a short real sleep,
    which on a GIL interpreter reliably yields to the other runnable
    threads and drives the scenario through a different interleaving
    per seed."""

    def __init__(self, seed: int = 0, prob: float = 0.25,
                 sleep_s: float = 0.002):
        self.seed = int(seed)
        self.prob = float(prob)
        self.sleep_s = float(sleep_s)
        self._counts: Dict[str, int] = {}
        self._mu = threading.Lock()
        self.decisions: List[Tuple[str, int, bool]] = []
        self.preemptions = 0

    def maybe_preempt(self) -> None:
        name = _thread_name()
        with self._mu:
            k = self._counts.get(name, 0)
            self._counts[name] = k + 1
        h = binascii.crc32(f"{self.seed}:{name}:{k}".encode())
        fire = (h % 1000) / 1000.0 < self.prob
        with self._mu:
            self.decisions.append((name, k, fire))
            if fire:
                self.preemptions += 1
        if fire:
            # 1x..3x the base quantum, also seed-determined
            _ORIG_SLEEP(self.sleep_s * (1 + (h >> 10) % 3))


# ----------------------------------------------------------------------
# Event collection
# ----------------------------------------------------------------------

# event tuples, appended under the GIL (list.append is atomic):
#   ("acquire", tid, lock_key, site, reentrant_flag)
#   ("release", tid, lock_key, all_flag)
#   ("access",  tid, loc, is_write, site)
#   ("send",    tid, chan)
#   ("recv",    tid, chan)
#   ("block",   tid, op, site, exclude_lock_key_or_None)

class _Collector:
    def __init__(self):
        self.events: List[Tuple] = []
        self._tls = threading.local()
        self._serial = itertools.count()
        # runtime-held audit locks per thread token — used only to gate
        # the (very hot) patched open()/sleep() recording; the analysis
        # pass reconstructs held sets itself from the event stream
        self.held: Dict[str, List[str]] = {}

    def tid(self) -> str:
        t = getattr(self._tls, "token", None)
        if t is None:
            t = f"{_thread_name()}/{next(self._serial)}"
            self._tls.token = t
        return t


class _TrackedMutable:
    """Coarse access proxy around one shared container: every read/write
    method becomes an access event on a single named location.  The
    proxy forwards everything else untouched, so framework code keeps
    working while audited."""

    __slots__ = ("_obj", "_audit", "_loc")

    def __init__(self, obj, audit: "ThreadAudit", loc: str):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_audit", audit)
        object.__setattr__(self, "_loc", loc)

    def _rec(self, write: bool):
        self._audit._access(self._loc, write)

    def __getattr__(self, name):
        attr = getattr(self._obj, name)
        if callable(attr):
            if name in _WRITE_METHODS:
                audit, loc = self._audit, self._loc

                def wrapped(*a, _attr=attr, **kw):
                    audit._access(loc, True)
                    return _attr(*a, **kw)
                return wrapped
            if name in _READ_METHODS:
                audit, loc = self._audit, self._loc

                def wrapped(*a, _attr=attr, **kw):
                    audit._access(loc, False)
                    return _attr(*a, **kw)
                return wrapped
        return attr

    # special methods are looked up on the type, not the instance
    def __getitem__(self, k):
        self._rec(False)
        return self._obj[k]

    def __setitem__(self, k, v):
        self._rec(True)
        self._obj[k] = v

    def __delitem__(self, k):
        self._rec(True)
        del self._obj[k]

    def __len__(self):
        self._rec(False)
        return len(self._obj)

    def __iter__(self):
        self._rec(False)
        return iter(self._obj)

    def __contains__(self, k):
        self._rec(False)
        return k in self._obj

    def __bool__(self):
        self._rec(False)
        return bool(self._obj)

    def __repr__(self):
        return f"<tracked {self._loc}: {self._obj!r}>"


class _AuditLock:
    """Wrapper over a real lock (or RLock) that records acquire/release
    and fires the fuzzer's preemption points.  Duck-types the full lock
    protocol, including the RLock save/restore hooks ``Condition``
    needs."""

    def __init__(self, audit: "ThreadAudit", orig, label: str,
                 reentrant: bool):
        self._audit = audit
        self._orig = orig
        self._label = label
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._audit._preempt()
        got = self._orig.acquire(blocking, timeout)
        if got:
            self._audit._on_acquire(self)
        return got

    def release(self) -> None:
        self._audit._on_release(self)
        self._orig.release()
        self._audit._preempt()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._orig.locked()

    # -- RLock protocol for threading.Condition ------------------------

    def _is_owned(self):
        if hasattr(self._orig, "_is_owned"):
            return self._orig._is_owned()
        if self._orig.acquire(False):
            self._orig.release()
            return False
        return True

    def _release_save(self):
        self._audit._on_release(self, all_depths=True)
        if hasattr(self._orig, "_release_save"):
            return self._orig._release_save()
        self._orig.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._orig, "_acquire_restore"):
            self._orig._acquire_restore(state)
        else:
            self._orig.acquire()
        self._audit._on_acquire(self)


class ThreadAudit:
    """One audit window's state: patches, tracked objects, the event
    stream, and (after exit) the analyzed report."""

    def __init__(self, report: Optional[Report] = None,
                 fuzzer: Optional[ScheduleFuzzer] = None,
                 record: bool = True):
        self.report = report if report is not None else Report(mode="races")
        self.fuzzer = fuzzer
        self.record = record
        self.active = False
        self._col = _Collector()
        self._locks: Dict[str, _AuditLock] = {}   # key -> wrapper
        self._lock_serial = itertools.count()
        self._policies: Dict[str, str] = {}       # loc -> severity
        self._restores: List[Tuple[Any, str, Any]] = []
        self._patches: List[Tuple[Any, str, Any]] = []
        self._orig: Dict[str, Any] = {}

    # -- event plumbing ------------------------------------------------

    def _preempt(self):
        if self.fuzzer is not None and self.active:
            self.fuzzer.maybe_preempt()

    def _event(self, *ev):
        if self.record and self.active:
            self._col.events.append(ev)

    def _on_acquire(self, lk: _AuditLock):
        tid = self._col.tid()
        held = self._col.held.setdefault(tid, [])
        reentrant = lk._label in held
        held.append(lk._label)
        self._event("acquire", tid, lk._label, _site(), reentrant)

    def _on_release(self, lk: _AuditLock, all_depths: bool = False):
        tid = self._col.tid()
        held = self._col.held.get(tid, [])
        if all_depths:
            held[:] = [h for h in held if h != lk._label]
        elif lk._label in held:
            held.reverse()
            held.remove(lk._label)
            held.reverse()
        self._event("release", tid, lk._label, all_depths)

    def _access(self, loc: str, write: bool):
        self._preempt()
        self._event("access", self._col.tid(), loc, write, _site())

    def _send(self, chan):
        self._event("send", self._col.tid(), chan)

    def _recv(self, chan):
        self._event("recv", self._col.tid(), chan)

    def _block(self, op: str, exclude: Optional[str] = None,
               only_if_held: bool = False):
        tid = self._col.tid()
        if only_if_held and not self._col.held.get(tid):
            return
        self._event("block", tid, op, _site(), exclude)

    def _new_lock_label(self, label: Optional[str]) -> str:
        if label:
            return label
        path, line = _site()
        n = next(self._lock_serial)
        return f"{path}:{line}#L{n}" if path else f"<extern>#L{n}"

    # -- public registration API ---------------------------------------

    def make_lock(self, label: Optional[str] = None,
                  reentrant: bool = False) -> _AuditLock:
        orig = (self._orig.get("RLock", threading.RLock)() if reentrant
                else self._orig.get("Lock", threading.Lock)())
        lk = _AuditLock(self, orig, self._new_lock_label(label), reentrant)
        self._locks[lk._label] = lk
        return lk

    def wrap_lock(self, obj: Any, attr: str,
                  label: Optional[str] = None) -> _AuditLock:
        """Replace a pre-existing framework lock attribute with an
        instrumented wrapper (restored on exit)."""
        orig = getattr(obj, attr)
        if isinstance(orig, _AuditLock):
            return orig
        label = label or f"{type(obj).__name__}.{attr}"
        reentrant = hasattr(orig, "_is_owned")
        lk = _AuditLock(self, orig, label, reentrant)
        self._locks[label] = lk
        self._restores.append((obj, attr, orig))
        setattr(obj, attr, lk)
        return lk

    def track(self, obj: Any, attr: str, label: Optional[str] = None,
              policy: str = "error") -> None:
        """Wrap a container attribute in an access-recording proxy
        (restored on exit).  ``policy`` sets the severity of any
        data-race finding on this location — ``"info"`` marks a
        documented lock-free-by-design structure (observed, never
        gating)."""
        cur = getattr(obj, attr)
        if isinstance(cur, _TrackedMutable):
            return
        loc = label or f"{type(obj).__name__}.{attr}"
        self._policies[loc] = policy
        self._restores.append((obj, attr, cur))
        setattr(obj, attr, _TrackedMutable(cur, self, loc))

    def track_value(self, value: Any, label: str,
                    policy: str = "error") -> _TrackedMutable:
        """Proxy-wrap a bare container (for locals the scenario shares
        between threads)."""
        self._policies[label] = policy
        return _TrackedMutable(value, self, label)

    def instrument_framework(self) -> None:
        """Attach to the port's live singletons: the telemetry
        registry, flight ring and emitter, and the global program cache
        (its lock and its memory map).  Router/engine objects are
        per-instance — see :meth:`instrument_router`."""
        from .. import telemetry
        fr = telemetry.flight_recorder()
        self.wrap_lock(fr, "_lock", "FlightRecorder._lock")
        self.track(fr, "_ring", "FlightRecorder._ring")
        reg = telemetry.registry()
        self.wrap_lock(reg, "_lock", "Registry._lock")
        # documented lock-free hot path (metrics.py module docstring):
        # observed at info severity, never gates
        self.track(reg, "_metrics", "Registry._metrics", policy="info")
        em = telemetry._emitter
        if em is not None:
            self.wrap_lock(em, "_lock", "JsonlEmitter._lock")
        from .. import compile_cache
        cache = compile_cache.get_cache()
        self.wrap_lock(cache, "_lock", "ProgramCache._lock")
        self.track(cache, "_mem", "ProgramCache._mem")

    def instrument_router(self, router: Any) -> None:
        """Instrument one serving router + its replicas' engine-side
        shared structures (scheduler queue, block-allocator owner map,
        the replica table itself)."""
        self.wrap_lock(router, "_lock", "Router._lock")
        self.track(router, "_requests", "Router._requests")
        self.track(router, "replicas", "Router.replicas")
        for rep in router.replicas._obj:
            eng = rep.engine
            self.track(eng.sched, "queue",
                       f"Scheduler.queue[r{rep.idx}]")
            # alloc._free is REBOUND by slicing in alloc(); the stable
            # shared structure is the refcount map (a set of owners a
            # block: the prefix cache shares blocks)
            self.track(eng.alloc, "_refs",
                       f"BlockAllocator._refs[r{rep.idx}]")

    # -- patch window ---------------------------------------------------

    def _patch(self, mod, name, value):
        self._patches.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def _install(self):
        audit = self
        self._orig = {"Lock": threading.Lock, "RLock": threading.RLock,
                      "Condition": threading.Condition,
                      "Event": threading.Event,
                      "Thread": threading.Thread,
                      "Queue": queue_mod.Queue}

        def lock_factory():
            return audit.make_lock()

        def rlock_factory():
            return audit.make_lock(reentrant=True)

        base_cond = self._orig["Condition"]

        class ACondition(base_cond):
            def __init__(self, lock=None):
                if lock is None:
                    lock = audit.make_lock(reentrant=True)
                base_cond.__init__(self, lock)

            def wait(self, timeout=None):
                own = (self._lock._label
                       if isinstance(self._lock, _AuditLock) else None)
                audit._block("Condition.wait", exclude=own)
                ok = base_cond.wait(self, timeout)
                if ok:
                    audit._recv(("cond", id(self)))
                return ok

            def wait_for(self, predicate, timeout=None):
                # route through our wait() so HB/blocking both record
                return base_cond.wait_for(self, predicate, timeout)

            def notify(self, n=1):
                audit._send(("cond", id(self)))
                base_cond.notify(self, n)

            def notify_all(self):
                audit._send(("cond", id(self)))
                base_cond.notify_all(self)

        base_ev = self._orig["Event"]

        class AEvent(base_ev):
            def __init__(self):
                base_ev.__init__(self)
                # keep Event internals on plain primitives: the flag
                # lock is implementation detail, not framework state
                self._cond = audit._orig["Condition"](
                    audit._orig["Lock"]())

            def set(self):
                audit._send(("ev", id(self)))
                base_ev.set(self)

            def wait(self, timeout=None):
                audit._block("Event.wait")
                ok = base_ev.wait(self, timeout)
                if ok:
                    audit._recv(("ev", id(self)))
                return ok

            def is_set(self):
                ok = base_ev.is_set(self)
                if ok:
                    audit._recv(("ev", id(self)))
                return ok

        base_thr = self._orig["Thread"]

        class AThread(base_thr):
            def __init__(self, *a, **kw):
                base_thr.__init__(self, *a, **kw)
                # _bootstrap_inner sets _started BEFORE registering the
                # thread in threading._active: keep that event entirely
                # un-audited so a child thread's first recorded hook is
                # run()'s recv, after registration (real thread name)
                clean = base_ev.__new__(base_ev)
                clean._cond = audit._orig["Condition"](
                    audit._orig["Lock"]())
                clean._flag = False
                self._started = clean

            def start(self):
                audit._send(("thr", id(self)))
                base_thr.start(self)

            def run(self):
                audit._recv(("thr", id(self)))
                try:
                    base_thr.run(self)
                finally:
                    audit._send(("done", id(self)))

            def join(self, timeout=None):
                audit._block("Thread.join", only_if_held=True)
                base_thr.join(self, timeout)
                if not self.is_alive():
                    audit._recv(("done", id(self)))

        base_q = self._orig["Queue"]

        class AQueue(base_q):
            def put(self, item, block=True, timeout=None):
                if block and self.maxsize > 0:
                    audit._block("Queue.put", only_if_held=True)
                audit._preempt()
                base_q.put(self, item, block, timeout)
                audit._send(("q", id(self)))

            def get(self, block=True, timeout=None):
                if block:
                    audit._block("Queue.get", only_if_held=True)
                audit._preempt()
                item = base_q.get(self, block, timeout)
                audit._recv(("q", id(self)))
                return item

        def audited_sleep(secs):
            audit._block("time.sleep", only_if_held=True)
            audit._preempt()
            _ORIG_SLEEP(secs)

        def audited_open(*a, **kw):
            audit._block("open", only_if_held=True)
            return _ORIG_OPEN(*a, **kw)

        self._patch(threading, "Lock", lock_factory)
        self._patch(threading, "RLock", rlock_factory)
        self._patch(threading, "Condition", ACondition)
        self._patch(threading, "Event", AEvent)
        self._patch(threading, "Thread", AThread)
        self._patch(queue_mod, "Queue", AQueue)
        self._patch(time, "sleep", audited_sleep)
        self._patch(builtins, "open", audited_open)
        self.active = True

    def _uninstall(self):
        self.active = False
        for mod, name, orig in reversed(self._patches):
            setattr(mod, name, orig)
        self._patches.clear()
        for obj, attr, orig in reversed(self._restores):
            try:
                setattr(obj, attr, orig)
            except Exception:
                pass
        self._restores.clear()

    # -- analysis -------------------------------------------------------

    def analyze(self) -> Report:
        analyze_events(self._col.events, self.report,
                       policies=self._policies)
        _apply_source_suppressions(self.report)
        return self.report


# ----------------------------------------------------------------------
# Post-hoc analysis (single-threaded, over the observed event order)
# ----------------------------------------------------------------------

def _join(a: Dict[str, int], b: Dict[str, int]) -> None:
    for k, v in b.items():
        if v > a.get(k, 0):
            a[k] = v


def analyze_events(events: List[Tuple], report: Report,
                   policies: Optional[Dict[str, str]] = None) -> Report:
    """Run the lockset/vector-clock/lock-order analysis over one event
    stream, appending findings to ``report``.  Exposed for unit tests
    that synthesize event streams directly."""
    policies = policies or {}
    vc: Dict[str, Dict[str, int]] = {}        # tid -> vector clock
    chan: Dict[Any, Dict[str, int]] = {}      # HB channel clocks
    held: Dict[str, List[str]] = {}           # tid -> held lock labels
    # lock-order graph: edge (held -> acquired) -> first witness
    edges: Dict[Tuple[str, str], Tuple[str, Tuple[str, int]]] = {}
    # loc -> tid -> (epoch, lockset, site, tname)
    last_w: Dict[str, Dict[str, Tuple]] = {}
    last_r: Dict[str, Dict[str, Tuple]] = {}
    reported = set()
    races = 0

    def clock(tid):
        return vc.setdefault(tid, {})

    def tick(tid):
        c = clock(tid)
        c[tid] = c.get(tid, 0) + 1

    def check(loc, tid, epoch, ls, site, prior: Dict[str, Tuple],
              kind_pair):
        nonlocal races
        if loc in reported:
            return
        my = clock(tid)
        for tid2, (e2, ls2, site2, _w2) in prior.items():
            if tid2 == tid:
                continue
            if my.get(tid2, 0) >= e2:
                continue                     # happens-before: ordered
            if ls & ls2:
                continue                     # a common lock serializes
            sev = policies.get(loc, "error")
            loc_site = site if site[0] else site2
            report.add(Finding(
                "conc.data-race",
                f"`{loc}`: {kind_pair} race between threads — "
                f"{site2[0]}:{site2[1]} (locks {sorted(ls2) or 'none'}) "
                f"vs {site[0]}:{site[1]} (locks {sorted(ls) or 'none'}), "
                "no happens-before edge",
                path=loc_site[0], line=loc_site[1], severity=sev,
                details={"location": loc,
                         "sites": [list(site2), list(site)],
                         "locksets": [sorted(ls2), sorted(ls)]}))
            reported.add(loc)
            races += 1
            return

    for ev in events:
        kind, tid = ev[0], ev[1]
        if kind == "acquire":
            _kind, _tid, label, site, reentrant = ev
            h = held.setdefault(tid, [])
            if not reentrant:
                for holder in set(h):
                    if holder != label and (holder, label) not in edges:
                        edges[(holder, label)] = (tid, site)
            h.append(label)
        elif kind == "release":
            _kind, _tid, label, all_depths = ev
            h = held.setdefault(tid, [])
            if all_depths:
                h[:] = [x for x in h if x != label]
            elif label in h:
                h.reverse()
                h.remove(label)
                h.reverse()
        elif kind == "access":
            _kind, _tid, loc, is_write, site = ev
            ls = frozenset(held.get(tid, ()))
            # tick FIRST so epochs are 1-based: an observer with no
            # entry for this thread reads 0, which must always compare
            # as "not ordered" (0 >= first-access-epoch would silently
            # order every thread after a thread's first access)
            tick(tid)
            epoch = clock(tid)[tid]
            if is_write:
                check(loc, tid, epoch, ls, site,
                      last_w.get(loc, {}), "write/write")
                check(loc, tid, epoch, ls, site,
                      last_r.get(loc, {}), "read/write")
                last_w.setdefault(loc, {})[tid] = (epoch, ls, site, True)
            else:
                check(loc, tid, epoch, ls, site,
                      last_w.get(loc, {}), "write/read")
                last_r.setdefault(loc, {})[tid] = (epoch, ls, site, False)
        elif kind == "send":
            _kind, _tid, c = ev
            tick(tid)   # the publish itself is an event on this thread
            _join(chan.setdefault(c, {}), clock(tid))
        elif kind == "recv":
            _kind, _tid, c = ev
            _join(clock(tid), chan.get(c, {}))
            tick(tid)
        elif kind == "block":
            _kind, _tid, op, site, exclude = ev
            holders = [h for h in held.get(tid, ()) if h != exclude]
            # only framework-labeled / repo-created locks gate; locks
            # materialized by third-party code in the window don't
            holders = [h for h in holders if not h.startswith("<extern>")]
            if holders and (op, site) not in reported:
                reported.add((op, site))
                report.add(Finding(
                    "conc.blocking-under-lock",
                    f"`{op}` while holding {sorted(set(holders))} — "
                    "every thread needing those locks stalls behind "
                    "this blocking call",
                    path=site[0], line=site[1],
                    details={"op": op, "locks": sorted(set(holders))}))

    # -- lock-order cycles over the acquisition graph -------------------
    graph: Dict[str, List[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, []).append(b)
    seen_cycles = set()

    def dfs(start):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in graph.get(node, ()):  # pragma: no branch
                if nxt == start and len(path) > 1:
                    key = frozenset(path)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        yield list(path)
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))

    for start in sorted(graph):
        for cyc in dfs(start):
            # every lock in the cycle must be repo-created/labeled —
            # a cycle entirely inside third-party code is not ours
            if any(label.startswith("<extern>") for label in cyc):
                continue
            witness = edges.get((cyc[0], cyc[1 % len(cyc)]))
            site = witness[1] if witness else ("", 0)
            order = " -> ".join(cyc + [cyc[0]])
            report.add(Finding(
                "conc.lock-order",
                f"lock acquisition cycle {order}: threads take these "
                "locks in conflicting orders (potential deadlock)",
                path=site[0], line=site[1],
                details={"cycle": list(cyc)}))

    m = report.metrics.setdefault("races", {})
    m["events"] = len(events)
    m["threads"] = len(vc)
    m["locations"] = len(set(last_w) | set(last_r))
    m["lock_edges"] = len(edges)
    m["races_found"] = races
    return report


def _apply_source_suppressions(report: Report) -> None:
    """Runtime findings carry source sites, so the standard inline
    plumbing (``# staticcheck: disable=conc.* -- reason``) applies —
    read each implicated file once and match by line."""
    by_path: Dict[str, List[Finding]] = {}
    for f in report.findings:
        if f.path and f.line and f.rule.startswith("conc."):
            by_path.setdefault(f.path, []).append(f)
    for path, fs in by_path.items():
        full = os.path.join(_REPO_ROOT, path)
        try:
            with _ORIG_OPEN(full, "r", encoding="utf-8") as fh:
                src = fh.read()
        except OSError:
            continue
        apply_inline(fs, parse_inline_suppressions(src))


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------

_ACTIVE = threading.Lock()


@contextmanager
def audit_threads(report: Optional[Report] = None,
                  fuzzer: Optional[ScheduleFuzzer] = None,
                  record: bool = True,
                  instrument_framework: bool = False):
    """Instrument the threading plane for the duration of the block.

    Yields a :class:`ThreadAudit`; on exit the patches are restored and
    (when ``record``) the event stream is analyzed into
    ``audit.report``.  ``fuzzer`` additionally turns every instrumented
    boundary into a seeded preemption point; pass ``record=False`` for
    pure fuzzing runs (no event collection cost).  Only one audit may
    be active per process — the patches are global."""
    if not _ACTIVE.acquire(blocking=False):
        raise RuntimeError("audit_threads() does not nest: another audit "
                           "window is already active in this process")
    audit = ThreadAudit(report=report, fuzzer=fuzzer, record=record)
    try:
        audit._install()
        if instrument_framework:
            audit.instrument_framework()
        try:
            yield audit
        finally:
            audit._uninstall()
        if record:
            audit.analyze()
    finally:
        _ACTIVE.release()


def run_schedules(scenarios: Optional[List[str]] = None,
                  n: Optional[int] = None,
                  seed: Optional[int] = None,
                  fail_fast: bool = False,
                  log: Optional[Callable[[str], None]] = None,
                  device: Any = None) -> Dict[str, Any]:
    """Sweep the deterministic schedule fuzzer over the hot concurrent
    scenarios (:mod:`.schedules`): for each scenario, N seeded
    interleavings, each asserting its byte-identity invariant.  A
    failure records the (scenario, seed) pair — replaying that exact
    schedule is ``run_schedules([name], n=1, seed=that_seed)``.

    ``device`` places the scenarios' tensors and routers: the card
    unless the caller passes ``"cpu"`` (a missing card raises before any
    scenario runs).  ``n`` defaults to ``MXNET_TPU_CONC_SCHEDULES`` (50),
    the base seed to ``MXNET_TPU_CONC_SEED`` (0)."""
    from . import schedules as sched_mod
    from .. import telemetry
    from ..context import resolve_device
    dev = resolve_device(device)
    if n is None:
        n = int(os.environ.get("MXNET_TPU_CONC_SCHEDULES", "50"))
    if seed is None:
        seed = int(os.environ.get("MXNET_TPU_CONC_SEED", "0"))
    names = list(scenarios) if scenarios else sched_mod.names()
    out: Dict[str, Any] = {"schedules_per_scenario": n, "base_seed": seed,
                           "device": str(dev), "scenarios": {},
                           "failures": []}
    for name in names:
        fn = sched_mod.get(name)
        t0 = time.monotonic()
        preemptions = 0
        for i in range(n):
            s = seed + i
            fz = ScheduleFuzzer(seed=s)
            try:
                with audit_threads(fuzzer=fz, record=False) as audit:
                    fn(s, audit, dev)
            except Exception as exc:   # noqa: BLE001 — collect + report
                out["failures"].append(
                    {"scenario": name, "seed": s,
                     "error": f"{type(exc).__name__}: {exc}"})
                if fail_fast:
                    raise
            preemptions += fz.preemptions
            telemetry.counter("staticcheck.schedules_run").inc()
        out["scenarios"][name] = {
            "runs": n, "preemptions": preemptions,
            "seconds": round(time.monotonic() - t0, 3)}
        if log:
            log(f"schedules: {name}: {n} interleavings, "
                f"{preemptions} preemptions, "
                f"{out['scenarios'][name]['seconds']}s")
    out["ok"] = not out["failures"]
    return out
