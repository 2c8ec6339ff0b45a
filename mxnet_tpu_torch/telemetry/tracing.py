"""Span tracer with Chrome/Perfetto trace-event export.

Counterpart of ``mxnet_tpu/telemetry/tracing.py``.  Host-side causal
tracing for the seams ``torch.profiler`` does not name: an engine's
admission, prefill and decode, a router's failover and rolling swap.
Spans nest per thread (Perfetto renders one track per tid, so a client
thread streaming tokens and an operator thread draining a replica each
get their own lane) and carry explicit ``id`` / ``parent`` args so
cross-references survive even outside a viewer.

Disabled (the default) a ``span(...)`` call returns a shared null
context — one function call, one attribute test, no allocation.
Enabled, closing a span appends one dict to a bounded ring; the export
cost is paid only at :func:`export` time.

Output is the Chrome trace-event JSON-object format (Perfetto and
``chrome://tracing`` both load it): ``{"traceEvents": [...]}`` with
complete (``"ph": "X"``) events in microseconds plus thread-name
metadata (``"ph": "M"``) rows.  :func:`validate` re-checks a written
file's structure and per-track span nesting — the test suite's schema
oracle.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["span", "annotate", "enabled", "configure", "export",
           "name_thread", "validate", "clear", "tail"]

_MAX_EVENTS = 200_000  # ~60 MB worst case; oldest spans fall off

_enabled = False
_path: Optional[str] = None
_events: deque = deque(maxlen=_MAX_EVENTS)
_epoch_ns = time.perf_counter_ns()
_ids = itertools.count(1)
_tls = threading.local()
_thread_names: Dict[int, str] = {}
_lock = threading.Lock()


def enabled() -> bool:
    return _enabled


def configure(path: Optional[str], enable: Optional[bool] = None) -> None:
    """Set the export path and flip tracing on/off.  ``path=None`` with
    ``enable`` unset disables."""
    global _enabled, _path
    _path = path
    _enabled = bool(path) if enable is None else bool(enable)


def clear() -> None:
    _events.clear()
    with _lock:
        _thread_names.clear()


def name_thread(name: str) -> None:
    """Label the calling thread's trace track (Perfetto lane name)."""
    tid = threading.get_ident()
    with _lock:
        _thread_names[tid] = name


class _NullSpan:
    """Shared no-op span: the disabled-path return of :func:`span`."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kv):
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "id", "parent", "_t0")

    def __init__(self, name: str, cat: str, args: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.args = args
        self.id = next(_ids)
        self.parent = 0
        self._t0 = 0

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
            tid = threading.get_ident()
            if tid not in _thread_names:
                with _lock:
                    _thread_names.setdefault(
                        tid, threading.current_thread().name)
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        # floor both ends to us so a child's end can never round past
        # its parent's (validate() relies on exact nesting)
        ts = (self._t0 - _epoch_ns) // 1000
        end = (t1 - _epoch_ns) // 1000
        args = self.args
        args["id"] = self.id
        if self.parent:
            args["parent"] = self.parent
        _events.append({"name": self.name, "cat": self.cat, "ph": "X",
                        "ts": ts, "dur": end - ts,
                        "tid": threading.get_ident(), "args": args})
        return False

    def annotate(self, **kv):
        self.args.update(kv)


def span(name: str, cat: str = "mxtpu", **args):
    """Open a traced region: ``with telemetry.span("step"): ...``.
    Free (a shared null context) unless tracing is enabled."""
    if not _enabled:
        return _NULL
    return _Span(name, cat, args)


def annotate(**kv) -> None:
    """Attach args to the innermost open span on this thread."""
    if not _enabled:
        return
    stack = getattr(_tls, "stack", None)
    if stack:
        stack[-1].args.update(kv)


def export(path: Optional[str] = None) -> Optional[str]:
    """Write the Chrome trace-event JSON; returns the path (None when
    tracing never enabled and no explicit path given).  Atomic
    (tmp + rename) so a reader never sees a torn file."""
    path = path or _path
    if not path:
        return None
    pid = os.getpid()
    with _lock:
        names = dict(_thread_names)
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": f"mxnet_tpu_torch[{pid}]"}}]
    for tid, name in sorted(names.items()):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    for ev in list(_events):
        ev = dict(ev)
        ev["pid"] = pid
        events.append(ev)
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{pid}"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, path)
    return path


def tail(n: int = 64) -> List[Dict[str, Any]]:
    """Most recent ``n`` span events (flight-recorder dump payload)."""
    evs = list(_events)
    return evs[-n:]


def validate(path: str) -> Dict[str, Any]:
    """Structural check of an exported trace.  Raises ``ValueError`` on
    any violation; returns ``{"events": N, "tracks": {tid: name},
    "span_names": set}``.

    Checks: loadable JSON with a ``traceEvents`` list; every ``X``
    event carries name/ts/dur/pid/tid with non-negative integer times;
    per (pid, tid) track the spans are **properly nested** (sorted by
    start, no partial overlap — a child closes before its parent);
    ``parent`` ids reference a previously opened span.
    """
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("trace: missing traceEvents list")
    tracks: Dict[int, str] = {}
    by_track: Dict[tuple, List[Dict[str, Any]]] = {}
    ids = set()
    names = set()
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"trace: malformed event {ev!r}")
        if ev["ph"] == "M":
            if ev.get("name") == "thread_name":
                tracks[ev["tid"]] = ev["args"]["name"]
            continue
        if ev["ph"] != "X":
            continue
        for k in ("name", "ts", "dur", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"trace: event missing {k!r}: {ev!r}")
        if not (isinstance(ev["ts"], int) and ev["ts"] >= 0
                and isinstance(ev["dur"], int) and ev["dur"] >= 0):
            raise ValueError(f"trace: bad ts/dur in {ev!r}")
        names.add(ev["name"])
        sid = ev.get("args", {}).get("id")
        if sid is not None:
            ids.add(sid)
        by_track.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    nspans = 0
    for key, evs in by_track.items():
        # ts ties: the longer span is the parent, so it sorts first
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        open_ends: List[int] = []
        for ev in evs:
            ts, end = ev["ts"], ev["ts"] + ev["dur"]
            while open_ends and open_ends[-1] <= ts:
                open_ends.pop()
            if open_ends and end > open_ends[-1]:
                raise ValueError(
                    f"trace: span {ev['name']!r} on track {key} "
                    f"overlaps its parent ([{ts}, {end}] vs parent end "
                    f"{open_ends[-1]})")
            parent = ev.get("args", {}).get("parent")
            if parent is not None and parent not in ids:
                raise ValueError(
                    f"trace: span {ev['name']!r} references unknown "
                    f"parent id {parent}")
            open_ends.append(end)
            nspans += 1
    return {"events": nspans, "tracks": tracks, "span_names": names}
