"""Metrics registry: counters / gauges / histograms with labels.

Counterpart of ``mxnet_tpu/telemetry/metrics.py``.  Three metric kinds,
Prometheus-flavored semantics:

* **counter** — monotonically increasing event count (``inc``),
* **gauge** — last-write-wins instantaneous value (``set``/``inc``),
* **histogram** — bucketed distribution (``observe``) keeping
  count / sum / min / max plus cumulative ``le`` bucket counts.

Hot-path writes are **lock-free**: a series update is a plain Python
attribute read-modify-write under the GIL.  Series *creation* (first
use of a name or label set) takes the registry lock; after that an
``inc`` on the step path costs one dict lookup and one float add.  A
concurrently lost increment on a monitoring counter is an accepted
trade for never taking a lock between two device launches.

Snapshot + delta semantics: :meth:`Registry.flat` returns an immutable
``{series_key: number}`` dict (histograms flatten to ``.count`` /
``.sum`` / ``.min`` / ``.max``); :func:`delta` subtracts two flat
snapshots key-wise, which is exact for counters/histograms and a plain
difference for gauges.  :meth:`Registry.snapshot` is the structured
pull API behind ``telemetry.scrape()``.
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = ["Registry", "Metric", "JsonlEmitter", "delta",
           "DEFAULT_BUCKETS"]

# step/latency milliseconds ladder; covers sub-ms dispatch to multi-s
# compiles
DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class _Series:
    """One (metric, label-set) time series — a bare float cell."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def add(self, n):
        self.value += n

    def set(self, v):
        self.value = float(v)


class _HistSeries:
    """One histogram series: count/sum/min/max + cumulative buckets."""
    __slots__ = ("count", "sum", "min", "max", "bounds", "buckets")

    def __init__(self, bounds: Sequence[float]):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.bounds = tuple(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)  # last = +Inf

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.buckets[bisect.bisect_left(self.bounds, v)] += 1


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class Metric:
    """A named metric; label resolution fans out to per-series cells."""

    def __init__(self, name: str, kind: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 lock: Optional[threading.Lock] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self._buckets = tuple(buckets)
        self._lock = lock or threading.Lock()
        # series creation locks; cell updates are lock-free by design
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}  # shared: guarded_by=_lock
        self._default = self._new_series()
        self._series[()] = self._default

    def _new_series(self):
        return (_HistSeries(self._buckets) if self.kind == "histogram"
                else _Series())

    def labels(self, **labels):
        """Resolve (creating if new) the series for a label set."""
        if not labels:
            return self._default
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, self._new_series())
        return s

    # hot-path conveniences -------------------------------------------------

    def inc(self, n: float = 1, **labels):
        self.labels(**labels).add(n)

    def set(self, v: float, **labels):
        self.labels(**labels).set(v)

    def observe(self, v: float, **labels):
        self.labels(**labels).observe(v)

    def value(self, **labels) -> float:
        s = self.labels(**labels)
        return s.sum if self.kind == "histogram" else s.value


class Registry:
    """Process-wide metric namespace with get-or-create semantics."""

    def __init__(self):
        # creation is guarded; reads ride the documented lock-free
        # fast path (module docstring)
        self._metrics: Dict[str, Metric] = {}   # shared: guarded_by=_lock
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str = "",
             buckets: Sequence[float] = DEFAULT_BUCKETS) -> Metric:
        m = self._metrics.get(name)  # lock-free fast path (atomic get)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = Metric(name, kind, help, buckets, self._lock)
                    self._metrics[name] = m
        if m.kind != kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {kind}")
        return m

    def counter(self, name: str, help: str = "") -> Metric:
        return self._get(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> Metric:
        return self._get(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Metric:
        return self._get(name, "histogram", help, buckets)

    def get_value(self, name: str, **labels) -> Optional[float]:
        """Current value of a series, or None if never written."""
        m = self._metrics.get(name)
        if m is None:
            return None
        key = _label_key(labels)
        s = m._series.get(key)
        if s is None:
            return None
        return s.sum if m.kind == "histogram" else s.value

    # snapshots -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Structured pull snapshot (``telemetry.scrape()``)."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            series = []
            for key, s in list(m._series.items()):
                labels = dict(key)
                if m.kind == "histogram":
                    if not s.count and not key:
                        continue  # unused default cell
                    series.append({
                        "labels": labels, "count": s.count,
                        "sum": s.sum,
                        "min": s.min if s.count else None,
                        "max": s.max if s.count else None,
                        "buckets": {
                            ("+Inf" if i == len(s.bounds)
                             else repr(s.bounds[i])): n
                            for i, n in enumerate(s.buckets) if n},
                    })
                else:
                    if not key and s.value == 0.0 and len(m._series) > 1:
                        continue  # labeled metric: hide untouched default
                    series.append({"labels": labels, "value": s.value})
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "series": series}
        return out

    def flat(self) -> Dict[str, float]:
        """Flat ``{name{labels}: number}`` snapshot (JSONL emission +
        delta arithmetic).  Histograms flatten to count/sum/min/max."""
        out: Dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for key, s in list(m._series.items()):
                base = _series_name(m.name, key)
                if m.kind == "histogram":
                    if not s.count:
                        continue
                    out[base + ".count"] = s.count
                    out[base + ".sum"] = s.sum
                    out[base + ".min"] = s.min
                    out[base + ".max"] = s.max
                else:
                    if not key and s.value == 0.0 and len(m._series) > 1:
                        continue
                    out[base] = s.value
        return out

    def counters_with_prefix(self, prefix: str = "") -> Dict[str, float]:
        """Unlabeled-counter view for the ``profiler.counters`` shim."""
        out: Dict[str, float] = {}
        with self._lock:
            metrics = [m for m in self._metrics.values()
                       if m.kind == "counter"
                       and m.name.startswith(prefix)]
        for m in metrics:
            v = m._default.value
            if v:
                out[m.name] = int(v) if float(v).is_integer() else v
        return out

    def reset(self, prefix: str = "",
              kinds: Optional[Sequence[str]] = None) -> None:
        """Drop every metric whose name starts with ``prefix`` (the
        ``profiler.reset_counters`` shim; tests).  ``kinds`` restricts
        the sweep, e.g. ``("counter",)`` leaves gauges/histograms."""
        with self._lock:
            for name in [n for n, m in self._metrics.items()
                         if n.startswith(prefix)
                         and (kinds is None or m.kind in kinds)]:
                del self._metrics[name]


def delta(cur: Dict[str, float], prev: Dict[str, float]
          ) -> Dict[str, float]:
    """Key-wise ``cur - prev`` of two flat snapshots (missing keys read
    as 0).  Exact for counters/histogram accumulators; for gauges it is
    the plain change in reading."""
    out = {}
    for k in set(cur) | set(prev):
        d = cur.get(k, 0.0) - prev.get(k, 0.0)
        if d:
            out[k] = d
    return out


class JsonlEmitter:
    """Append-only JSONL stream (``MXNET_TPU_METRICS_FILE``).

    One JSON object per line, every line carrying ``ts`` (unix seconds)
    and ``kind`` (``metrics`` | ``step`` | ``bench`` | ``audit`` |
    ``resilience`` | ``monitor`` | ``event``).  ``maybe_snapshot``
    rate-limits full-registry rows to one per ``interval`` seconds so
    the step loop can call it every batch."""

    def __init__(self, path: str, interval: float = 10.0):
        self.path = path
        self.interval = float(interval)
        self._last = 0.0              # shared: guarded_by=_lock
        self._lock = threading.Lock()
        # truncate-on-open would destroy a restarted run's history;
        # append, and let the reader key on ts/pid
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)

    def emit(self, kind: str, rec: Dict[str, Any]) -> None:
        row = {"ts": time.time(), "pid": os.getpid(), "kind": kind}
        row.update(rec)
        line = json.dumps(row, default=str)
        with self._lock:
            # the lock is the line serializer: one short append per row,
            # and writers must not interleave
            # staticcheck: disable=conc.blocking-under-lock -- the lock IS the line serializer
            with open(self.path, "a") as f:
                f.write(line + "\n")

    def maybe_snapshot(self, registry: Registry,
                       force: bool = False) -> bool:
        now = time.monotonic()
        # claim the interval under the lock (check-then-set on _last
        # raced between trainer / ckpt-writer / prefetch threads and
        # double-emitted snapshots), then emit outside it — emit()
        # retakes the same non-reentrant lock
        with self._lock:
            if not force and now - self._last < self.interval:
                return False
            self._last = now
        self.emit("metrics", {"metrics": registry.flat()})
        return True
