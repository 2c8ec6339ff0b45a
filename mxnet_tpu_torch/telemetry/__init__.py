"""Telemetry plane: metrics registry, span tracer and flight recorder.

Counterpart of ``mxnet_tpu/telemetry`` (host code, kept as a copy so the
port imports nothing of the JAX package), with the same functions, metric
names and environment knobs.  One import point for the three primitives
the serving control plane feeds:

* :mod:`.metrics` — counters / gauges / histograms with labels,
  snapshot+delta semantics, periodic JSONL emission
  (``MXNET_TPU_METRICS_FILE``) and the :func:`scrape` pull API.
* :mod:`.tracing` — ``span()``/``annotate()`` causal spans with
  per-thread tracks, exported as Chrome/Perfetto trace-event JSON
  (``MXNET_TPU_TRACE``).
* :mod:`.flight` — a bounded ring of recent step records dumped on a
  replica's death or a step exception (``MXNET_TPU_FLIGHTREC``).

Everything here is **host-side observation only**: no device reads, so
enabling or disabling telemetry can never change numerics.  Environment
knobs are read lazily at first use, so tests and embedders can call
:func:`configure` programmatically instead.
"""
from __future__ import annotations

import atexit
import os
import threading
from typing import Any, Dict, Optional

from . import flight as _flight_mod
from . import tracing
from .metrics import DEFAULT_BUCKETS, JsonlEmitter, Metric, Registry, delta
from .tracing import annotate, name_thread

__all__ = ["Registry", "Metric", "JsonlEmitter", "delta",
           "DEFAULT_BUCKETS", "registry", "counter", "gauge",
           "histogram", "scrape", "snapshot_flat", "span", "annotate",
           "name_thread", "trace_enabled", "export_trace",
           "validate_trace", "emit", "flush_metrics", "record_step",
           "dump_flight", "flight_recorder", "set_program_costs",
           "configure", "reset_for_tests", "tracing"]

_registry = Registry()
_flight = _flight_mod.FlightRecorder()
_emitter: Optional[JsonlEmitter] = None
_costs: Dict[str, float] = {}   # program flops / hbm bytes / peak flops
_ready = False
_init_lock = threading.Lock()
_atexit_armed = False


def _ensure_init() -> None:
    """Read the env knobs once, on first use of any public entry."""
    global _ready
    if _ready:
        return
    with _init_lock:
        if _ready:
            return
        mfile = os.environ.get("MXNET_TPU_METRICS_FILE")
        if mfile:
            interval = float(
                os.environ.get("MXNET_TPU_METRICS_INTERVAL", "10"))
            _set_emitter(mfile, interval)
        tpath = os.environ.get("MXNET_TPU_TRACE")
        if tpath:
            _set_trace(tpath)
        frec = os.environ.get("MXNET_TPU_FLIGHTREC")
        if frec:
            _set_flightrec(frec)
        _ready = True


def _set_emitter(path: Optional[str], interval: float = 10.0) -> None:
    global _emitter
    _emitter = JsonlEmitter(path, interval) if path else None


def _set_trace(path: Optional[str]) -> None:
    global _atexit_armed
    tracing.configure(path)
    if path and not _atexit_armed:
        _atexit_armed = True
        atexit.register(_atexit_export)


def _atexit_export() -> None:
    try:
        if tracing.enabled():
            tracing.export()
        if _emitter is not None:
            _emitter.maybe_snapshot(_registry, force=True)
    except Exception:  # interpreter teardown: never raise from atexit
        pass


def _set_flightrec(spec: str) -> None:
    """``MXNET_TPU_FLIGHTREC=<dir>[:capacity]`` enables auto-dumps;
    ``0``/``off`` disables them (the ring itself always records)."""
    if spec.strip().lower() in ("0", "off", ""):
        _flight.dump_dir = None
        return
    d, sep, cap = spec.rpartition(":")
    if sep and cap.isdigit():
        _flight.set_capacity(int(cap))
        spec = d
    _flight.dump_dir = spec


def configure(metrics_file: Optional[str] = None,
              metrics_interval: Optional[float] = None,
              trace: Optional[str] = None,
              flightrec_dir: Optional[str] = None,
              flightrec_capacity: Optional[int] = None) -> None:
    """Programmatic setup (tests, embedders) — wins over the env.
    Passing None leaves that channel as the env/default left it."""
    global _ready
    _ensure_init()
    if metrics_file is not None:
        _set_emitter(metrics_file or None,
                     metrics_interval if metrics_interval else 10.0)
    elif metrics_interval is not None and _emitter is not None:
        _emitter.interval = float(metrics_interval)
    if trace is not None:
        _set_trace(trace or None)
    if flightrec_dir is not None:
        _flight.dump_dir = flightrec_dir or None
    if flightrec_capacity is not None:
        _flight.set_capacity(flightrec_capacity)
    _ready = True


def reset_for_tests() -> None:
    """Full state reset: empty registry/ring/trace buffer, channels
    off, env re-read on next use."""
    global _ready, _emitter
    _registry.reset()
    with _flight._lock:
        _flight._ring.clear()
        _flight.dump_count = 0
    _flight.dump_dir = None
    _costs.clear()
    tracing.configure(None)
    tracing.clear()
    _emitter = None
    _ready = False


# ---------------------------------------------------------------------------
# Metrics surface
# ---------------------------------------------------------------------------

def registry() -> Registry:
    return _registry


def counter(name: str, help: str = "") -> Metric:
    return _registry.counter(name, help)


def gauge(name: str, help: str = "") -> Metric:
    return _registry.gauge(name, help)


def histogram(name: str, help: str = "", buckets=DEFAULT_BUCKETS) -> Metric:
    return _registry.histogram(name, help, buckets)


def scrape() -> Dict[str, Dict[str, Any]]:
    """Structured pull snapshot of every registered metric."""
    _ensure_init()
    return _registry.snapshot()


def snapshot_flat() -> Dict[str, float]:
    """Flat ``{series: number}`` snapshot (delta-arithmetic form)."""
    _ensure_init()
    return _registry.flat()


def emit(kind: str, rec: Dict[str, Any]) -> None:
    """Append one record to the metrics JSONL stream (no-op when
    ``MXNET_TPU_METRICS_FILE`` is unset)."""
    _ensure_init()
    if _emitter is not None:
        _emitter.emit(kind, rec)


def flush_metrics(force: bool = True) -> None:
    """Write a full-registry snapshot row to the JSONL stream."""
    _ensure_init()
    if _emitter is not None:
        _emitter.maybe_snapshot(_registry, force=force)


# ---------------------------------------------------------------------------
# Tracing surface (annotate/name_thread re-exported above)
# ---------------------------------------------------------------------------

def span(name: str, **args: Any):
    """Open a trace span on the calling thread's track.  Wraps
    :func:`tracing.span` so the first span in a process still picks up
    ``MXNET_TPU_TRACE`` — instrumented call sites must not depend on
    some *other* telemetry entry having initialised the env knobs."""
    if not _ready:
        _ensure_init()
    return tracing.span(name, **args)


def trace_enabled() -> bool:
    _ensure_init()
    return tracing.enabled()


def export_trace(path: Optional[str] = None) -> Optional[str]:
    _ensure_init()
    return tracing.export(path)


validate_trace = tracing.validate


# ---------------------------------------------------------------------------
# Flight recorder + step-loop hook
# ---------------------------------------------------------------------------

def flight_recorder() -> _flight_mod.FlightRecorder:
    return _flight


def set_program_costs(flops_per_step: Optional[float] = None,
                      hbm_bytes_per_step: Optional[float] = None,
                      peak_flops_per_s: Optional[float] = None) -> None:
    """Install the static per-step program costs the derived gauges
    divide by step time: device bytes a step moves ->
    ``derived.hbm_gbps``, its flops (+ device peak) -> ``derived.mfu``.
    Anything that knows its step's costs may install them."""
    g = _registry.gauge
    if flops_per_step is not None:
        _costs["flops"] = float(flops_per_step)
        g("program.flops_per_step").set(flops_per_step)
    if hbm_bytes_per_step is not None:
        _costs["hbm_bytes"] = float(hbm_bytes_per_step)
        g("program.hbm_bytes_per_step").set(hbm_bytes_per_step)
    if peak_flops_per_s is not None:
        _costs["peak"] = float(peak_flops_per_s)
        g("program.peak_flops_per_s").set(peak_flops_per_s)


def record_step(rec: Dict[str, Any]) -> None:
    """Per-step hook of a training loop (one call a batch).

    Appends ``rec`` to the flight ring, folds its timing into the
    registry (``step.count``, ``step.host_ms`` histogram), refreshes
    the derived bandwidth/MFU gauges when program costs are known, and
    gives the JSONL emitter its rate-limited snapshot chance.  Cost
    with every channel off: one deque append + two registry writes."""
    _flight.record(rec)
    _registry.counter("step.count").inc()
    ms = rec.get("host_ms")
    if ms is not None and ms > 0:
        _registry.histogram("step.host_ms").observe(ms)
        if _costs:
            sec = ms * 1e-3
            hbm = _costs.get("hbm_bytes")
            if hbm:
                _registry.gauge("derived.hbm_gbps").set(hbm / sec / 1e9)
            fl = _costs.get("flops")
            if fl:
                _registry.gauge("derived.flops_per_s").set(fl / sec)
                peak = _costs.get("peak")
                if peak:
                    _registry.gauge("derived.mfu").set(fl / sec / peak)
    if _emitter is not None:
        if _emitter.maybe_snapshot(_registry):
            _emitter.emit("step", rec)


def dump_flight(reason: str, path: Optional[str] = None,
                extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Dump the flight ring (+ metrics snapshot + trace tail).  Writes
    nowhere unless ``MXNET_TPU_FLIGHTREC`` / ``configure`` named a dump
    directory or ``path`` is explicit.  Also force-flushes the metrics
    stream and the trace so the three channels stay consistent around
    a failure."""
    _ensure_init()
    _registry.counter("flight.dumps").inc(reason=reason)
    out = _flight.dump(reason, path=path, metrics=_registry.flat(),
                       trace_tail=(tracing.tail()
                                   if tracing.enabled() else None),
                       extra=extra)
    if _emitter is not None:
        _emitter.emit("event", {"event": "flight_dump", "reason": reason,
                                "path": out})
        _emitter.maybe_snapshot(_registry, force=True)
    if tracing.enabled():
        tracing.export()
    return out
