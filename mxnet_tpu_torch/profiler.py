"""Execution profiling: traces, compile events, counters, step phases.

Counterpart of ``mxnet_tpu/profiler.py``, with its functions and
telemetry names.  The trace half wraps ``torch.profiler``: host
activity always, the card's kernels (CUPTI) when CUDA is there, and a
Chrome trace written into ``log_dir`` at :func:`stop`::

    mxnet_tpu_torch.profiler.start("/tmp/profile")
    ... steps ...
    mxnet_tpu_torch.profiler.stop()      # -> "/tmp/profile"

A captured program's replay shows in the trace as its kernels, named as
when they run eagerly (the graph holds the same kernels).

:func:`profile_step` attributes one training step's wall time to the
phases the framework controls:

* ``place_ms`` — host time of ``trainer.place_batch`` for a host batch
  (pinned copies; hidden by ``io.DevicePrefetchIter``),
* ``dispatch_ms`` — host time for ``trainer.step`` to return on a placed
  batch (the Python and launch cost of a step; a replayed program makes
  it one graph launch and the input copies),
* ``device_ms`` — device time per step by the two-point slope: run N
  steps, then 3N, each run closed by one ``torch.cuda.synchronize()``;
  ``(t2 - t1) / 2N`` cancels the constant cost of the closing wait,
* ``fetch_ms`` — one scalar ``.item()`` round trip on an idle device.

``host_gap_ms = max(0, place_ms + dispatch_ms - device_ms)`` is the host
work that cannot hide under device work; ``step_ms = device_ms +
host_gap_ms``.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict, List

import torch

from .base import MXNetError

__all__ = ["start", "stop", "trace", "annotate", "profile_step",
           "format_step_profile", "record_compile", "compile_events",
           "reset_compile_events", "format_compile_report",
           "bump", "counter", "counters", "reset_counters"]

_active: Dict[str, object] = {"dir": None, "prof": None}
_trace_ids = iter(range(1, 1 << 62))


def start(log_dir: str) -> None:
    """Begin capturing a host (and, with CUDA, device) trace for
    ``log_dir``."""
    if _active["dir"] is not None:
        raise MXNetError(f"profiler already running (dir={_active['dir']!r})")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _active["dir"], _active["prof"] = log_dir, prof


def stop() -> str:
    """Stop the capture and write it as ``<log_dir>/trace.<pid>.<n>.json``
    (Chrome trace format); returns the directory."""
    out, prof = _active["dir"], _active["prof"]
    if out is None:
        raise MXNetError("profiler is not running")
    try:
        prof.stop()
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out, f"trace.{os.getpid()}.{next(_trace_ids)}.json"))
    finally:
        # a failed export must not wedge the module in 'running' state
        _active["dir"] = _active["prof"] = None
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``with profiler.trace(dir): ...`` capture scope."""
    start(log_dir)
    try:
        yield
    finally:
        stop()


@contextlib.contextmanager
def annotate(name: str):
    """Label a region in the trace (``torch.profiler.record_function``)
    and, on the card, in NVTX."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


# ---------------------------------------------------------------------------
# Compile telemetry
# ---------------------------------------------------------------------------
#
# Every program resolution of the program cache (a hit, a fresh capture,
# an eager program) lands here as one event.

_compile_events: List[Dict[str, object]] = []
_compile_lock = threading.Lock()


def record_compile(label: str, seconds: float, source: str = "capture",
                   digest: str = "") -> None:
    """Record one program resolution; ``source`` is where the program
    came from: ``capture`` (a fresh graph), ``eager`` (a program run
    without capture) or ``memory`` (a hit)."""
    with _compile_lock:
        _compile_events.append({"label": str(label),
                                "seconds": float(seconds),
                                "source": str(source),
                                "digest": str(digest)})
    from . import telemetry
    telemetry.counter("compile.events").inc(source=str(source))
    telemetry.histogram("compile.seconds").observe(float(seconds))


def compile_events() -> List[Dict[str, object]]:
    """Snapshot of recorded compile events (oldest first)."""
    with _compile_lock:
        return [dict(e) for e in _compile_events]


def reset_compile_events() -> None:
    with _compile_lock:
        _compile_events.clear()


def format_compile_report(title: str = "compile") -> str:
    """The compile-event log: a line per program, then counts and seconds
    by source."""
    events = compile_events()
    lines = [f"compile report [{title}]  ({len(events)} programs)"]
    if not events:
        return lines[0]
    width = max(len(str(e["label"])) for e in events)
    totals: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for e in events:
        src = str(e["source"])
        totals[src] = totals.get(src, 0.0) + float(e["seconds"])
        counts[src] = counts.get(src, 0) + 1
        lines.append(f"  {str(e['label']).ljust(width)}  {src:<7}  "
                     f"{float(e['seconds']):8.3f}s")
    foot = "  ".join(f"{s}={counts[s]} ({totals[s]:.3f}s)"
                     for s in sorted(counts))
    lines.append(f"  -- {foot}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Program-audit events (mxnet_tpu_torch.analysis)
# ---------------------------------------------------------------------------
#
# Each program the auditor walks lands here (label, finding count, wall
# seconds), beside the compile events.

_audit_events: List[Dict[str, object]] = []


def record_audit(program: str, findings: int, seconds: float) -> None:
    """Record one audited program (called by ``analysis.audit_traced``)."""
    with _compile_lock:
        _audit_events.append({"program": str(program),
                              "findings": int(findings),
                              "seconds": float(seconds)})
    from . import telemetry
    telemetry.counter("audit.programs").inc()
    if findings:
        telemetry.counter("audit.findings").inc(int(findings))


def audit_events() -> List[Dict[str, object]]:
    """Snapshot of recorded audit events (oldest first)."""
    with _compile_lock:
        return [dict(e) for e in _audit_events]


def reset_audit_events() -> None:
    with _compile_lock:
        _audit_events.clear()


# ---------------------------------------------------------------------------
# Event counters: a shim over the telemetry registry
# ---------------------------------------------------------------------------

def bump(name: str, n: int = 1) -> None:
    """Increment counter ``name`` by ``n`` (created at 0)."""
    from . import telemetry
    telemetry.counter(name).inc(int(n))


def counter(name: str) -> int:
    from . import telemetry
    v = telemetry.registry().get_value(name)
    return int(v) if v is not None else 0


def counters(prefix: str = "") -> Dict[str, int]:
    """Snapshot of counters, optionally filtered by dotted prefix."""
    from . import telemetry
    return telemetry.registry().counters_with_prefix(prefix)


def reset_counters(prefix: str = "") -> None:
    from . import telemetry
    telemetry.registry().reset(prefix, kinds=("counter",))


# ---------------------------------------------------------------------------
# Step-phase profiler
# ---------------------------------------------------------------------------

def _sync(heads) -> None:
    """Wait for the device (the step's queued work) to finish."""
    h = heads[0] if isinstance(heads, (list, tuple)) else heads
    if h.device.type == "cuda":
        torch.cuda.synchronize(h.device)


def _fetch(heads) -> None:
    """One scalar device-to-host round trip."""
    h = heads[0] if isinstance(heads, (list, tuple)) else heads
    h.reshape(-1)[0].item()


def _device_slope_ms(run_steps: Callable[[int], None], base_steps: int,
                     repeats: int = 3) -> float:
    """Device time per step by the two-point slope: time N and 3N steps,
    each closed by one synchronize; ``(t2 - t1 - (t1 - t0)) / 2N``.
    Lower median of ``repeats`` slopes."""
    slopes = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_steps(base_steps)
        t1 = time.perf_counter()
        run_steps(3 * base_steps)
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / (2 * base_steps))
    slopes.sort()
    return slopes[(len(slopes) - 1) // 2] * 1e3


def profile_step(trainer, host_feeds: List[dict], steps: int = 10,
                 repeats: int = 3) -> Dict[str, float]:
    """Attribute a training step's wall time to framework phases.

    ``host_feeds``: a few host batch dicts ({input name: numpy array},
    the bound shapes), kept on the host so the place phase measures the
    real copy.  The trainer steps ``2 + steps * (1 + 4 * repeats)`` times
    (it trains: give it a scratch copy).  Returns per-phase
    milliseconds, ``host_gap_ms`` and ``step_ms``."""
    feeds = [dict(f) for f in host_feeds]
    placed = [trainer.place_batch(f) for f in feeds]

    # warm up: one full step, closed by a wait
    _sync(trainer.step(placed[0]))

    t0 = time.perf_counter()
    for i in range(steps):
        trainer.place_batch(dict(feeds[i % len(feeds)]))
    place_ms = (time.perf_counter() - t0) / steps * 1e3

    t0 = time.perf_counter()
    for i in range(steps):
        heads = trainer.step(placed[i % len(placed)])
    dispatch_ms = (time.perf_counter() - t0) / steps * 1e3
    _sync(heads)  # drain before the slope phase

    def run_steps(n: int) -> None:
        h = None
        for i in range(n):
            h = trainer.step(placed[i % len(placed)])
        _sync(h)

    device_ms = _device_slope_ms(run_steps, steps, repeats)

    # fetch: the device is idle (run_steps ended with a wait)
    heads = trainer.step(placed[0])
    _sync(heads)
    n = max(3, repeats)
    t0 = time.perf_counter()
    for _ in range(n):
        _fetch(heads)
    fetch_ms = (time.perf_counter() - t0) / n * 1e3

    gap = max(0.0, place_ms + dispatch_ms - device_ms)
    return {
        "place_ms": place_ms,
        "dispatch_ms": dispatch_ms,
        "device_ms": device_ms,
        "fetch_ms": fetch_ms,
        "host_gap_ms": gap,
        "step_ms": device_ms + gap,
    }


def format_step_profile(prof: Dict[str, float], title: str = "step") -> str:
    """Render a profile dict as the per-phase attribution table."""
    rows = [
        ("host pre-step (place_batch)", prof["place_ms"]),
        ("dispatch (step() return)", prof["dispatch_ms"]),
        ("device compute (slope)", prof["device_ms"]),
        ("fetch (device->host RTT)", prof["fetch_ms"]),
        ("host gap (unhidden host work)", prof["host_gap_ms"]),
        ("effective step", prof["step_ms"]),
    ]
    width = max(len(r[0]) for r in rows)
    lines = [f"step-phase profile [{title}]",
             f"{'phase'.ljust(width)}   ms/step"]
    for name, ms in rows:
        lines.append(f"{name.ljust(width)}   {ms:8.3f}")
    return "\n".join(lines)
