"""Flight recorder: a bounded ring of recent step records.

Counterpart of ``mxnet_tpu/telemetry/flight.py``.  The postmortem layer:
``record()`` appends one small host-side dict per step (the serving
engine's step index and occupancy, a shed, a failover, a scale event —
whatever the caller already knows without a device read), and ``dump()``
writes the ring plus a full metrics snapshot and the trace tail to a JSON
file.  Dumps fire on a replica's death and on an engine step's exception,
so "what were the last 256 steps doing" no longer depends on what
happened to be logged.

Recording is always on (a deque append; the ring costs ~100 KB).
Automatic dumps only write files when ``MXNET_TPU_FLIGHTREC`` names a
directory — an explicit ``dump(path=...)`` always writes.  A dump
must never take the process down on top of the failure it is
documenting: all I/O errors are swallowed into a log line.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

__all__ = ["FlightRecorder"]

log = logging.getLogger(__name__)

DEFAULT_CAPACITY = 256


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring: deque = deque(maxlen=int(capacity))  # shared: guarded_by=_lock
        self._lock = threading.Lock()
        self.dump_dir: Optional[str] = None  # None = auto-dumps off
        self.dump_count = 0                  # shared: guarded_by=_lock
        self.last_dump: Optional[str] = None

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._ring = deque(self._ring, maxlen=max(1, int(capacity)))

    def record(self, rec: Dict[str, Any]) -> None:
        # trainer, watchdog, and serve threads all append; an unlocked
        # deque append is atomic but racing dump()'s list() copy tears
        # the snapshot mid-iteration
        with self._lock:
            self._ring.append(rec)

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self, reason: str, path: Optional[str] = None,
             metrics: Optional[Dict[str, float]] = None,
             trace_tail: Optional[list] = None,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write the ring to ``path`` (or an auto-named file under
        ``dump_dir``).  Returns the written path, or None when
        auto-dumps are disabled / the write failed."""
        if path is None:
            if self.dump_dir is None:
                return None
            with self._lock:
                self.dump_count += 1
                seq = self.dump_count
            path = os.path.join(
                self.dump_dir,
                f"flightrec-{reason}-p{os.getpid()}"
                f"-{seq}.json")
        doc = {
            "reason": reason,
            "time": time.time(),
            "pid": os.getpid(),
            "capacity": self.capacity,
            "records": self.records(),
        }
        if metrics is not None:
            doc["metrics"] = metrics
        if trace_tail:
            doc["trace_tail"] = trace_tail
        if extra:
            doc["extra"] = extra
        try:
            d = os.path.dirname(os.path.abspath(path))
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("flight recorder: dump %r failed: %s", reason, e)
            return None
        with self._lock:
            self.last_dump = path
        log.warning("flight recorder: dumped %d step records to %s "
                    "(reason: %s)", len(doc["records"]), path, reason)
        return path
