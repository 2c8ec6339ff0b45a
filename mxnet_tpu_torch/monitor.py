"""Training-time tensor monitor.

Counterpart of ``mxnet_tpu/monitor.py``: collects a statistic of every
op output (through the executor's monitor hook,
``Executor.set_monitor_callback``) plus every argument matching a
regular expression, every ``interval`` batches.  Reading a statistic
copies it to the host, so a collecting batch synchronises with the card.
"""
from __future__ import annotations

import logging
import re
from math import sqrt
from typing import Callable, List, Optional, Tuple

from .ndarray import NDArray, norm

__all__ = ["Monitor"]


class Monitor:
    """Monitor outputs, weights and gradients for debugging.

    Parameters
    ----------
    interval : int
        Batches between collections.
    stat_func : callable, optional
        NDArray -> NDArray statistic; default mean absolute value
        ``|x| / sqrt(size)``.
    pattern : str
        Regex over tensor names choosing what to record.
    sort : bool
        Sort results by tensor name before printing.
    """

    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        if stat_func is None:
            def asum_stat(x: NDArray) -> NDArray:
                return norm(x) / sqrt(x.size)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue: List[Tuple[int, str, NDArray]] = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def _stat_helper(self, name: str, array: NDArray) -> None:
        """Executor hook: record a stat of one node output."""
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(array)))

    def install(self, exe) -> None:
        """Attach to an Executor (may be called for several)."""
        exe.set_monitor_callback(self._stat_helper)
        self.exes.append(exe)

    def tic(self) -> None:
        """Start collecting for this batch; call before forward."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self) -> List[Tuple[int, str, str]]:
        """Stop collecting; returns ``(step, name, stat-string)`` rows."""
        if not self.activated:
            return []
        for exe in self.exes:
            for name, array in exe.arg_dict.items():
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            parts = []
            for v in v_list:
                arr = v.asnumpy()
                parts.append(str(arr.item()) if arr.size == 1 else str(arr))
            res.append((n, k, "\t".join(parts)))
        self.queue = []
        return res

    def toc_print(self) -> None:
        """Stop collecting and log the results.  Each row also lands in
        the telemetry stream (kind ``monitor``) when
        ``MXNET_TPU_METRICS_FILE`` is set, so tensor stats are greppable
        next to step records instead of living only in the log."""
        from . import telemetry
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
            telemetry.emit("monitor", {"step": n, "tensor": k, "stat": v})
