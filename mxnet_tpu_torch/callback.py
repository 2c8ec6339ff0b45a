"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py``, with its log lines letter for
letter (``tools/parse_log.py`` greps Speedometer's ``Epoch[..] Batch
[..]\\tSpeed: .. samples/sec\\tTrain-<name>=<val>`` lines).  Callbacks
receive a ``model.BatchEndParam`` whose ``nbatch`` rewinds at epoch
boundaries; ``ShardedTrainer.fit`` drains its metric only when a callback
reads it (``get_name_value``), so the meter syncs with the card only at
its own cadence.
"""
from __future__ import annotations

import logging
import sys
import time


__all__ = ["do_checkpoint", "log_train_metric", "Speedometer", "ProgressBar"]


def do_checkpoint(prefix: str, manager=None):
    """Epoch-end callback writing ``prefix-symbol.json`` and
    ``prefix-%04d.params`` (``model.save_checkpoint``) for epoch
    ``iter_no + 1``; with ``manager=`` (a
    :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager`) the save goes
    through the manager instead (``save_model``: the snapshot in the
    callback, the writes on the manager's thread, retention GC)."""

    def _callback(iter_no, sym, arg, aux):
        if manager is not None:
            manager.save_model(iter_no + 1, sym, arg, aux)
            return
        from .model import save_checkpoint
        save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period: int, auto_reset: bool = False):
    """Batch-end callback logging the running metric every ``period``
    batches."""

    def _callback(param):
        if param.nbatch % period or param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            param.eval_metric.reset()

    return _callback


class Speedometer:
    """Throughput meter: logs samples/sec every ``frequent`` batches.

    Keeps one timing mark (``perf_counter`` at the last emit or rewind)
    and derives speed from the wall time the current ``frequent``-batch
    window took.  A batch counter that moves backwards means a new epoch
    started: the mark is re-armed and nothing is emitted for the partial
    window.
    """

    def __init__(self, batch_size: int, frequent: int = 50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._mark = None       # perf_counter at window start
        self._mark_batch = 0

    def __call__(self, param):
        now = time.perf_counter()
        rewound = param.nbatch < self._mark_batch
        self._mark_batch = param.nbatch
        if self._mark is None or rewound:
            self._mark = now
            return
        if param.nbatch % self.frequent:
            return
        elapsed = max(now - self._mark, 1e-12)
        speed = self.frequent * self.batch_size / elapsed
        self._emit(param, speed)
        self._mark = now

    def _emit(self, param, speed):
        if param.eval_metric is None:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, speed)
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info(
                "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\tTrain-%s=%f",
                param.epoch, param.nbatch, speed, name, value)


class ProgressBar:
    """In-place ``[====----] NN%`` bar over a known epoch length."""

    def __init__(self, total: int, length: int = 80):
        self.bar_len = length
        self.total = max(total, 1)

    def __call__(self, param):
        frac = min(max(param.nbatch / float(self.total), 0.0), 1.0)
        ticks = round(self.bar_len * frac)
        bar = "=" * ticks + "-" * (self.bar_len - ticks)
        sys.stdout.write(f"[{bar}] {round(100 * frac)}%\r")
