"""Data iterators.

Counterpart of ``mxnet_tpu/io.py``: the ``DataIter`` protocol
(``provide_data``/``provide_label``, ``next``/``reset``), ``NDArrayIter``,
``ResizeIter``, ``PrefetchingIter``, ``DevicePrefetchIter``, ``CSVIter``
and ``MNISTIter``.

Iterators yield host batches: ``NDArrayIter`` builds its slices on
``cpu()`` (outside a ``with ctx:`` scope the port's arrays default to the
card), so the copy to the card is left to whoever places the batch.
:class:`DevicePrefetchIter` places batch *k+1* on a worker thread while
step *k* runs; on a CUDA device its copies run on a side stream it owns
and each batch is handed to the consumer's stream through an event.
"""
from __future__ import annotations

import gzip
import logging
import os
import queue
import struct
import threading
from collections import namedtuple
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array as nd_array

__all__ = ["DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "CSVIter", "MNISTIter",
           "DataDesc", "pad_batch_to_bucket"]


DataDesc = namedtuple("DataDesc", ["name", "shape"])


class DataBatch:
    """One mini-batch: lists of data and label arrays, the pad count of a
    wrapped tail batch and the sample indices."""

    def __init__(self, data: List[NDArray], label: List[NDArray],
                 pad: int = 0, index: Optional[np.ndarray] = None,
                 bucket_key: Any = None,
                 provide_data: Optional[List[Tuple]] = None,
                 provide_label: Optional[List[Tuple]] = None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


def pad_batch_to_bucket(batch: DataBatch, bucket: int, axis: int = 1,
                        pad_value=0, label_pad=None) -> DataBatch:
    """A NEW batch whose arrays are padded along ``axis`` up to ``bucket``
    (data with ``pad_value``, labels with ``label_pad``, default
    ``pad_value``), with ``bucket_key=bucket`` and the ``provide_*``
    shapes rewritten.  Arrays without dim ``axis``, or already at the
    bucket size, pass through.  The padded arrays are host NDArrays."""
    from .compile_cache import pad_to_bucket
    if label_pad is None:
        label_pad = pad_value

    def pad_list(arrs, fill):
        out = []
        for a in arrs or []:
            host = a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)
            if axis < host.ndim and host.shape[axis] != bucket:
                out.append(nd_array(pad_to_bucket(host, bucket, axis=axis,
                                                  pad_value=fill),
                                    ctx=cpu()))
            else:
                out.append(a if isinstance(a, NDArray)
                           else nd_array(host, ctx=cpu()))
        return out

    def pad_desc(descs, arrs):
        if descs is None:
            return None
        out = []
        for d, a in zip(descs, arrs):
            name, shape = d[0], tuple(a.shape)
            out.append(type(d)(name, shape) if isinstance(d, DataDesc)
                       else (name, shape) + tuple(d[2:]))
        return out

    data = pad_list(batch.data, pad_value)
    label = pad_list(batch.label, label_pad)
    return DataBatch(data=data, label=label, pad=batch.pad,
                     index=batch.index, bucket_key=bucket,
                     provide_data=pad_desc(batch.provide_data, data),
                     provide_label=pad_desc(batch.provide_label, label))


class DataIter:
    """The iterator protocol."""

    def __init__(self):
        self.batch_size = 0

    @property
    def provide_data(self) -> List[Tuple[str, Tuple[int, ...]]]:
        raise NotImplementedError

    @property
    def provide_label(self) -> List[Tuple[str, Tuple[int, ...]]]:
        raise NotImplementedError

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty: bool, default_name: str):
    """Normalise to a list of (name, numpy array)."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise MXNetError("data cannot be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError("Input must be NDArray, numpy.ndarray, list or "
                         "dict")
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, np.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays in batches of ``batch_size``; the
    tail batch is padded with wrapped-around samples (``"pad"``), dropped
    (``"discard"``) or carried into the next epoch (``"roll_over"``).
    ``shuffle`` permutes once, with numpy's global generator, as the JAX
    package does (so one ``np.random.seed`` gives both the same order)."""

    def __init__(self, data, label=None, batch_size: int = 1,
                 shuffle: bool = False, last_batch_handle: str = "pad",
                 data_name: str = "data", label_name: str = "softmax_label"):
        super().__init__()
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if self.num_data < batch_size:
            raise MXNetError("batch_size is larger than data size")
        if shuffle:
            idx = np.arange(self.num_data)
            np.random.shuffle(idx)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size

    @property
    def provide_data(self):
        return [(k, (self.batch_size,) + v.shape[1:]) for k, v in self.data]

    @property
    def provide_label(self):
        return [(k, (self.batch_size,) + v.shape[1:]) for k, v in self.label]

    @property
    def steps_per_epoch(self):
        # "pad" pads the tail batch (ceil); "discard" trimmed num_data at
        # init so floor == ceil; "roll_over" carries the tail (floor)
        n, b = self.num_data, self.batch_size
        return -(-n // b) if self.last_batch_handle == "pad" else n // b

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if (self.last_batch_handle == "roll_over" and
                self.cursor > self.num_data):
            self.cursor = (-self.batch_size
                           + (self.cursor % self.num_data) % self.batch_size)
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise MXNetError("NDArrayIter read past the end of its data")
        if self.cursor + self.batch_size <= self.num_data:
            return [nd_array(v[self.cursor:self.cursor + self.batch_size],
                             ctx=cpu())
                    for _, v in data_source]
        # pad with wrapped-around samples
        pad = self.batch_size - (self.num_data - self.cursor)
        return [nd_array(np.concatenate([v[self.cursor:], v[:pad]], axis=0),
                         ctx=cpu())
                for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if (self.last_batch_handle == "pad" and
                self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """``size`` batches per epoch from ``data_iter``, restarting it when
    it runs out."""

    def __init__(self, data_iter: DataIter, size: int,
                 reset_internal: bool = True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch: Optional[DataBatch] = None
        self.batch_size = data_iter.batch_size

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """One background thread per iterator, each pulling its next batch
    while the consumer works; the batches of all iterators are joined
    into one."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        self.n_iter = len(iters)
        if self.n_iter == 0:
            raise MXNetError("PrefetchingIter needs at least one iterator")
        self.iters = list(iters)
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch: List[Optional[DataBatch]] = [None] * self.n_iter
        self.next_batch: List[Optional[DataBatch]] = [None] * self.n_iter

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i],
                             daemon=True)
            for i in range(self.n_iter)]
        for t in self.prefetch_threads:
            t.start()

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()
        for t in self.prefetch_threads:
            t.join(timeout=1.0)

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[(r[n] if n in r else n, s) for n, s in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[(r[n] if n in r else n, s) for n, s in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            if any(b is not None for b in self.next_batch):
                raise MXNetError("Number of entry mismatches between "
                                 "iterators")
            return False
        if any(b.pad != self.next_batch[0].pad for b in self.next_batch):
            raise MXNetError("Number of entry mismatches between iterators")
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad,
            self.next_batch[0].index)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _tensors(obj):
    """Every torch tensor of a staged batch (a dict, list, tuple,
    DataBatch, NDArray or tensor)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, NDArray):
        yield obj.data
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, DataBatch):
        yield from _tensors(obj.data)
        yield from _tensors(obj.label)


class DevicePrefetchIter(DataIter):
    """Double-buffered device placement on a background thread.

    While step *k* runs on the card, a worker thread pulls batch *k+1*
    from ``data_iter`` and runs ``place_fn`` on it (for the trainer,
    ``ShardedTrainer.place_batch``: a copy from pinned host memory with
    ``non_blocking=True``).  Yields what ``place_fn`` returned; the host
    batch stays on :attr:`current_source` (``label``, ``pad``).

    With ``device`` a CUDA device, ``place_fn`` runs on a side
    ``torch.cuda.Stream`` this iterator owns and the worker records a
    ``torch.cuda.Event`` after it.  :meth:`next`, on the consumer's
    thread, makes the consumer's current stream wait for that event and
    marks every staged tensor with ``record_stream`` for that stream, so
    the step never reads a copy that has not landed and the caching
    allocator never hands a staged buffer back to the side stream while
    the step still reads it.  On the CPU there are no streams.

    Failures of the inner iterator or ``place_fn`` are retried up to
    ``max_retries`` times (``MXNET_TPU_PREFETCH_RETRIES``, default 2)
    with exponential backoff, counted on :attr:`retry_count` and the
    telemetry counter ``io.prefetch_retries``; ``StopIteration`` is never
    retried.  Any other exception of the worker is raised by :meth:`next`
    on the consumer's thread.  :meth:`close` stops the thread and drops
    the staged batches.
    """

    _END = ("end", None, None, None)

    def __init__(self, data_iter: DataIter, place_fn=None, depth: int = 2,
                 max_retries: Optional[int] = None,
                 retry_backoff: float = 0.05, logger=None, device=None):
        super().__init__()
        if depth < 1:
            raise MXNetError("DevicePrefetchIter depth must be >= 1")
        self.data_iter = data_iter
        self.place_fn = place_fn if place_fn is not None else (lambda b: b)
        self.depth = depth
        if max_retries is None:
            max_retries = int(os.environ.get("MXNET_TPU_PREFETCH_RETRIES",
                                             "2"))
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff = float(retry_backoff)
        self.logger = logger or logging.getLogger(__name__)
        self.retry_count = 0
        self.batch_size = getattr(data_iter, "batch_size", 0)
        self.current_batch = None   # staged batch (place_fn output)
        self.current_source = None  # raw host batch from data_iter
        dev = None if device is None else torch.device(device)
        self._device = dev if dev is not None and dev.type == "cuda" else None
        self._stream = None         # the side stream, made on first use
        self._queue: Optional["queue.Queue"] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def _start(self) -> None:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        inner, place = self.data_iter, self.place_fn
        if self._device is not None and self._stream is None:
            self._stream = torch.cuda.Stream(device=self._device)
        stream = self._stream

        def put(item):
            # bounded put that stays responsive to shutdown
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    continue

        retries = self.max_retries
        backoff = self.retry_backoff

        def call_retrying(what, fn, *args):
            # bounded retry with exponential backoff for transient
            # failures; StopIteration is the protocol, not an error, and
            # shutdown aborts the wait
            failures = 0
            while True:
                try:
                    return fn(*args)
                except StopIteration:
                    raise
                except Exception as exc:
                    failures += 1
                    if failures > retries:
                        raise
                    self.retry_count += 1
                    from . import telemetry
                    telemetry.counter("io.prefetch_retries").inc()
                    self.logger.warning(
                        "prefetch %s failed (%s: %s); retry %d/%d",
                        what, type(exc).__name__, exc, failures, retries)
                    if stop.wait(backoff * (2 ** (failures - 1))):
                        raise

        def stage(batch):
            if stream is None:
                return place(batch), None
            with torch.cuda.stream(stream):
                staged = place(batch)
                event = torch.cuda.Event()
                event.record(stream)
            return staged, event

        def worker():
            from . import telemetry
            telemetry.name_thread("prefetch")
            n = 0
            try:
                while not stop.is_set():
                    with telemetry.span("prefetch.batch", n=n):
                        try:
                            batch = call_retrying("iterator", inner.next)
                        except StopIteration:
                            put(DevicePrefetchIter._END)
                            return
                        staged, event = call_retrying("place_fn", stage,
                                                      batch)
                    n += 1
                    put(("batch", staged, batch, event))
            except BaseException as exc:  # raised again by next()
                put(("error", exc, None, None))

        self._queue = q
        self._stop = stop
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _shutdown(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        # unblock a producer stuck on a full queue
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            self.logger.warning(
                "DevicePrefetchIter worker did not exit within 5s")
        self._queue = None
        self._thread = None
        self._stop = None

    def close(self) -> None:
        """Stop the background thread and drop the staged batches; safe
        to call repeatedly, and ``reset``/``next`` start it again."""
        self._shutdown()
        self.current_batch = None
        self.current_source = None

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass

    def reset(self):
        self._shutdown()
        self.current_batch = None
        self.current_source = None
        self.data_iter.reset()

    def next(self):
        if self._thread is None:
            self._start()
        kind, staged, source, event = self._queue.get()
        if kind == "end":
            # keep the sentinel so repeated next() keeps raising
            self._queue.put(DevicePrefetchIter._END)
            raise StopIteration
        if kind == "error":
            self._queue.put(("error", staged, None, None))
            raise staged
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in _tensors(staged):
                if t.is_cuda:
                    t.record_stream(consumer)
        self.current_batch = staged
        self.current_source = source
        return staged

    def iter_next(self):
        try:
            self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self.current_source.data

    def getlabel(self):
        return self.current_source.label

    def getindex(self):
        return getattr(self.current_source, "index", None)

    def getpad(self):
        return getattr(self.current_source, "pad", 0)


class CSVIter(NDArrayIter):
    """Batches from CSV files, with ``num_parts``/``part_index`` shards."""

    def __init__(self, data_csv: str, data_shape,
                 label_csv: Optional[str] = None, label_shape=(1,),
                 batch_size: int = 1, num_parts: int = 1,
                 part_index: int = 0, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[1:] == (1,):
                label = label[:, 0]
        else:
            label = np.zeros(data.shape[0], dtype=np.float32)
        if num_parts > 1:
            data = data[part_index::num_parts]
            label = label[part_index::num_parts]
        super().__init__(data, label, batch_size=batch_size, **kwargs)


class MNISTIter(NDArrayIter):
    """Batches from idx-format MNIST files (optionally gzipped), scaled to
    [0, 1], with shards and an optional flat layout; ``shuffle`` permutes
    with ``np.random.RandomState(seed)``."""

    def __init__(self, image: str, label: str, batch_size: int = 128,
                 shuffle: bool = True, flat: bool = False,
                 silent: bool = False, seed: int = 0, num_parts: int = 1,
                 part_index: int = 0, input_shape=None, **kwargs):
        imgs = self._read_idx_images(image)
        labels = self._read_idx_labels(label)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        elif input_shape is not None:
            imgs = imgs.reshape((-1,) + tuple(input_shape))
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, 28, 28)
        imgs = imgs.astype(np.float32) / 255.0
        if num_parts > 1:
            imgs = imgs[part_index::num_parts]
            labels = labels[part_index::num_parts]
        if shuffle:
            rs = np.random.RandomState(seed)
            idx = rs.permutation(imgs.shape[0])
            imgs, labels = imgs[idx], labels[idx]
        super().__init__(imgs, labels.astype(np.float32),
                         batch_size=batch_size, **kwargs)

    @staticmethod
    def _open(path: str):
        if path.endswith(".gz"):
            return gzip.open(path, "rb")
        return open(path, "rb")

    @classmethod
    def _read_idx_images(cls, path: str) -> np.ndarray:
        with cls._open(path) as f:
            magic, n, rows, cols = struct.unpack(">iiii", f.read(16))
            if magic != 2051:
                raise MXNetError(f"{path}: bad MNIST image magic {magic}")
            return np.frombuffer(f.read(n * rows * cols),
                                 dtype=np.uint8).reshape(n, rows, cols)

    @classmethod
    def _read_idx_labels(cls, path: str) -> np.ndarray:
        with cls._open(path) as f:
            magic, n = struct.unpack(">ii", f.read(8))
            if magic != 2049:
                raise MXNetError(f"{path}: bad MNIST label magic {magic}")
            return np.frombuffer(f.read(n), dtype=np.uint8)
