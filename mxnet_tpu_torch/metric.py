"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (host code, kept as a copy so the
port imports nothing of the JAX package).  ``update`` takes labels and
predictions as port NDArrays, torch tensors on either device or numpy
arrays, and converts them to host numpy arrays there and only there
(:func:`_as_numpy`): a metric update on card tensors is a device-to-host
copy, which is why ``ShardedTrainer.fit`` folds accuracy on the card and
buffers other metrics (:class:`AsyncMetric`).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE",
           "RMSE", "CrossEntropy", "CustomMetric", "CompositeEvalMetric",
           "AsyncMetric", "create", "np"]


def _as_numpy(x) -> numpy.ndarray:
    if isinstance(x, NDArray):
        x = x.data
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return numpy.asarray(x)


def check_label_shapes(labels, preds, shape: bool = False):
    n_label = len(labels)
    n_pred = len(preds)
    if n_label != n_pred:
        raise MXNetError(f"Shape of labels {n_label} does not match shape of "
                         f"predictions {n_pred}")


class EvalMetric:
    """Base metric: ``sum_metric / num_inst`` (per output with ``num``)."""

    def __init__(self, name: str, num: Optional[int] = None):
        self.name = name
        self.num = num
        self.reset()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num is None:
            value = (self.sum_metric / self.num_inst if self.num_inst
                     else float("nan"))
            return (self.name, value)
        names = [f"{self.name}_{i}" for i in range(self.num)]
        values = [s / n if n else float("nan")
                  for s, n in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            return [(name, value)]
        return list(zip(name, value))


class Accuracy(EvalMetric):
    """Classification accuracy (argmax over axis 1 of 2-d predictions)."""

    def __init__(self):
        super().__init__("accuracy")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(numpy.int32)
            if pred.ndim > 1:
                pred = numpy.argmax(pred, axis=1)
            pred = pred.astype(numpy.int32).reshape(-1)
            label = label.reshape(-1)
            check_label_shapes([label], [pred])
            self.sum_metric += int((pred == label).sum())
            self.num_inst += label.size


class TopKAccuracy(EvalMetric):
    """Top-k accuracy."""

    def __init__(self, top_k: int = 1, **kwargs):
        self.top_k = kwargs.get("top_k", top_k)
        super().__init__(f"top_k_accuracy_{self.top_k}")
        if self.top_k <= 1:
            raise MXNetError("top_k should be no less than 2")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(numpy.int32).reshape(-1)
            if pred.ndim != 2:
                raise MXNetError("Predictions should be 2 dims")
            topk = numpy.argsort(pred, axis=1)[:, -self.top_k:]
            self.sum_metric += int((topk == label[:, None]).any(axis=1).sum())
            self.num_inst += label.size


class F1(EvalMetric):
    """Binary F1, averaged over updates."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(numpy.int32).reshape(-1)
            if pred.ndim > 1:
                pred = numpy.argmax(pred, axis=1)
            pred = pred.astype(numpy.int32).reshape(-1)
            if len(numpy.unique(label)) > 2:
                raise MXNetError("F1 currently only supports binary "
                                 "classification.")
            tp = int(((pred == 1) & (label == 1)).sum())
            fp = int(((pred == 1) & (label == 0)).sum())
            fn = int(((pred == 0) & (label == 1)).sum())
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            f1 = (2 * precision * recall / (precision + recall)
                  if precision + recall > 0 else 0.0)
            self.sum_metric += f1
            self.num_inst += 1


def _regression_pairs(labels, preds):
    check_label_shapes(labels, preds)
    for label, pred in zip(labels, preds):
        label = _as_numpy(label)
        pred = _as_numpy(pred)
        if label.ndim == 1:
            label = label.reshape(label.shape[0], 1)
        yield label, pred.reshape(label.shape)


class MAE(EvalMetric):
    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        for label, pred in _regression_pairs(labels, preds):
            self.sum_metric += float(numpy.abs(label - pred).mean())
            self.num_inst += 1


class MSE(EvalMetric):
    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        for label, pred in _regression_pairs(labels, preds):
            self.sum_metric += float(((label - pred) ** 2).mean())
            self.num_inst += 1


class RMSE(EvalMetric):
    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        for label, pred in _regression_pairs(labels, preds):
            self.sum_metric += float(numpy.sqrt(((label - pred) ** 2).mean()))
            self.num_inst += 1


class CrossEntropy(EvalMetric):
    """Per-sample negative log-likelihood of the labelled class."""

    def __init__(self, eps: float = 1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            if label.shape[0] != pred.shape[0]:
                raise MXNetError(f"{label.shape[0]} labels for "
                                 f"{pred.shape[0]} predictions")
            prob = pred[numpy.arange(label.shape[0]),
                        label.astype(numpy.int64)]
            self.sum_metric += float((-numpy.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


class CustomMetric(EvalMetric):
    """Wrap ``feval(label, pred)`` over host numpy arrays; it returns a
    value, or ``(num_inst, sum_metric)``."""

    def __init__(self, feval: Callable, name: Optional[str] = None,
                 allow_extra_outputs: bool = False):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                num_inst, sum_metric = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together."""

    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite")
        self.metrics = kwargs.get("metrics", metrics) or []
        self.metrics = [create(m) if isinstance(m, str) else m
                        for m in self.metrics]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def get_metric(self, index: int):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError(f"Metric index {index} is out of range 0 and "
                              f"{len(self.metrics)}")

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def get(self):
        names = []
        results = []
        for metric in self.metrics:
            result = metric.get()
            names.append(result[0])
            results.append(result[1])
        return names, results


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    if hasattr(a, "dtype"):
        return int(a.size) * a.dtype.itemsize
    return 0


class AsyncMetric(EvalMetric):
    """Deferred-fetch facade over any :class:`EvalMetric`.

    ``update`` keeps references to the labels and predictions (tensors
    stay where they are: no device-to-host copy, so no sync) and replays
    them into the wrapped metric every ``period`` updates (sized so at
    most ~64 MB is held alive) or when a value is read through
    ``get``/``get_name_value``/``sum_metric``/``num_inst``.  Safe because
    the eager trainer makes fresh head tensors every step and never
    writes a buffered one in place.
    """

    _MAX_BUFFER_BYTES = 64 << 20

    def __init__(self, inner: Union[str, EvalMetric],
                 period: Optional[int] = None):
        # deliberately no super().__init__: state lives in `inner`
        self.inner = inner if isinstance(inner, EvalMetric) else create(inner)
        self.name = self.inner.name
        self.num = getattr(self.inner, "num", None)
        self._period = period
        self._buf: List = []

    @staticmethod
    def _snap(x):
        # NDArray -> its tensor (a later in-place write to the NDArray
        # replaces nothing buffered here); anything else is kept as is
        return x.data if isinstance(x, NDArray) else x

    def update(self, labels, preds):
        labels = [self._snap(x) for x in (labels or [])]
        preds = [self._snap(x) for x in preds]
        self._buf.append((labels, preds))
        if self._period is None:
            nbytes = sum(_nbytes(a) for a in labels + preds)
            self._period = max(1, min(32, self._MAX_BUFFER_BYTES
                                      // max(1, nbytes)))
        if len(self._buf) >= self._period:
            self._drain()

    def _drain(self):
        buf, self._buf = self._buf, []
        for labels, preds in buf:
            self.inner.update([_as_numpy(x) for x in labels],
                              [_as_numpy(x) for x in preds])

    def reset(self):
        self._buf = []
        self.inner.reset()

    def get(self):
        self._drain()
        return self.inner.get()

    def get_name_value(self):
        self._drain()
        return self.inner.get_name_value()

    def get_metric(self, index: int):
        self._drain()
        return self.inner.get_metric(index)

    @property
    def sum_metric(self):
        self._drain()
        return self.inner.sum_metric

    @property
    def num_inst(self):
        self._drain()
        return self.inner.num_inst


def np(numpy_feval: Callable, name: Optional[str] = None,
       allow_extra_outputs: bool = False) -> CustomMetric:
    """A CustomMetric from a numpy ``feval(label, pred)``."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


_METRICS = {
    "acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
    "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
    "top_k_accuracy": TopKAccuracy, "cross-entropy": CrossEntropy,
}


def create(metric, **kwargs) -> EvalMetric:
    """A metric from a name, a callable, an EvalMetric or a list."""
    if callable(metric):
        return CustomMetric(metric, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(m)
        return composite
    if not isinstance(metric, str):
        raise MXNetError(f"cannot create metric from {metric!r}")
    try:
        return _METRICS[metric.lower()](**kwargs)
    except KeyError as e:
        raise MXNetError(f"unknown metric {metric}; known "
                         f"{sorted(_METRICS)}") from e
