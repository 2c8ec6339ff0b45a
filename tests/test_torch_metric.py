"""Evaluation metrics of the PyTorch port (mxnet_tpu_torch/metric.py)
against the JAX package's.

Every metric ``create`` knows gets the same predictions and labels (numpy,
made from a seed) in both packages, over three updates; the port's side
also takes them as torch tensors and as port NDArrays.  Instance counts
must be equal exactly and values within 1e-6 relative (float64 host
arithmetic on both sides: only the order of a few sums may differ).
``CompositeEvalMetric``, ``CustomMetric``/``metric.np``, the
``AsyncMetric`` buffer and its drain, and the errors on mismatched label
counts are covered the same way.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import metric as jmetric
from mxnet_tpu import nd as jnd
from mxnet_tpu.base import MXNetError as JaxError

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError

N, C = 24, 5


def _batches(kind, seed=0, n=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "regression":
            label = rng.randn(N).astype(np.float32)
            pred = rng.randn(N, 1).astype(np.float32)
        elif kind == "binary":
            label = rng.randint(0, 2, N).astype(np.float32)
            pred = rng.rand(N, 2).astype(np.float32)
        else:
            label = rng.randint(0, C, N).astype(np.float32)
            logits = rng.randn(N, C).astype(np.float32)
            pred = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        out.append((label, pred))
    return out


CASES = {
    "acc": ({}, "class"),
    "accuracy": ({}, "class"),
    "top_k_accuracy": ({"top_k": 3}, "class"),
    "ce": ({}, "class"),
    "cross-entropy": ({"eps": 1e-6}, "class"),
    "f1": ({}, "binary"),
    "mae": ({}, "regression"),
    "mse": ({}, "regression"),
    "rmse": ({}, "regression"),
}

FORMS = {
    "numpy": lambda a: a,
    "tensor": torch.from_numpy,
    "ndarray": lambda a: tnd.array(a, ctx=mxt.cpu()),
}


def _assert_same(tm, jm):
    assert tm.num_inst == jm.num_inst
    tn, tv = tm.get()
    jn, jv = jm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_equals_jax(name, form):
    kw, kind = CASES[name]
    jm = jmetric.create(name, **kw)
    tm = tmetric.create(name, **kw)
    assert type(tm).__name__ == type(jm).__name__
    for label, pred in _batches(kind):
        jm.update([jnd.array(label)], [jnd.array(pred)])
        tm.update([FORMS[form](label)], [FORMS[form](pred)])
    _assert_same(tm, jm)
    tm.reset()
    jm.reset()
    assert tm.num_inst == jm.num_inst == 0


def test_custom_and_np_metrics_equal_jax():
    def feval(label, pred):
        return float(np.abs(pred.argmax(1) - label).sum()), 1

    def pair_count(label, pred):
        return (label.size, float((pred.argmax(1) == label).sum()))

    for make in (lambda m: m.CustomMetric(feval, name="gap"),
                 lambda m: m.np(pair_count),
                 lambda m: m.create(lambda l, p: float(p.max()))):
        jm, tm = make(jmetric), make(tmetric)
        for label, pred in _batches("class", seed=3):
            jm.update([label], [pred])
            tm.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
        _assert_same(tm, jm)


def test_composite_metric_equals_jax():
    jm = jmetric.create(["acc", "ce", jmetric.TopKAccuracy(top_k=2)])
    tm = tmetric.create(["acc", "ce", tmetric.TopKAccuracy(top_k=2)])
    assert isinstance(tm, tmetric.CompositeEvalMetric)
    for label, pred in _batches("class", seed=4):
        jm.update([label], [pred])
        tm.update([label], [pred])
    tn, tv = tm.get()
    jn, jv = jm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    assert tm.get_metric(0).num_inst == jm.get_metric(0).num_inst
    assert tm.get_name_value() == list(zip(tn, tv))


@pytest.mark.parametrize("period", [None, 2])
def test_async_metric_buffers_then_drains_like_jax(period):
    jm = jmetric.AsyncMetric("ce", period=period)
    tm = tmetric.AsyncMetric("ce", period=period)
    batches = _batches("class", seed=5, n=5)
    for i, (label, pred) in enumerate(batches):
        jm.update([jnd.array(label)], [jnd.array(pred)])
        tm.update([tnd.array(label, ctx=mxt.cpu())],
                  [torch.from_numpy(pred)])
        # nothing replayed into the inner metric before the period fills
        want_drained = 0 if period is None else (i + 1) // period * period
        assert tm.inner.num_inst == want_drained * N
        assert len(tm._buf) == len(jm._buf)
    # a read drains the buffer
    assert tm.num_inst == jm.num_inst == 5 * N
    assert tm._buf == []
    np.testing.assert_allclose(tm.sum_metric, jm.sum_metric, rtol=1e-6)
    _assert_same(tm, jm)
    tm.reset()
    assert tm.inner.num_inst == 0 and tm._buf == []


def test_async_metric_period_from_buffer_bytes():
    tm = tmetric.AsyncMetric("acc")
    jm = jmetric.AsyncMetric("acc")
    big = np.zeros((1024, 4096), np.float32)          # 16 MB a head
    label = np.zeros(1024, np.float32)
    tm.update([label], [torch.from_numpy(big)])
    jm.update([label], [big])
    assert tm._period == jm._period == 3


def test_label_count_mismatch_raises_in_both():
    label, pred = _batches("class", n=1)[0]
    for name in ("acc", "ce", "mae", "top_k_accuracy"):
        kw = {"top_k": 2} if name == "top_k_accuracy" else {}
        with pytest.raises(JaxError, match="does not match"):
            jmetric.create(name, **kw).update([label, label], [pred])
        with pytest.raises(MXNetError, match="does not match"):
            tmetric.create(name, **kw).update([label, label], [pred])


def test_bad_metric_arguments_raise_in_both():
    for m, err in ((jmetric, JaxError), (tmetric, MXNetError)):
        with pytest.raises(err, match="unknown metric"):
            m.create("no-such-metric")
        with pytest.raises(err, match="top_k"):
            m.TopKAccuracy(top_k=1)
        with pytest.raises(err, match="binary"):
            m.F1().update([np.array([0, 1, 2])],
                          [np.zeros((3, 3), np.float32)])
    with pytest.raises(MXNetError, match="2 dims"):
        tmetric.TopKAccuracy(top_k=2).update([np.zeros(3)], [np.zeros(3)])
