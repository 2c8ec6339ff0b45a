"""Data iterators of the PyTorch port (mxnet_tpu_torch/io.py) and the
chaos iterator (mxnet_tpu_torch/chaos.py) against the JAX package's.

The same numpy arrays (or files the test writes: CSV, idx MNIST, gzipped
too) go through each package's iterator; every batch's data, label, pad
and index must be bitwise equal, and the port's batches are host tensors
(``cpu()``), whatever the default context.  ``shuffle`` draws from numpy's
global generator in both packages, so one ``np.random.seed`` gives one
order.  ``DevicePrefetchIter`` is held to the JAX package's cases of
``tests/test_input_pipeline.py`` (order, exhaustion and reset, a worker
exception, ``place_fn`` and ``current_source``, depth) and retries an
injected ``ChaosIter`` crash with backoff without losing a batch.
"""
import gzip
import struct
import threading

import numpy as np
import pytest
import torch

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import io as jio
from mxnet_tpu import profiler as jprof
from mxnet_tpu.base import MXNetError as JaxError

from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import NDArray


def _arrays(n=10, feat=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, feat).astype(np.float32),
            rng.randint(0, 4, n).astype(np.float32))


def _epoch(it):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [l.asnumpy() for l in b.label], b.pad,
                    None if b.index is None else np.asarray(b.index)))
    return out


def _assert_epochs_equal(t, j):
    assert len(t) == len(j) and len(t) > 0
    for (td, tl, tp, ti), (jd, jl, jp, ji) in zip(t, j):
        assert tp == jp
        assert (ti is None) == (ji is None)
        if ti is not None:
            assert ti.tobytes() == ji.tobytes()
        for a, b in zip(td + tl, jd + jl):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def _host_batches(it):
    for b in it:
        for arr in b.data + b.label:
            assert isinstance(arr, NDArray) and arr.data.device.type == "cpu"
    it.reset()


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_epochs_equal_jax(handle):
    x, y = _arrays()
    j = jio.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
    t = tio.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
    assert t.provide_data == j.provide_data
    assert t.provide_label == j.provide_label
    assert t.steps_per_epoch == j.steps_per_epoch
    for _ in range(3):           # roll_over carries the tail across resets
        _assert_epochs_equal(_epoch(t), _epoch(j))
        t.reset()
        j.reset()
    _host_batches(t)


def test_ndarray_iter_shuffle_follows_the_numpy_seed():
    x, y = _arrays(n=17)
    np.random.seed(11)
    j = jio.NDArrayIter({"a": x, "b": x[:, :1]}, {"lab": y}, batch_size=5,
                        shuffle=True)
    np.random.seed(11)
    t = tio.NDArrayIter({"a": x, "b": x[:, :1]}, {"lab": y}, batch_size=5,
                        shuffle=True)
    _assert_epochs_equal(_epoch(t), _epoch(j))
    assert [n for n, _ in t.provide_data] == ["a", "b"]


def test_ndarray_iter_errors_match():
    x, y = _arrays(n=3)
    for m, err in ((jio, JaxError), (tio, MXNetError)):
        with pytest.raises(err, match="batch_size is larger"):
            m.NDArrayIter(x, y, batch_size=4)
        with pytest.raises(err, match="data cannot be None"):
            m.NDArrayIter(None)


def test_resize_iter_equals_jax():
    x, y = _arrays(n=12)
    j = jio.ResizeIter(jio.NDArrayIter(x, y, batch_size=4), 5)
    t = tio.ResizeIter(tio.NDArrayIter(x, y, batch_size=4), 5)
    for _ in range(2):
        _assert_epochs_equal(_epoch(t), _epoch(j))
        t.reset()
        j.reset()


def test_prefetching_iter_equals_jax():
    x, y = _arrays(n=12)
    x2 = x * 2

    def make(m):
        return m.PrefetchingIter(
            [m.NDArrayIter(x, y, batch_size=4),
             m.NDArrayIter({"data2": x2}, batch_size=4)],
            rename_data=[{"data": "a"}, {"data2": "b"}])

    j, t = make(jio), make(tio)
    assert t.provide_data == j.provide_data
    for _ in range(2):
        _assert_epochs_equal(_epoch(t), _epoch(j))
        t.reset()
        j.reset()


def test_csv_iter_equals_jax(tmp_path):
    x, y = _arrays(n=9, feat=6)
    np.savetxt(tmp_path / "d.csv", x, delimiter=",")
    np.savetxt(tmp_path / "l.csv", y, delimiter=",")
    for kw in ({}, {"num_parts": 2, "part_index": 1}):
        j = jio.CSVIter(str(tmp_path / "d.csv"), (2, 3),
                        label_csv=str(tmp_path / "l.csv"), batch_size=2,
                        **kw)
        t = tio.CSVIter(str(tmp_path / "d.csv"), (2, 3),
                        label_csv=str(tmp_path / "l.csv"), batch_size=2,
                        **kw)
        _assert_epochs_equal(_epoch(t), _epoch(j))


def _write_mnist(tmp_path, n=20, gz=False):
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    ip, lp = tmp_path / f"img{suffix}", tmp_path / f"lab{suffix}"
    with op(ip, "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, 28, 28) + imgs.tobytes())
    with op(lp, "wb") as f:
        f.write(struct.pack(">ii", 2049, n) + labels.tobytes())
    return str(ip), str(lp)


@pytest.mark.parametrize("kw", [
    dict(shuffle=False), dict(shuffle=True, seed=4, flat=True),
    dict(num_parts=2, part_index=0, input_shape=(784,)),
], ids=["plain", "shuffle_flat", "sharded"])
@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gzip"])
def test_mnist_iter_equals_jax(tmp_path, gz, kw):
    ip, lp = _write_mnist(tmp_path, gz=gz)
    j = jio.MNISTIter(ip, lp, batch_size=4, **kw)
    t = tio.MNISTIter(ip, lp, batch_size=4, **kw)
    _assert_epochs_equal(_epoch(t), _epoch(j))
    _host_batches(t)


def test_mnist_iter_rejects_bad_magic(tmp_path):
    ip, lp = _write_mnist(tmp_path)
    for m, err in ((jio, JaxError), (tio, MXNetError)):
        with pytest.raises(err, match="magic"):
            m.MNISTIter(lp, lp)


def test_pad_batch_to_bucket_equals_jax():
    rng = np.random.RandomState(5)
    data = rng.rand(2, 5).astype(np.float32)
    label = rng.randint(0, 9, (2, 5)).astype(np.float32)
    other = rng.rand(2).astype(np.float32)
    jb = jio.DataBatch([jio.nd_array(data), jio.nd_array(other)],
                       [jio.nd_array(label)],
                       provide_data=[jio.DataDesc("data", (2, 5)),
                                     ("o", (2,))],
                       provide_label=[("softmax_label", (2, 5))])
    tb = tio.DataBatch([tio.nd_array(data, ctx=tio.cpu()),
                        tio.nd_array(other, ctx=tio.cpu())],
                       [tio.nd_array(label, ctx=tio.cpu())],
                       provide_data=[tio.DataDesc("data", (2, 5)),
                                     ("o", (2,))],
                       provide_label=[("softmax_label", (2, 5))])
    jp = jio.pad_batch_to_bucket(jb, 8, pad_value=0, label_pad=-1)
    tp = tio.pad_batch_to_bucket(tb, 8, pad_value=0, label_pad=-1)
    assert tp.bucket_key == jp.bucket_key == 8
    assert tp.provide_data == jp.provide_data
    assert tp.provide_label == jp.provide_label
    for a, b in zip(tp.data + tp.label, jp.data + jp.label):
        assert a.asnumpy().tobytes() == b.asnumpy().tobytes()
    for m, b, err in ((jio, jb, JaxError), (tio, tb, MXNetError)):
        with pytest.raises(err, match="exceeds bucket"):
            m.pad_batch_to_bucket(b, 3)


# ---------------------------------------------------------------------------
# DevicePrefetchIter (tests/test_input_pipeline.py's cases, both packages)
# ---------------------------------------------------------------------------

def _nd_iter(m, n=16, feat=4, batch=4):
    data = np.arange(n * feat, dtype=np.float32).reshape(n, feat)
    label = np.arange(n, dtype=np.float32)
    return m.NDArrayIter(data, label, batch_size=batch)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_device_prefetch_preserves_order_and_content(depth):
    direct = [(b.data[0].asnumpy(), b.label[0].asnumpy())
              for b in _nd_iter(jio)]
    for m in (jio, tio):
        pre = [(b.data[0].asnumpy(), b.label[0].asnumpy())
               for b in m.DevicePrefetchIter(_nd_iter(m), depth=depth)]
        assert len(pre) == len(direct) == 4
        for (dd, dl), (pd, pl) in zip(direct, pre):
            assert dd.tobytes() == pd.tobytes()
            assert dl.tobytes() == pl.tobytes()


def test_device_prefetch_exhaustion_and_reset():
    for m in (jio, tio):
        it = m.DevicePrefetchIter(_nd_iter(m))
        assert sum(1 for _ in it) == 4
        for _ in range(3):         # the end sentinel is re-queued
            with pytest.raises(StopIteration):
                it.next()
        it.reset()
        assert sum(1 for _ in it) == 4
        it.close()


def test_device_prefetch_propagates_worker_exception():
    class Boom(RuntimeError):
        pass

    for m in (jio, tio):
        class FailingIter(m.DataIter):
            def __init__(self, inner, fail_at):
                super().__init__()
                self.inner, self.fail_at, self.n = inner, fail_at, 0

            def next(self):
                if self.n >= self.fail_at:
                    raise Boom("disk fell over")
                self.n += 1
                return self.inner.next()

        it = m.DevicePrefetchIter(FailingIter(_nd_iter(m), 2),
                                  max_retries=0)
        assert it.next() is not None
        assert it.next() is not None
        with pytest.raises(Boom, match="disk fell over"):
            it.next()
        with pytest.raises(Boom):   # sticky until reset
            it.next()
        it.close()


def test_device_prefetch_place_fn_and_current_source():
    for m in (jio, tio):
        placed_ids = []

        class Tagged:
            def __init__(self, batch):
                self.batch = batch
                placed_ids.append(id(batch))

        it = m.DevicePrefetchIter(_nd_iter(m), place_fn=Tagged)
        first = it.next()
        assert isinstance(first, Tagged)
        assert it.current_batch is first
        assert id(it.current_source) in placed_ids
        assert it.getpad() == it.current_source.pad
        assert (it.getdata()[0].asnumpy().tobytes()
                == it.current_source.data[0].asnumpy().tobytes())
        inner = _nd_iter(m)
        it2 = m.DevicePrefetchIter(inner)
        assert it2.provide_data == inner.provide_data
        assert it2.provide_label == inner.provide_label
        it.close()


def test_device_prefetch_rejects_bad_depth():
    with pytest.raises(JaxError):
        jio.DevicePrefetchIter(_nd_iter(jio), depth=0)
    with pytest.raises(MXNetError):
        tio.DevicePrefetchIter(_nd_iter(tio), depth=0)


def test_device_prefetch_on_cpu_is_a_plain_copy():
    """With a CPU device there are no streams: the staged batch is what
    place_fn returned, on the host."""
    it = tio.DevicePrefetchIter(_nd_iter(tio), device="cpu",
                                place_fn=lambda b: {"data": b.data[0].data})
    got = [b["data"] for b in it]
    assert it._stream is None
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in got)
    assert torch.equal(torch.cat(got).reshape(-1),
                       torch.arange(64, dtype=torch.float32))


def test_prefetch_retries_injected_crash_like_jax():
    x, y = _arrays(n=40, feat=8)
    got = {}
    for m, chaos in ((jio, jchaos), (tio, tchaos)):
        ci = chaos.ChaosIter(m.NDArrayIter(x, y, batch_size=8),
                             chaos.ChaosSpec.parse("crash:2"))
        pf = m.DevicePrefetchIter(ci, max_retries=2, retry_backoff=0.001)
        # the crash consumes a chaos index, not a batch: the epoch is whole
        got[m] = [b.data[0].asnumpy() for b in pf]
        assert pf.retry_count == 1
        assert ci.injected == {"nan": 0, "overflow": 0, "crash": 1}
        pf.close()
    assert len(got[tio]) == len(got[jio]) == 5
    for a, b in zip(got[tio], got[jio]):
        assert a.tobytes() == b.tobytes()


def test_prefetch_retry_counter_and_backoff():
    ttel.reset_for_tests()
    jprof.reset_counters("io.")
    x, y = _arrays(n=24, feat=2)
    waits = []

    class Recording(threading.Event):
        def wait(self, timeout=None):
            waits.append(timeout)
            return False

    ci = tchaos.ChaosIter(tio.NDArrayIter(x, y, batch_size=8),
                          tchaos.ChaosSpec.parse("crash:1,2"))
    pf = tio.DevicePrefetchIter(ci, max_retries=2, retry_backoff=0.01)
    real = threading.Event
    threading.Event = Recording
    try:
        assert sum(1 for _ in pf) == 3
    finally:
        threading.Event = real
    assert pf.retry_count == 2
    # exponential backoff (a thread's start waits on an Event too)
    assert [w for w in waits if w is not None] == [0.01, 0.02]
    assert ttel.registry().get_value("io.prefetch_retries") == 2
    pf.close()
    ttel.reset_for_tests()


def test_prefetch_retries_exhausted_raises():
    x, y = _arrays(n=40, feat=8)
    for m, chaos in ((jio, jchaos), (tio, tchaos)):
        ci = chaos.ChaosIter(m.NDArrayIter(x, y, batch_size=8),
                             chaos.ChaosSpec.parse("crash:0,1,2,3,4"))
        pf = m.DevicePrefetchIter(ci, max_retries=1, retry_backoff=0.001)
        with pytest.raises(chaos.ChaosError):
            for _ in pf:
                pass
        pf.close()


def test_prefetch_close_mid_epoch():
    x, y = _arrays(n=64, feat=8)
    pf = tio.DevicePrefetchIter(tio.NDArrayIter(x, y, batch_size=8),
                                depth=2)
    pf.next()
    t = pf._thread
    assert t is not None and t.is_alive()
    pf.close()
    assert not t.is_alive()
    assert pf.current_batch is None and pf.current_source is None


# ---------------------------------------------------------------------------
# ChaosIter (tests/test_resilience.py's cases, both packages)
# ---------------------------------------------------------------------------

def test_chaos_iter_injects_across_reset():
    x, y = _arrays(n=12, feat=8)
    for m, chaos in ((jio, jchaos), (tio, tchaos)):
        ci = chaos.ChaosIter(m.NDArrayIter(x, y, batch_size=4),
                             chaos.ChaosSpec.parse("nan:1|crash:4"))
        b0 = ci.next()
        b1 = ci.next()  # global index 1: poisoned
        assert np.isnan(b1.data[0].asnumpy()).all()
        assert not np.isnan(b0.data[0].asnumpy()).any()
        assert not np.isnan(b1.label[0].asnumpy()).any()
        ci.next()
        ci.reset()      # the global count is NOT reset
        ci.next()
        with pytest.raises(chaos.ChaosError):
            ci.next()   # global index 4
        assert ci.injected == {"nan": 1, "overflow": 0, "crash": 1}
        assert ci.batch_size == 4          # the rest is delegated


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_chaos_dict_batch_skips_int_labels(form):
    conv = (lambda a: a) if form == "numpy" else torch.from_numpy
    ci = tchaos.ChaosIter(iter([]), tchaos.ChaosSpec.parse("nan:0"))
    batch = {"data": conv(np.ones((2, 3), np.float32)),
             "softmax_label": conv(np.arange(2, dtype=np.int32))}
    out = ci._poison_batch(batch, tchaos.OVERFLOW_VALUE)
    data = np.asarray(out["data"])
    assert (data == np.float32(1e30)).all()
    assert out["softmax_label"] is batch["softmax_label"]
    jout = jchaos.ChaosIter(iter([]), jchaos.ChaosSpec.parse(
        "nan:0"))._poison_batch({k: np.asarray(v) for k, v in batch.items()},
                                jchaos.OVERFLOW_VALUE)
    assert data.tobytes() == np.asarray(jout["data"]).tobytes()


def test_chaos_maybe_wrap_env(monkeypatch):
    it = tio.NDArrayIter(*_arrays(n=8), batch_size=4)
    monkeypatch.delenv("MXNET_TPU_CHAOS", raising=False)
    assert tchaos.maybe_wrap(it) is it
    monkeypatch.setenv("MXNET_TPU_CHAOS", "nan:0")
    wrapped = tchaos.maybe_wrap(it)
    assert isinstance(wrapped, tchaos.ChaosIter)
    assert tchaos.maybe_wrap(wrapped) is wrapped
    assert np.isnan(wrapped.next().data[0].asnumpy()).all()
