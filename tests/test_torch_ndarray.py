"""NDArray of the PyTorch port (mxnet_tpu_torch/ndarray.py, context.py,
stream.py, random.py, ops/simple_ops.py) against the JAX package's.

The cases of ``tests/test_ndarray.py``, run through both packages on the
same numpy inputs, value for value: exact where the arithmetic is exact
(copies, views, writes, scalar +-*, reductions of small integers,
indexing), otherwise within rtol 1e-6 (elementwise float32 math: ATen's
and XLA's exp/log/pow may differ in the last bit) or 1e-5 (sums and
products, summation order).  ``save``/``load`` share one byte format:
each package loads the other's files, and both write the same bytes for
the same arrays.  The port runs under ``with mxt.cpu():``.
"""
import io

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import stream as tstream
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


def _same(t, j, rtol=0.0, atol=0.0):
    t, j = t.asnumpy(), j.asnumpy()
    assert t.shape == j.shape
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def test_creation():
    _same(tnd.zeros((3, 4)), jnd.zeros((3, 4)))
    _same(tnd.ones((2, 2), dtype="float64"), jnd.ones((2, 2), dtype="float64"))
    _same(tnd.full((2,), 7.0), jnd.full((2,), 7.0))
    _same(tnd.array([[1, 2], [3, 4]], dtype="float32"),
          jnd.array([[1, 2], [3, 4]], dtype="float32"))
    _same(tnd.arange(5), jnd.arange(5))
    _same(tnd.arange(2, 11, 3), jnd.arange(2, 11, 3))
    _same(tnd.empty((2, 3)), jnd.empty((2, 3)))
    # float64 numpy input becomes float32, as in the JAX package
    x = np.random.RandomState(0).rand(3)
    _same(tnd.array(x), jnd.array(x))
    assert tnd.array(x).dtype == np.float32
    a = tnd.array(np.arange(4, dtype=np.float32))
    assert (a.size, a.ndim, len(a), a.context) == (4, 1, 4, mxt.cpu())


@pytest.mark.parametrize("op,rtol", [("__add__", 0), ("__sub__", 0),
                                     ("__mul__", 0), ("__truediv__", 1e-6),
                                     ("__pow__", 1e-6)])
def test_elementwise_binary(op, rtol):
    rng = np.random.RandomState(0)
    x = rng.rand(4, 5).astype(np.float32)
    y = rng.rand(4, 5).astype(np.float32)
    _same(getattr(tnd.array(x), op)(tnd.array(y)),
          getattr(jnd.array(x), op)(jnd.array(y)), rtol=rtol)


def test_scalar_ops():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t, j = tnd.array(x), jnd.array(x)
    for f in (lambda a: a + 2, lambda a: 2 + a, lambda a: a - 2,
              lambda a: 2 - a, lambda a: a * 3, lambda a: 1.0 / (a + 1),
              lambda a: -a, lambda a: a / 4, lambda a: a ** 2,
              lambda a: 2 ** a):
        _same(f(t), f(j), rtol=1e-6)


def test_inplace_ops():
    x = np.ones((2, 3), dtype=np.float32)
    t, j = tnd.array(x), jnd.array(x)
    v0 = t.version
    for a in (t, j):
        a += 2
        a *= 2
        a /= 3
        a -= 1
    _same(t, j)
    assert t.version == v0 + 4
    b = tnd.array(x)
    t += b
    _same(t, j + jnd.array(x))


def test_setitem_getitem():
    t, j = tnd.zeros((4, 3)), jnd.zeros((4, 3))
    for a in (t, j):
        a[:] = 2
        a[1:3] = 5
        a[0, 2] = -1
    _same(t, j)
    _same(t[1], j[1])
    _same(t[1:3], j[1:3])
    assert t[1].shape == (3,)
    _same(tnd.array(np.arange(3.0))[2], jnd.array(np.arange(3.0))[2])
    with pytest.raises(MXNetError, match="step=1"):
        t[::2]


def test_view_write_through():
    t, j = tnd.zeros((4, 3)), jnd.zeros((4, 3))
    ts, js = t.slice(1, 3), j.slice(1, 3)
    v = t.version
    ts[:] = 7
    js[:] = 7
    _same(t, j)
    assert t.version == v + 1      # one version for the chunk and its views
    t[:] = 1
    j[:] = 1
    _same(ts, js)
    at = t.at(2)
    at[:] = 9
    assert t.asnumpy()[2].tolist() == [9, 9, 9]
    assert ts.version == t.version
    with pytest.raises(MXNetError, match="out of range"):
        t.slice(2, 9)


def test_reshape_view():
    x = np.arange(6, dtype=np.float32)
    t, j = tnd.array(x), jnd.array(x)
    tr, jr = t.reshape((2, 3)), j.reshape((2, 3))
    _same(tr, jr)
    tr[:] = 0
    jr[:] = 0
    _same(t, j)
    assert t.reshape((3, -1)).shape == j.reshape((3, -1)).shape == (3, 2)
    with pytest.raises(MXNetError, match="reshape"):
        t.reshape((4, 2))


@pytest.mark.parametrize("name", ["exp", "log", "sqrt", "square", "rsqrt",
                                  "cos", "sin", "abs", "ceil", "floor",
                                  "round", "negative", "sigmoid", "relu",
                                  "tanh", "norm", "sum", "max", "min"])
def test_unary_and_reductions(name):
    x = np.random.RandomState(1).rand(3, 4).astype(np.float32) * 3 + 0.5
    _same(getattr(tnd, name)(tnd.array(x)), getattr(jnd, name)(jnd.array(x)),
          rtol=1e-6)


def test_sign_and_clip():
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    _same(tnd.sign(tnd.array(x)), jnd.sign(jnd.array(x)))
    _same(tnd.clip(tnd.array(x), a_min=-0.5, a_max=0.5),
          jnd.clip(jnd.array(x), a_min=-0.5, a_max=0.5))


@pytest.mark.parametrize("name,kw", [
    ("sum_axis", {"axis": (1,)}), ("sum_axis", {"axis": (0,),
                                                "keepdims": True}),
    ("max_axis", {"axis": (0, 2)}), ("min_axis", {"axis": (-1,)}),
    ("argmax_channel", {}), ("flip", {"axis": 2}),
    ("expand_dims", {"axis": 1}), ("transpose", {}),
    ("transpose", {"axes": (1, 0, 2)}),
    ("slice_axis", {"axis": 1, "begin": 1, "end": 3}),
    ("slice_axis", {"axis": -1, "begin": -3, "end": 0}),
    ("smooth_l1", {"sigma": 2.0}),
])
def test_axis_and_matrix_ops(name, kw):
    x = np.random.RandomState(2).randn(2, 3, 4).astype(np.float32)
    _same(getattr(tnd, name)(tnd.array(x), **kw),
          getattr(jnd, name)(jnd.array(x), **kw), rtol=1e-6)


def test_dot_transpose():
    rng = np.random.RandomState(3)
    x = rng.rand(4, 5).astype(np.float32)
    y = rng.rand(5, 6).astype(np.float32)
    _same(tnd.dot(tnd.array(x), tnd.array(y)),
          jnd.dot(jnd.array(x), jnd.array(y)), rtol=1e-5)
    v = rng.rand(5).astype(np.float32)
    _same(tnd.dot(tnd.array(v), tnd.array(v)),
          jnd.dot(jnd.array(v), jnd.array(v)), rtol=1e-5)
    _same(tnd.transpose(tnd.array(x)), jnd.transpose(jnd.array(x)))


def test_broadcast_and_binary_extras():
    rng = np.random.RandomState(4)
    x = rng.rand(2, 1, 3).astype(np.float32)
    y = rng.rand(1, 4, 3).astype(np.float32)
    _same(tnd.broadcast_axis(tnd.array(x), axis=(1,), size=(4,)),
          jnd.broadcast_axis(jnd.array(x), axis=(1,), size=(4,)))
    for name in ("broadcast_plus", "broadcast_minus", "broadcast_mul",
                 "broadcast_div", "broadcast_power"):
        _same(getattr(tnd, name)(tnd.array(x), tnd.array(y)),
              getattr(jnd, name)(jnd.array(x), jnd.array(y)), rtol=1e-6)
    a, b = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(
        np.float32)
    for name in ("_maximum", "_minimum"):
        _same(getattr(tnd, name)(tnd.array(a), tnd.array(b)),
              getattr(jnd, name)(jnd.array(a), jnd.array(b)))
    for name in ("_maximum_scalar", "_minimum_scalar", "_rpower_scalar"):
        _same(getattr(tnd, name)(tnd.array(a), scalar=0.5),
              getattr(jnd, name)(jnd.array(a), scalar=0.5), rtol=1e-6)


@pytest.mark.parametrize("name, scalar", [
    ("_rpower_scalar", 2.5), ("_minimum_scalar", 1.5),
    ("_maximum_scalar", 1.5), ("_maximum_scalar", -0.5)])
def test_fractional_scalar_on_int32_array_matches_jax(name, scalar):
    """The scalar is not cast to the array's integer type: it promotes as
    jnp's weak Python scalar does.  Compared by value (under x64 the JAX
    package widens to float64, the port stays float32)."""
    a = np.array([-2, 1, 2], np.int32)
    t = getattr(tnd, name)(tnd.array(a, dtype="int32"), scalar=scalar)
    j = getattr(jnd, name)(jnd.array(a, dtype="int32"), scalar=scalar)
    assert t.dtype == np.float32
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)


def test_scalar_to_the_power_of_int32_array_matches_jax():
    a = np.array([-2, 1, 2], np.int32)
    t = 2.5 ** tnd.array(a, dtype="int32")
    j = 2.5 ** jnd.array(a, dtype="int32")
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)
    np.testing.assert_allclose(t.asnumpy(), [0.16, 2.5, 6.25], rtol=1e-6)


def test_choose_onehot_fill_and_loss():
    rng = np.random.RandomState(6)
    x = rng.rand(4, 5).astype(np.float32)
    idx = np.array([0, 2, 4, 1], np.float32)
    _same(tnd.choose_element_0index(tnd.array(x), tnd.array(idx)),
          jnd.choose_element_0index(jnd.array(x), jnd.array(idx)))
    _same(tnd.onehot_encode(tnd.array(idx), tnd.zeros((4, 5))),
          jnd.onehot_encode(jnd.array(idx), jnd.zeros((4, 5))))
    mhs = np.array([9, 8, 7, 6], np.float32)
    _same(tnd.fill_element_0index(tnd.array(x), tnd.array(mhs),
                                  tnd.array(idx)),
          jnd.fill_element_0index(jnd.array(x), jnd.array(mhs),
                                  jnd.array(idx)))
    _same(tnd.softmax_cross_entropy(tnd.array(x), tnd.array(idx)),
          jnd.softmax_cross_entropy(jnd.array(x), jnd.array(idx)),
          rtol=1e-6)


def test_random_reproducible():
    mxt.random.seed(42)
    a = mxt.random.uniform(0, 1, (10,))
    mxt.random.seed(42)
    b = mxt.random.uniform(0, 1, (10,))
    assert np.array_equal(a.asnumpy(), b.asnumpy())
    c = mxt.random.normal(2.0, 3.0, (500, 50))
    assert abs(c.asnumpy().mean() - 2.0) < 0.1
    assert abs(c.asnumpy().std() - 3.0) < 0.1
    out = tnd.zeros((10,))
    mxt.random.uniform(-1, 1, out=out)
    assert out.asnumpy().min() >= -1 and out.asnumpy().max() <= 1
    assert mxt.random.randn(3, 4).shape == (3, 4)


def test_save_load_roundtrip_both_packages(tmp_path):
    rng = np.random.RandomState(7)
    vals = {"weight": rng.randn(2, 3).astype(np.float32),
            "bias": np.ones(3, np.float32),
            "steps": np.arange(4, dtype=np.int64),
            "scalar": np.float64(2.5) * np.ones((), np.float64)}
    tf, jf = str(tmp_path / "t.nd"), str(tmp_path / "j.nd")
    tnd.save(tf, {k: tnd.array(v, dtype=v.dtype) for k, v in vals.items()})
    jnd.save(jf, {k: jnd.array(v, dtype=v.dtype) for k, v in vals.items()})
    with open(tf, "rb") as f1, open(jf, "rb") as f2:
        assert f1.read() == f2.read()
    for loaded in (tnd.load(jf), jnd.load(tf)):
        assert set(loaded) == set(vals)
        for k, v in vals.items():
            got = loaded[k].asnumpy()
            assert got.dtype == v.dtype and got.tobytes() == v.tobytes()
    # lists
    tnd.save(tf, [tnd.array(vals["weight"]), tnd.ones((3,))])
    jnd.save(jf, [jnd.array(vals["weight"]), jnd.ones((3,))])
    with open(tf, "rb") as f1, open(jf, "rb") as f2:
        assert f1.read() == f2.read()
    back = tnd.load(jf)
    assert isinstance(back, list) and len(back) == 2
    _same(back[0], jnd.load(tf)[0])


def test_load_rejects_truncated_and_foreign_files(tmp_path):
    f = str(tmp_path / "a.nd")
    tnd.save(f, {"w": tnd.ones((4, 4))})
    data = open(f, "rb").read()
    for cut in (12, 40, len(data) - 3):
        p = tmp_path / f"cut{cut}.nd"
        p.write_bytes(data[:cut])
        with pytest.raises(MXNetError, match="truncated"):
            tnd.load(str(p))
    bad = tmp_path / "bad.nd"
    bad.write_bytes(b"NOTANDARRAYFILE")
    with pytest.raises(MXNetError, match="bad magic"):
        tnd.load(str(bad))
    with pytest.raises(MXNetError, match="list or dict"):
        tnd.save(f, tnd.ones((2,)))


def test_save_is_atomic(tmp_path, monkeypatch):
    f = str(tmp_path / "a.nd")
    tnd.save(f, [tnd.ones((2,))])
    before = open(f, "rb").read()

    arr = tnd.ones((3,))
    monkeypatch.setattr(type(arr), "asnumpy",
                        lambda self: (_ for _ in ()).throw(OSError("disk")))
    with pytest.raises(OSError):
        tnd.save(f, [arr])
    assert open(f, "rb").read() == before
    assert [p.name for p in tmp_path.iterdir()] == ["a.nd"]


def test_copyto_context():
    a = tnd.array(np.arange(4, dtype=np.float32), ctx=mxt.cpu(0))
    b = tnd.zeros((4,), ctx=mxt.cpu(1))
    a.copyto(b)
    assert np.array_equal(b.asnumpy(), a.asnumpy())
    assert b.context == mxt.cpu(1) and b.context != mxt.cpu(0)
    c = a.as_in_context(mxt.cpu(2))
    assert c.context == mxt.cpu(2)
    assert a.as_in_context(mxt.cpu(0)) is a
    d = a.copyto(mxt.cpu(3))
    d[:] = 0
    assert a.asnumpy().sum() == 6
    _same(a.astype("float64"), jnd.array(np.arange(4.0)).astype("float64"))
    e = a.copy()
    e += 1
    assert a.asnumpy().tolist() == [0, 1, 2, 3]
    with pytest.raises(MXNetError, match="shape mismatch"):
        a.copyto(tnd.zeros((5,)))
    assert tnd.array([3.0]).asscalar() == 3.0
    _same(tnd.concatenate([a, a]),
          jnd.concatenate([jnd.array(np.arange(4, dtype=np.float32))] * 2))


def test_out_kwarg_and_wait_and_version():
    a = tnd.array(np.arange(4, dtype=np.float32))
    out = tnd.zeros((4,))
    assert tnd.exp(a, out=out) is out
    np.testing.assert_allclose(out.asnumpy(), np.exp(np.arange(4)),
                               rtol=1e-6)
    a.wait_to_read()
    tnd.waitall()
    v = a.version
    a[:] = 3
    assert a.version == v + 1
    a.mark_donated("a compiled step")
    assert a.asnumpy().tolist() == [3, 3, 3, 3]     # the port donates nothing


def test_read_only_arrays_reject_writes():
    a = tnd.NDArray(torch.zeros(3), writable=False)
    with pytest.raises(MXNetError, match="read-only"):
        a[:] = 1
    with pytest.raises(MXNetError, match="read-only"):
        a[0] = 1
    v = a.slice(0, 2)
    with pytest.raises(MXNetError, match="read-only"):
        v[:] = 1


def test_ndarray_wraps_a_tensor_in_place():
    t = torch.zeros(2, 3)
    a = tnd.NDArray(t)
    a[:] = np.ones((2, 3))
    assert t.sum().item() == 6
    assert a.context == mxt.cpu()


def test_context_scopes_and_defaults():
    assert mxt.current_context() == mxt.cpu()       # the fixture's scope
    with mxt.cpu(3):
        assert mxt.current_context() == mxt.cpu(3)
        with mxt.gpu(1):
            assert mxt.current_context() == mxt.gpu(1)
        assert mxt.current_context() == mxt.cpu(3)
    assert mxt.context.default_ctx() == mxt.gpu(0)
    assert {mxt.cpu(0), mxt.cpu(0), mxt.gpu(0)} == {mxt.cpu(), mxt.gpu()}
    assert mxt.Context(mxt.gpu(2)) == mxt.gpu(2)
    assert mxt.gpu(1).device_typeid == 2 and mxt.cpu().device_typeid == 1
    assert mxt.context.num_devices("cpu") == 1
    assert mxt.context.num_devices("gpu") == (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)


def test_outside_a_scope_arrays_go_to_the_card():
    outer = mxt.context.Context._default_ctx.value
    mxt.context.Context._default_ctx.value = None
    try:
        assert mxt.current_context() == mxt.gpu(0)
        if torch.cuda.is_available():
            assert tnd.zeros((2,)).data.is_cuda
        else:
            with pytest.raises(MXNetError, match="CUDA is not available"):
                tnd.zeros((2,))
    finally:
        mxt.context.Context._default_ctx.value = outer


def test_stream_schemes():
    arg = {"w": tnd.array(np.arange(6, dtype=np.float32).reshape(2, 3))}
    tnd.save("memory://ckpt/params", arg)
    back = tnd.load("memory://ckpt/params")
    assert np.array_equal(back["w"].asnumpy(), arg["w"].asnumpy())
    with pytest.raises(MXNetError, match="no stream handler"):
        tstream.open_uri("weird://x", "rb")
    with pytest.raises(MXNetError, match="does not exist"):
        tstream.open_uri("memory://missing", "rb")
    assert tstream.split_scheme("a/b") == ("file", "a/b")
    assert tstream.split_scheme("s3://b/k") == ("s3", "b/k")
    store = {}

    def opener(uri, mode):
        key = uri.split("://", 1)[1]
        if "w" in mode:
            class W(io.BytesIO):
                def close(self):
                    store[key] = self.getvalue()
                    io.BytesIO.close(self)
            return W()
        return io.BytesIO(store[key])

    tstream.register_scheme("teststore", opener)
    tnd.save("teststore://params", arg)
    assert store["params"][:8] == b"MXTPUND1"
    assert np.array_equal(tnd.load("teststore://params")["w"].asnumpy(),
                          arg["w"].asnumpy())


def test_imperative_invoke_with_aux_states():
    rng = np.random.RandomState(8)
    x = rng.randn(4, 3, 2, 2).astype(np.float32)
    gamma, beta = np.ones(3, np.float32), np.zeros(3, np.float32)
    mm, mv = rng.rand(3).astype(np.float32), rng.rand(3).astype(np.float32) + 1
    params = {"fix_gamma": False}
    t = tnd.imperative_invoke(
        "BatchNorm", [tnd.array(v) for v in (x, gamma, beta, mm, mv)], params)
    j = jnd.imperative_invoke(
        "BatchNorm", [jnd.array(v) for v in (x, gamma, beta, mm, mv)], params)
    _same(t, j, rtol=1e-5, atol=1e-6)
    with pytest.raises(MXNetError, match="aux states"):
        tnd.imperative_invoke("BatchNorm",
                              [tnd.array(v) for v in (x, gamma, beta)], {})
