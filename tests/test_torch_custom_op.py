"""Custom operators of the PyTorch port (mxnet_tpu_torch/operator.py)
against the JAX package's, on the CPU.

The ops of ``tests/test_custom_op.py`` (``NumpySoftmax``, a NumpyOp loss
head; ``NDArrayScale``, an NDArrayOp; the registered ``test_sigmoid``
CustomOp) are defined once per package with the same bodies, bound with
``simple_bind`` and run forward and backward on the same numpy inputs:
outputs and gradients agree within rtol 1e-5 (the bodies run the same
numpy code; only the surrounding f32 ops differ).  ``test_numpy_op_trains``
runs in both packages from the same parameters and batches: the
parameters after every epoch agree within rtol 1e-4 (atol 1e-6), and
both nets learn (accuracy > 0.9).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import operator as jopr, symbol as jsym

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import operator as topr, symbol as tsym
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


def _numpy_softmax(opr):
    class NumpySoftmax(opr.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]]

        def forward(self, in_data, out_data):
            x = in_data[0]
            e = np.exp(x - x.max(axis=1, keepdims=True))
            out_data[0][:] = e / e.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            assert out_grad == []                  # need_top_grad=False
            label = in_data[1].astype(int)
            dx = in_grad[0]
            dx[:] = out_data[0]
            dx[np.arange(label.shape[0]), label] -= 1.0

    return NumpySoftmax()


def _ndarray_scale(opr, seen):
    class NDArrayScale(opr.NDArrayOp):
        def forward(self, in_data, out_data):
            seen.append((type(in_data[0]).__name__, in_data[0].context))
            out_data[0][:] = in_data[0] * 3.0

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0] * 3.0

    return NDArrayScale()


def _register_sigmoid(opr):
    @opr.register("test_sigmoid")
    class SigmoidProp(opr.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Sigmoid(opr.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    y = 1.0 / (1.0 + np.exp(-in_data[0]))
                    self.assign(out_data[0], req[0], y)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    y = out_data[0]
                    self.assign(in_grad[0], req[0],
                                out_grad[0] * y * (1 - y))
            return Sigmoid()
    return SigmoidProp


_register_sigmoid(jopr)
_register_sigmoid(topr)

X4 = np.array([[1, 2, 3], [3, 2, 1], [0, 0, 0], [1, 1, 5]], np.float32)
LAB4 = np.array([2, 0, 1, 2], np.float32)


def test_numpy_op_forward_backward_matches_jax():
    exs = []
    for opr, S, ctx in ((jopr, jsym, mx.cpu()), (topr, tsym, mxt.cpu())):
        net = _numpy_softmax(opr).get_symbol(S.Variable("data"),
                                             S.Variable("label"),
                                             name="softmax")
        assert net.list_arguments() == ["data", "label"]
        ex = net.simple_bind(ctx=ctx, data=(4, 3), label=(4,))
        ex.arg_dict["data"][:] = X4
        ex.arg_dict["label"][:] = LAB4
        ex.forward(is_train=True)
        ex.backward()
        exs.append(ex)
    jex, tex = exs
    e = np.exp(X4 - X4.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    expect = p.copy()
    expect[np.arange(4), LAB4.astype(int)] -= 1.0
    for ex in exs:
        np.testing.assert_allclose(ex.outputs[0].asnumpy(), p, rtol=1e-5)
        np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(), expect,
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tex.grad_dict["data"].asnumpy(),
                               jex.grad_dict["data"].asnumpy(), rtol=1e-5)
    np.testing.assert_array_equal(tex.grad_dict["label"].asnumpy(), 0)


def test_ndarray_op_sees_device_ndarrays_and_matches_jax():
    seen = []
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    outs = []
    for opr, S, nd, ctx, log in ((jopr, jsym, mx.nd, mx.cpu(), []),
                                 (topr, tsym, mxt.nd, mxt.cpu(), seen)):
        net = _ndarray_scale(opr, log).get_symbol(S.Variable("data"),
                                                  name="scale")
        ex = net.simple_bind(ctx=ctx, data=(2, 3))
        ex.arg_dict["data"][:] = x
        ex.forward(is_train=True)
        ex.backward([nd.array(np.ones((2, 3), np.float32))])
        outs.append((ex.outputs[0].asnumpy(),
                     ex.grad_dict["data"].asnumpy()))
    np.testing.assert_allclose(outs[1][0], 3 * x)
    np.testing.assert_allclose(outs[1][1], 3 * np.ones((2, 3)))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    assert seen == [("NDArray", mxt.cpu())]


def test_ndarray_op_inputs_are_read_only():
    class Bad(topr.NDArrayOp):
        def forward(self, in_data, out_data):
            in_data[0][:] = 0

    ex = Bad().get_symbol(tsym.Variable("data")).simple_bind(
        mxt.cpu(), data=(2,))
    with pytest.raises(MXNetError, match="read-only"):
        ex.forward()


def test_custom_op_registered_matches_jax():
    assert "test_sigmoid" in topr.get_all_registered_operators()
    x = np.linspace(-2, 2, 12).astype(np.float32).reshape(3, 4)
    g = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    res = []
    for S, nd, ctx in ((jsym, mx.nd, mx.cpu()), (tsym, mxt.nd, mxt.cpu())):
        net = S.Custom(data=S.Variable("data"), op_type="test_sigmoid",
                       name="sig")
        ex = net.simple_bind(ctx=ctx, data=(3, 4))
        ex.arg_dict["data"][:] = x
        ex.forward(is_train=True)
        ex.backward([nd.array(g)])
        res.append((ex.outputs[0].asnumpy(), ex.grad_dict["data"].asnumpy()))
    y = 1 / (1 + np.exp(-x))
    np.testing.assert_allclose(res[1][0], y, rtol=1e-5)
    np.testing.assert_allclose(res[1][1], g * y * (1 - y), rtol=1e-5)
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-6)
    # imperative form: values only
    out = mxt.nd.Custom(mxt.nd.array(x), op_type="test_sigmoid")
    np.testing.assert_allclose(out.asnumpy(), y, rtol=1e-5)
    with pytest.raises(MXNetError, match="not registered"):
        mxt.nd.Custom(mxt.nd.array(x), op_type="no_such_op")
    with pytest.raises(MXNetError, match="CustomOpProp"):
        topr.register("bad")(object)


def test_inference_forward_records_no_custom_node():
    net = _numpy_softmax(topr).get_symbol(tsym.Variable("data"),
                                          tsym.Variable("label"))
    ex = net.simple_bind(mxt.cpu(), data=(4, 3), label=(4,))
    ex.arg_dict["data"][:] = X4
    ex.arg_dict["label"][:] = LAB4
    heads = ex._run(False, {})[0]
    assert heads[0].grad_fn is None and ex._graph is None
    heads = ex._run(True, {})[0]
    assert type(heads[0].grad_fn).__name__ == "_BodyFnBackward"


def _train(pkg):
    """The reference gate of tests/test_custom_op.py in one package:
    FullyConnected(3) + the NumpySoftmax head, SGD lr 0.1, rescale 1/50,
    batches of 50; returns the parameters after each epoch and the
    accuracy."""
    mx_, opr, S, ctx = pkg
    rng = np.random.RandomState(0)
    centers = rng.randn(3, 8).astype(np.float32) * 2
    yi = rng.randint(0, 3, 300)
    X = (centers[yi] + 0.5 * rng.randn(300, 8)).astype(np.float32)
    fc = S.FullyConnected(data=S.Variable("data"), num_hidden=3, name="fc")
    net = _numpy_softmax(opr).get_symbol(fc, S.Variable("label"),
                                         name="softmax")
    ex = net.simple_bind(ctx=ctx, data=(50, 8), label=(50,))
    rng2 = np.random.RandomState(1)
    ex.arg_dict["fc_weight"][:] = rng2.uniform(-0.1, 0.1, (3, 8))
    ex.arg_dict["fc_bias"][:] = 0
    updater = mx_.optimizer.get_updater(
        mx_.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0 / 50))
    history = []
    for epoch in range(15):
        for i in range(0, 300, 50):
            ex.arg_dict["data"][:] = X[i:i + 50]
            ex.arg_dict["label"][:] = yi[i:i + 50].astype(np.float32)
            ex.forward(is_train=True)
            ex.backward()
            for k, n in enumerate(("fc_weight", "fc_bias")):
                updater(k, ex.grad_dict[n], ex.arg_dict[n])
        history.append({n: ex.arg_dict[n].asnumpy()
                        for n in ("fc_weight", "fc_bias")})
    preds = []
    for i in range(0, 300, 50):
        ex.arg_dict["data"][:] = X[i:i + 50]
        ex.forward(is_train=False)
        preds.append(ex.outputs[0].asnumpy().argmax(1))
    return history, float((np.concatenate(preds) == yi).mean())


def test_numpy_op_trains_like_jax():
    jh, jacc = _train((mx, jopr, jsym, mx.cpu()))
    th, tacc = _train((mxt, topr, tsym, mxt.cpu()))
    for epoch, (t, j) in enumerate(zip(th, jh)):
        for n in t:
            np.testing.assert_allclose(t[n], j[n], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{n} after epoch {epoch}")
    assert tacc > 0.9 and jacc > 0.9, (tacc, jacc)


def test_custom_op_body_dtypes_follow_the_input():
    seen = []

    class Probe(topr.NumpyOp):
        def forward(self, in_data, out_data):
            seen.append((in_data[0].dtype, out_data[0].dtype))
            out_data[0][:] = in_data[0] + 1

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0]

    ex = Probe().get_symbol(tsym.Variable("data")).simple_bind(
        mxt.cpu(), data=(3,), type_dict={"data": np.float64})
    ex.arg_dict["data"][:] = np.arange(3.0)
    out = ex.forward(is_train=True)[0]
    ex.backward([mxt.nd.ones((3,), dtype="float64")])
    assert seen == [(np.float64, np.float64)]
    assert out.dtype == np.float64
    np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(), 1.0)
    assert out.data.dtype == torch.float64
