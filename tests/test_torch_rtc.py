"""Runtime kernels of the PyTorch port (mxnet_tpu_torch/rtc.py,
``CudaKernel``, kernel K6) against the JAX package's ``PallasKernel``, on
the CPU.

Here the arrays are on the CPU, so ``CudaKernel`` runs each kernel's
plain ``reference`` (the CUDA build and launch are held against the same
references on the card: ``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Case (a) ``axpb`` of ``tests/test_rtc.py`` equals the JAX
interpret-mode kernel within 1e-6 of max(1, |value|) (XLA may contract
``x * y + 1`` into one fused multiply-add, the plain version rounds
twice), (b) ``dbl`` exactly, and the same calls leave the same number of
``_compiled`` entries.  The K6 softmax head of ``chip_smoke.py`` (an ``NDArrayOp``
pushing K6 kernels) trains the JAX test's net like the JAX
``NumpySoftmax`` net: parameters within rtol 1e-4 (atol 1e-6) after
every epoch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import operator as jopr, symbol as jsym

import chip_smoke
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import _build, rtc
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


def _axpb_body(x_ref, y_ref, o_ref):
    o_ref[:] = x_ref[:] * y_ref[:] + 1.0


def _dbl_body(x_ref, o_ref):
    o_ref[:] = x_ref[:] * 2.0


def test_push_matches_pallas_kernel():
    rng = np.random.RandomState(0)
    x = rng.randn(8, 128).astype(np.float32)
    y = rng.randn(8, 128).astype(np.float32)
    jk = mx.rtc.PallasKernel("axpb", _axpb_body)
    jout = mx.nd.zeros((8, 128))
    jk.push([mx.nd.array(x), mx.nd.array(y)], [jout])
    tk = rtc.CudaKernel("axpb", chip_smoke.RTC_AXPB,
                        reference=lambda a, b: (a * b + 1.0,))
    tout = mxt.nd.zeros((8, 128))
    v = tout.version
    tk.push([mxt.nd.array(x), mxt.nd.array(y)], [tout])
    j = jout.asnumpy()
    assert (np.abs(tout.asnumpy() - j) / np.maximum(1, np.abs(j))).max() \
        <= 1e-6
    assert tout.version == v + 1 and tk.launches == 0   # no kernel ran
    # the JAX test's constants, and an input that is a slice view
    big = mxt.nd.array(np.full((16, 128), 2.0, np.float32))
    out = mxt.nd.zeros((8, 128))
    tk.push([big.slice(8, 16), mxt.nd.full((8, 128), 3.0)], [out])
    np.testing.assert_array_equal(out.asnumpy(), 7.0)


def test_functional_form_and_cache_match_pallas_kernel():
    jk = mx.rtc.PallasKernel("dbl", _dbl_body)
    tk = rtc.CudaKernel("dbl", chip_smoke.RTC_DBL,
                        reference=lambda a: (a * 2.0,))
    xs = [np.arange(256, dtype=np.float32).reshape(2, 128),
          np.arange(256, dtype=np.float32).reshape(2, 128) - 7,
          np.ones((4, 128), np.float32)]
    for x in xs:
        (jy,) = jk(jnp.asarray(x))
        (ty,) = tk(torch.from_numpy(x))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        assert len(tk._compiled) == len(jk._compiled)
    assert len(tk._compiled) == 2
    # push with other output shapes adds entries in both
    jk.push([mx.nd.array(xs[0])], [mx.nd.zeros((2, 128))])
    tk.push([mxt.nd.array(xs[0])], [mxt.nd.zeros((2, 128))])
    assert len(tk._compiled) == len(jk._compiled)
    ent = next(iter(tk._compiled.values()))
    assert ent["lib"] is None and ent["block"] == (256, 1, 1)
    assert ent["grid"] == (1, 1, 1)          # ceil(256 / 256)
    assert tk.build_info is None             # nothing was built on the CPU


def test_errors():
    tk = rtc.CudaKernel("axpb", chip_smoke.RTC_AXPB,
                        reference=lambda a, b: (a * b + 1.0,))
    a = mxt.nd.ones((4,))
    with pytest.raises(MXNetError, match="at least one input and output"):
        tk.push([], [a])
    with pytest.raises(MXNetError, match="at least one input and output"):
        tk.push([a, a], [])
    with pytest.raises(MXNetError, match="at least one input and output"):
        tk()
    # two pointers + n declared; a call with one input needs three params
    with pytest.raises(MXNetError, match="pointer parameters"):
        rtc.CudaKernel("dbl", chip_smoke.RTC_DBL,
                       reference=lambda x: (x,)).push([a, a], [a])
    bad_last = 'extern "C" __global__ void k(const float* x, float* o, int n) {}'
    with pytest.raises(MXNetError, match="long long"):
        rtc.CudaKernel("k", bad_last, reference=lambda x: (x,))(a)
    no_ptr = 'extern "C" __global__ void k(float x, float* o, long long n) {}'
    with pytest.raises(MXNetError, match="pointer parameters"):
        rtc.CudaKernel("k", no_ptr, reference=lambda x: (x,))(a)
    nopush = rtc.CudaKernel("axpb", chip_smoke.RTC_AXPB)
    with pytest.raises(MXNetError, match="reference"):
        nopush.push([a, a], [mxt.nd.zeros((4,))])
    with pytest.raises(MXNetError, match='extern "C" __global__ void other'):
        rtc.CudaKernel("other", chip_smoke.RTC_AXPB)
    with pytest.raises(MXNetError, match="C identifier"):
        rtc.CudaKernel("bad name", chip_smoke.RTC_AXPB)
    with pytest.raises(MXNetError, match="both grid and block"):
        rtc.CudaKernel("axpb", chip_smoke.RTC_AXPB, grid=(1,))
    with pytest.raises(MXNetError, match="1-3 positive"):
        rtc.CudaKernel("axpb", chip_smoke.RTC_AXPB, grid=(0,), block=(1,))
    with pytest.raises(MXNetError, match="reference gave shapes"):
        rtc.CudaKernel("axpb", chip_smoke.RTC_AXPB,
                       reference=lambda x, y: (x[:2],))(a, a)
    with pytest.raises(MXNetError, match="NDArrays or tensors"):
        tk(np.ones(4, np.float32), a)


def test_launcher_source_and_build_paths():
    text = rtc.launcher_source("axpb")
    assert 'extern "C" int mxt_rtc_launch(void** args' in text
    assert "cudaLaunchKernel(\n      (const void*)axpb," in text
    assert "return (int)cudaGetLastError();" in text
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in text
    assert 'extern "C" const char* mxt_rtc_error_string' in text
    k = rtc.CudaKernel("axpb", chip_smoke.RTC_AXPB)
    assert k.full_source == chip_smoke.RTC_AXPB + text
    assert k.params == ["const float* x", "const float* y", "float* o",
                        "long long n"]
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert rtc.gpu_available() == torch.cuda.is_available()
    lb = rtc.CudaKernel("lb", 'extern "C" __global__ __launch_bounds__(128) '
                        'void lb(const float* x, float* o, long long n) {}')
    assert len(lb.params) == 3


def test_references_of_the_smoke_kernels():
    k = chip_smoke.rtc_kernels(torch, rtc)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(5, 7).astype(np.float32))
    (p,) = k["softmax_fwd"](x, grid=(5,), block=(128,))
    np.testing.assert_allclose(p.numpy(), torch.softmax(x, -1).numpy(),
                               rtol=1e-6, atol=1e-7)
    lab = torch.tensor([0., 6., 3., 2., 1.])
    (dx,) = k["softmax_bwd"](p, lab, grid=(5,), block=(128,))
    want = p.numpy().copy()
    want[np.arange(5), lab.long().numpy()] -= 1.0
    np.testing.assert_array_equal(dx.numpy(), want)
    xe = torch.from_numpy(rng.uniform(-1, 1, 10).astype(np.float32))
    np.testing.assert_array_equal(k["ref_exp"](xe)[0].numpy(),
                                  torch.exp(xe * 5.0).numpy())
    xb = torch.from_numpy(rng.uniform(-1, 1, 9).astype(np.float32)).to(
        torch.bfloat16)
    (ob,) = k["axpb_bf16"](xb, xb)
    assert ob.dtype == torch.bfloat16
    np.testing.assert_allclose(ob.float().numpy(),
                               (xb.float() * xb.float() + 1).numpy(),
                               atol=1e-2)


def _jax_numpy_softmax():
    class NumpySoftmax(jopr.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]]

        def forward(self, in_data, out_data):
            x = in_data[0]
            e = np.exp(x - x.max(axis=1, keepdims=True))
            out_data[0][:] = e / e.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            label = in_data[1].astype(int)
            in_grad[0][:] = out_data[0]
            in_grad[0][np.arange(label.shape[0]), label] -= 1.0

    return NumpySoftmax()


def _train(mx_, S, ctx, head):
    rng = np.random.RandomState(0)
    centers = rng.randn(3, 8).astype(np.float32) * 2
    yi = rng.randint(0, 3, 300)
    X = (centers[yi] + 0.5 * rng.randn(300, 8)).astype(np.float32)
    fc = S.FullyConnected(data=S.Variable("data"), num_hidden=3, name="fc")
    net = head.get_symbol(fc, S.Variable("label"), name="softmax")
    ex = net.simple_bind(ctx=ctx, data=(50, 8), label=(50,))
    ex.arg_dict["fc_weight"][:] = np.random.RandomState(1).uniform(
        -0.1, 0.1, (3, 8))
    ex.arg_dict["fc_bias"][:] = 0
    updater = mx_.optimizer.get_updater(
        mx_.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                          rescale_grad=1.0 / 50))
    history = []
    for _ in range(6):
        for i in range(0, 300, 50):
            ex.forward(is_train=True, data=X[i:i + 50],
                       label=yi[i:i + 50].astype(np.float32))
            ex.backward()
            for k, n in enumerate(("fc_weight", "fc_bias")):
                updater(k, ex.grad_dict[n], ex.arg_dict[n])
        history.append({n: ex.arg_dict[n].asnumpy()
                        for n in ("fc_weight", "fc_bias")})
    ex.forward(is_train=False, data=X[:50])
    acc = float((ex.outputs[0].asnumpy().argmax(1) == yi[:50]).mean())
    return history, acc


def test_k6_softmax_head_trains_like_jax_numpy_softmax():
    k = chip_smoke.rtc_kernels(torch, rtc)
    fwd, bwd = k["softmax_fwd"], k["softmax_bwd"]
    calls = {"fwd": 0, "bwd": 0}
    for key, kern in (("fwd", fwd), ("bwd", bwd)):
        def counted(*a, _key=key, _ref=kern.reference):
            calls[_key] += 1
            return _ref(*a)
        kern.reference = counted
    th, tacc = _train(mxt, tsym, mxt.cpu(),
                      chip_smoke.rtc_softmax_op(mxt.operator, fwd, bwd))
    jh, jacc = _train(mx, jsym, mx.cpu(), _jax_numpy_softmax())
    for epoch, (t, j) in enumerate(zip(th, jh)):
        for n in t:
            np.testing.assert_allclose(t[n], j[n], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{n} after epoch {epoch}")
    assert tacc > 0.9 and jacc > 0.9
    # one forward and one backward per step, one forward for the accuracy
    assert calls == {"fwd": 37, "bwd": 36}


def test_mlp_of_the_smoke_test_is_the_mnist_mlp():
    k = chip_smoke.rtc_kernels(torch, rtc)
    op = chip_smoke.rtc_softmax_op(mxt.operator, k["softmax_fwd"],
                                   k["softmax_bwd"])
    net = chip_smoke.rtc_mlp(mxt, op)
    with mx.name.NameManager():
        ref = mx.models.mlp(chip_smoke.MLP_CLASSES)
    assert net.list_arguments() == ref.list_arguments()
    _, outs, _ = net.infer_shape(data=(chip_smoke.MLP_BATCH,
                                       chip_smoke.MLP_IN))
    assert outs == [(chip_smoke.MLP_BATCH, chip_smoke.MLP_CLASSES)]
