"""The port's C predict API (``mxnet_tpu_torch/csrc/c_predict_api.{h,cc}``,
built by ``mxnet_tpu_torch._build.build_c_predict``) on the CPU.

The same FC net, with the same numpy weights, is exported by both
packages.  The port's artifact is served from C, by the port's driver
(``csrc/predict_driver.c``) and by the JAX package's driver
(``native/test_c_predict.c``, compiled unchanged against the port's header
and library: the ABI is the same), with ``MXNET_TPU_PREDICT_DEVICE=cpu``.
Both are held to the port's ``load_exported(..., device="cpu")`` and to the
JAX package's ``load_exported`` on its own artifact, within rtol 1e-5 and
atol 1e-6 (the JAX C test's bounds).  Served on the default device, the
card, the library fails with its reason where there is none.
"""
import importlib.util
import os
import subprocess

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import predictor as jpredictor

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import _build
from mxnet_tpu_torch import predictor as tpredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _keep_port_random_state():
    """Restore the port's global key sequence and device generators after
    the test, so the test files that run after this one in the same
    process draw what they would draw without it."""
    from mxnet_tpu_torch import random as port_random
    saved = dict(port_random._state)
    gens = {d: g.get_state() for d, g in port_random._generators.items()}
    yield
    port_random._state.update(saved)
    for d in list(port_random._generators):
        if d in gens:
            port_random._generators[d].set_state(gens[d])
        else:
            del port_random._generators[d]


def _fc_net(S):
    return S.SoftmaxOutput(
        data=S.FullyConnected(
            data=S.Activation(
                data=S.FullyConnected(data=S.Variable("data"),
                                      num_hidden=16, name="fc1"),
                act_type="relu"),
            num_hidden=5, name="fc2"),
        name="softmax")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' artifacts of one FC net, an input, the Python
    predictors' outputs, and the built library."""
    tmp = tmp_path_factory.mktemp("c_predict")
    rng = np.random.RandomState(0)
    args = {"fc1_weight": rng.randn(16, 7).astype(np.float32),
            "fc1_bias": (0.1 * rng.randn(16)).astype(np.float32),
            "fc2_weight": rng.randn(5, 16).astype(np.float32),
            "fc2_bias": (0.1 * rng.randn(5)).astype(np.float32)}
    x = rng.rand(4, 7).astype(np.float32)
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet, tnet = _fc_net(mx.symbol), _fc_net(mxt.symbol)
    art = str(tmp / "model.mxtpt")
    tpredictor.export_model(tnet, {k: torch.from_numpy(v)
                                   for k, v in args.items()}, {},
                            {"data": (4, 7)}, art)
    jart = str(tmp / "model.mxtpu")
    jpredictor.export_model(jnet, {k: mx.nd.array(v)
                                   for k, v in args.items()}, {},
                            {"data": (4, 7)}, jart)
    xin = str(tmp / "in.bin")
    x.tofile(xin)
    return {"tmp": tmp, "art": art, "jart": jart, "xin": xin,
            "port": tpredictor.load_exported(art, device="cpu")
            .predict(data=x)[0],
            "jax": jpredictor.load_exported(jart).predict(data=x)[0],
            "build": _build.build_c_predict()}


def _env(device):
    base = {k: v for k, v in os.environ.items()
            if k != "MXNET_TPU_PREDICT_DEVICE"}
    return _build.c_predict_env(device, base=base)


def _serve(exe, served, name, *extra, device="cpu"):
    out = str(served["tmp"] / f"{name}.bin")
    proc = subprocess.run([str(exe), served["art"], served["xin"], out,
                           *extra], capture_output=True, text=True,
                          env=_env(device), timeout=300)
    return proc, out


def _check(got_path, served):
    got = np.fromfile(got_path, np.float32).reshape(4, 5)
    np.testing.assert_allclose(got, served["port"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(served["jax"]), rtol=RTOL,
                               atol=ATOL)
    # softmax rows sum to one: the program really executed
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


def test_port_driver_serves_the_artifact_from_c(served):
    info = served["build"]
    assert info["lib"].is_file() and info["driver"].is_file()
    assert info["dir"].parent.parent == _build.build_dir()
    assert _build.build_c_predict() == dict(info, seconds=0.0, cached=True)
    proc, out = _serve(info["driver"], served, "port", "3")
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    lines = proc.stdout.splitlines()
    assert lines[0] == "input data ndim=2 elems=28"
    assert len(lines[1].split()) == 4 and lines[1].startswith("forward_ms")
    assert float(lines[2].split()[1]) > 0
    assert lines[-1] == "served 1 outputs ok"
    _check(out, served)


def test_jax_driver_links_against_the_port_library(served):
    """``native/test_c_predict.c``, unchanged, against the port's header
    and library."""
    info = served["build"]
    exe = served["tmp"] / "test_c_predict"
    proc = subprocess.run(
        ["gcc", "-O2", "-o", str(exe),
         os.path.join(REPO, "native", "test_c_predict.c"),
         f"-I{info['include']}", f"-L{info['dir']}", "-lc_predict_api",
         f"-Wl,-rpath,{info['dir']}"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    proc, out = _serve(exe, served, "jax_driver")
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "served 1 outputs ok" in proc.stdout
    _check(out, served)


def test_default_device_without_a_card_fails_with_its_reason(served):
    assert not torch.cuda.is_available()
    proc, out = _serve(served["build"]["driver"], served, "default",
                       device=None)
    assert proc.returncode == 1, (proc.stdout, proc.stderr)
    assert proc.stderr.startswith("create: MXTPUPredCreate: "), proc.stderr
    assert "MXNET_TPU_PREDICT_DEVICE='cuda'" in proc.stderr
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not os.path.exists(out)


def test_embedded_serving_code_in_process(served, monkeypatch):
    """The embedded module itself: it refuses a JAX artifact and a
    missing card, and serves the port's artifact like the predictor."""
    spec = importlib.util.spec_from_file_location(
        "c_predict_serve", _build.CSRC_DIR / "c_predict_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setenv("MXNET_TPU_PREDICT_DEVICE", "cpu")
    with pytest.raises(ValueError, match="a JAX artifact"):
        mod._Served(served["jart"])
    s = mod._Served(served["art"])
    with pytest.raises(ValueError, match="got 27 elements"):
        s.set_input("data", np.zeros(27, np.float32).tobytes())
    with pytest.raises(ValueError, match="inputs not set"):
        s.forward()
    s.set_input("data", np.fromfile(served["xin"], np.float32).tobytes())
    s.forward()
    assert s.output_shape(0) == [4, 5]
    got = np.frombuffer(s.output_bytes(0), np.float32).reshape(4, 5)
    assert got.tobytes() == served["port"].tobytes()
    monkeypatch.setenv("MXNET_TPU_PREDICT_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        mod._Served(served["art"])
