"""Loss scaling, gradient accumulation and matmul precision of the
PyTorch port's trainer against the JAX package, on the CPU.

* The dynamic schedule (``resilience.state_update``): growth after
  ``growth_interval`` good steps, backoff on an overflow, both clamps,
  and the counters, over a step sequence with planted overflows: every
  state BITWISE the JAX package's.
* ``ShardedTrainer(loss_scale=...)``, fixed and dynamic, on the small
  LM (vocab 61, 2 layers, d 32) with an overflow batch (ids of 1e30:
  out of range, so the embedding's rows are NaN in both packages, as
  ``jnp.take`` fills them): parameters within the trainer tolerance
  (rtol 1e-4, atol 1e-6: summation order), the loss scale, good streak
  and skip/overflow counters equal, the summed norm within rtol 1e-4.
* fp8 linears turn dynamic scaling on (both packages).
* ``grad_accum`` 2 and 4 against the JAX trainer with clip 0.5 (the
  trainer tolerances), and against ``grad_accum=1`` at the same batch
  within the JAX package's own bound (``tests/test_parallel.py``: heads
  rtol 2e-5 atol 2e-6, parameters rtol 5e-5 atol 5e-6), the inference
  forward mapped over the microbatches; an indivisible batch raises.
* ``matmul_precision``: the JAX names set torch's float32 matmul
  precision and cuDNN's TF32 switch inside each step, restored after.
* The Embedding's lookup of out-of-range and non-finite ids equals
  ``jnp.take``'s (the overflow path above relies on it), with the
  gradient.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu import random as jrandom
from mxnet_tpu import resilience as jres
from mxnet_tpu import symbol as jsym
from mxnet_tpu.ops.registry import OpContext as JCtx, get_op as jget_op
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import OpContext as TCtx, get_op as tget_op
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.parallel.trainer import matmul_precision_scope

V, NL, D, H, S = 61, 2, 32, 2, 64
SGD = ("sgd", {"learning_rate": 0.05, "momentum": 0.9})


@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


def test_dynamic_schedule_bitwise_equals_jax():
    knobs = dict(loss_scale="dynamic", init_scale=4.0, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2, min_scale=1.0,
                 max_scale=16.0)
    jcfg, tcfg = jres.GuardConfig(**knobs), tres.GuardConfig(**knobs)
    assert jcfg.describe() == tcfg.describe()
    js = {k: jnp.asarray(v) for k, v in jres.init_state(jcfg).items()}
    ts = tres.init_state(tcfg, "cpu")
    oks = [1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1]
    norms = np.random.RandomState(0).rand(len(oks)).astype(np.float32)
    seen = set()
    for ok, nrm in zip(oks, norms):
        js = jres.state_update(js, jnp.asarray(bool(ok)), jnp.asarray(nrm),
                               jcfg)
        ts = tres.state_update(ts, torch.tensor(bool(ok)),
                               torch.tensor(nrm), tcfg)
        assert tuple(ts) == tuple(jres.STATE_KEYS)
        for k in jres.STATE_KEYS:
            a, b = np.asarray(js[k]), ts[k].numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
        seen.add(float(ts["scale"]))
    assert {1.0, 16.0} <= seen          # both clamps were hit
    assert int(ts["overflows"]) == oks.count(0)


def test_guard_config_env_knobs_match_jax(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_LOSS_SCALE", "dynamic")
    monkeypatch.setenv("MXNET_TPU_LOSS_SCALE_INIT", "256")
    monkeypatch.setenv("MXNET_TPU_LOSS_SCALE_GROWTH", "4")
    monkeypatch.setenv("MXNET_TPU_LOSS_SCALE_BACKOFF", "0.25")
    monkeypatch.setenv("MXNET_TPU_LOSS_SCALE_INTERVAL", "7")
    j, t = jres.resolve(), tres.resolve()
    assert t.describe() == j.describe() and t.init_scale == 256.0
    monkeypatch.setenv("MXNET_TPU_LOSS_SCALE", "128")
    assert tres.resolve().loss_scale == jres.resolve().loss_scale == 128.0
    monkeypatch.setenv("MXNET_TPU_LOSS_SCALE", "off")
    assert tres.resolve() is None and jres.resolve() is None
    with pytest.raises(ValueError, match="guard=False"):
        tres.resolve(guard=False, loss_scale="dynamic")
    with pytest.raises(ValueError, match="loss_scale"):
        tres.GuardConfig(loss_scale=-1.0)
    assert tres.WINDOW_KEYS == jres.WINDOW_KEYS


def _lm(batch, quant=None):
    kw = dict(vocab_size=V, num_layers=NL, d_model=D, heads=H,
              batch_size=batch, seq_len=S, loss_head=True, quant=quant)
    with mx.name.NameManager(), mxt.name.NameManager():
        return (jmodels.get_symbol("transformer-lm", **kw),
                tmodels.get_symbol("transformer-lm", **kw))


def _lm_args(sym, batch, seed=0):
    shapes, _, _ = sym.infer_shape(data=(batch, S), softmax_label=(batch, S))
    rng = np.random.RandomState(seed)
    return {n: ((1.0 + 0.1 * rng.randn(*s)) if n.endswith("_gamma")
                else 0.1 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _pair(js, ts, batch, accum=1, opt=SGD, **kw):
    args = _lm_args(ts, batch // accum)
    shapes = ({"data": (batch, S)}, {"softmax_label": (batch, S)})
    jt = JaxTrainer(js, optimizer=opt[0], optimizer_params=dict(opt[1]),
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]),
                    grad_accum=accum, **kw)
    jt.bind(*shapes, arg_params={k: jnp.asarray(v) for k, v in args.items()})
    tt = ShardedTrainer(ts, optimizer=opt[0], optimizer_params=dict(opt[1]),
                        grad_accum=accum, device="cpu", **kw)
    tt.bind(*shapes, arg_params=args)
    return jt, tt


def _batches(batch, n, seed=1, overflow_at=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t = rng.randint(0, V, (batch, S + 1))
        data = t[:, :-1].astype(np.float32)
        if i == overflow_at:
            data[:] = 1e30
        out.append({"data": data,
                    "softmax_label": t[:, 1:].astype(np.float32)})
    return out


def _close_params(jt, tt):
    ja, ta = jt.get_params()[0], tt.get_params()[0]
    for n in ja:
        np.testing.assert_allclose(ta[n].asnumpy(), ja[n].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("scale", ["fixed", "dynamic"])
def test_trainer_loss_scale_matches_jax(scale):
    js, ts = _lm(4)
    kw = (dict(loss_scale=1024.0) if scale == "fixed" else
          dict(loss_scale="dynamic",
               guard_params={"init_scale": 2.0 ** 10, "growth_interval": 2}))
    jt, tt = _pair(js, ts, 4, **kw)
    for i, b in enumerate(_batches(4, 5, overflow_at=2)):
        jh, th = np.asarray(jt.step(b)[0]), tt.step(b)[0].numpy()
        if i != 2:
            np.testing.assert_allclose(th, jh, rtol=1e-4, atol=0)
    _close_params(jt, tt)
    jr, tr = jt.resilience_stats(), tt.resilience_stats()
    for k in ("skipped_steps", "overflow_steps", "good_steps", "loss_scale",
              "norm_steps", "num_update"):
        assert tr[k] == jr[k], (k, tr[k], jr[k])
    np.testing.assert_allclose(tr["norm_sum"], jr["norm_sum"], rtol=1e-4)
    assert tr["skipped_steps"] == 1
    assert tr["overflow_steps"] == (1 if scale == "dynamic" else 0)
    assert tr["loss_scale"] == (1024.0 if scale == "fixed" else 2048.0)


def test_fp8_turns_on_dynamic_scaling():
    js, ts = _lm(2, quant="fp8")
    jt, tt = _pair(js, ts, 2)
    assert tt._resil.dynamic and jt._resil.dynamic
    assert tt.resilience_stats()["loss_scale"] == 2.0 ** 15
    plain = ShardedTrainer(_lm(2)[1], device="cpu")
    assert plain._resil is None
    off = ShardedTrainer(ts, guard=False, device="cpu")
    assert off._resil is None


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_matches_jax(accum):
    js, ts = _lm(4 // accum)
    jt, tt = _pair(js, ts, 4, accum=accum, clip_global_norm=0.5)
    for i, b in enumerate(_batches(4, 3, seed=2)):
        jh, th = np.asarray(jt.step(b)[0]), tt.step(b)[0].numpy()
        assert th.shape == jh.shape == (4 * S,)
        np.testing.assert_allclose(th, jh, rtol=1e-4, atol=0,
                                   err_msg=f"step {i}")
    _close_params(jt, tt)
    b = _batches(4, 1, seed=3)[0]
    np.testing.assert_allclose(tt.forward(b)[0].numpy(),
                               np.asarray(jt.forward(b)[0]), rtol=1e-4)


def _mlp():
    with mxt.name.NameManager():
        net = tsym.FullyConnected(tsym.Variable("data"), num_hidden=16,
                                  name="fc1")
        net = tsym.Activation(net, act_type="tanh")
        net = tsym.FullyConnected(net, num_hidden=4, name="fc2")
        return tsym.SoftmaxOutput(net, name="softmax")


def test_grad_accum_against_one_microbatch_within_jax_bound():
    net = _mlp()
    arg_shapes, _, _ = net.infer_shape(data=(16, 8), softmax_label=(16,))
    rng = np.random.RandomState(5)
    args = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}

    def build(accum):
        tr = ShardedTrainer(net, "sgd", {"learning_rate": 0.5,
                                         "momentum": 0.9},
                            grad_accum=accum, device="cpu")
        return tr.bind({"data": (16, 8)}, {"softmax_label": (16,)},
                       arg_params=args)

    full, accum = build(1), build(4)
    rng = np.random.RandomState(0)
    for _ in range(3):
        batch = {"data": rng.rand(16, 8).astype(np.float32),
                 "softmax_label": rng.randint(0, 4, 16).astype(np.float32)}
        np.testing.assert_allclose(full.step(batch)[0].numpy(),
                                   accum.step(batch)[0].numpy(),
                                   rtol=2e-5, atol=2e-6)
    for n, p in full._params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   accum._params[n].detach().numpy(),
                                   rtol=5e-5, atol=5e-6, err_msg=n)
    batch = {"data": rng.rand(16, 8).astype(np.float32),
             "softmax_label": np.zeros(16, np.float32)}
    f1, f2 = full.forward(batch)[0], accum.forward(batch)[0]
    assert f2.shape == f1.shape == (16, 4)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), rtol=2e-5, atol=2e-6)
    with pytest.raises(MXNetError, match="not divisible"):
        ShardedTrainer(net, grad_accum=3, device="cpu").bind(
            {"data": (16, 8)}, {"softmax_label": (16,)})


def test_matmul_precision_names_and_restore():
    prev = (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)
    want = {"bfloat16": "medium", "default": "medium",
            "tensorfloat32": "high", "high": "high",
            "float32": "highest", "highest": "highest"}
    for name, torch_name in want.items():
        with matmul_precision_scope(name):
            assert torch.get_float32_matmul_precision() == torch_name
            assert torch.backends.cudnn.allow_tf32 == (torch_name
                                                       != "highest")
        assert (torch.get_float32_matmul_precision(),
                torch.backends.cudnn.allow_tf32) == prev
    net = _mlp()
    tr = ShardedTrainer(net, matmul_precision="tensorfloat32", device="cpu")
    tr.bind({"data": (16, 8)}, {"softmax_label": (16,)})
    seen = []
    real = tr._apply_update

    def spy(*a):
        seen.append(torch.get_float32_matmul_precision())
        return real(*a)

    tr._apply_update = spy
    tr.step({"data": np.ones((16, 8), np.float32),
             "softmax_label": np.zeros(16, np.float32)})
    assert seen == ["high"]
    assert torch.get_float32_matmul_precision() == prev[0]
    with pytest.raises(MXNetError, match="matmul_precision"):
        ShardedTrainer(net, matmul_precision="int8", device="cpu")


def test_embedding_out_of_range_ids_match_jax_take():
    ids = np.array([[np.nan, 1e30, -1e30, -1.0], [70.0, 3.7, -10.0, -11.0]],
                   np.float32)
    w = np.arange(40, dtype=np.float32).reshape(10, 4)
    g = np.random.RandomState(0).randn(2, 4, 4).astype(np.float32)
    jop, top = jget_op("Embedding"), tget_op("Embedding")
    params = {"input_dim": "10", "output_dim": "4"}
    jout, vjp = jax.vjp(lambda ww: jop.forward(
        JCtx(is_train=True), jop.parse_params(params), jnp.asarray(ids), ww),
        jnp.asarray(w))
    (jdw,) = vjp(jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_(True)
    tout = top.forward(TCtx(is_train=True), top.parse_params(params),
                       torch.from_numpy(ids), wt)
    tout.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jdw))
    assert np.isnan(tout.detach().numpy()[0, 1]).all()
