"""Fused optimizer update of the PyTorch port (mxnet_tpu_torch/ops/
fused_update.py, kernel K2) on the CPU.

* K2's plain version against the JAX package's ``fu.reference_update``
  (not ``pallas_update``, which fails on the reference tree: ROADMAP
  Queue 3) for every kind and the wd_vec / mult / ok / clip variants,
  within rtol 1e-6 / atol 1e-7 (XLA may contract multiply-adds into FMAs
  where ATen rounds each op; ``fused_update.py:168-187`` of the JAX
  package), and ``ok=False`` bitwise unchanged;
* ``build_plan`` / ``FusedPlan`` layouts equal the JAX package's;
* the port's fused trainer is a BITWISE twin of its unfused trainer:
  parameters, optimizer state and heads after every step, for every
  kind, with the guard and a poisoned step (the JAX package's
  ``tests/test_fused_update.py`` contract).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.models import resnet as jax_resnet
from mxnet_tpu.ops import fused_update as jfu

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import symbol as S
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_update as tfu
from mxnet_tpu_torch.parallel import ShardedTrainer

HYPER = dict(momentum=0.9, beta1=0.9, beta2=0.999, epsilon=1e-8,
             rescale_grad=1.0 / 16)

# (kind, scalars, use wd_vec, use mult, ok, clip)
CASES = [
    ("sgd", (0.1,), False, False, None, None),
    ("sgd", (0.1,), True, True, True, 0.05),
    ("sgd_momentum", (0.1,), False, False, None, None),
    ("sgd_momentum", (0.1,), True, True, True, None),
    ("sgd_momentum", (0.1,), True, False, None, 0.05),
    ("sgd_momentum", (0.1,), True, True, False, 0.05),
    ("adam", (1e-3,), False, False, None, None),
    ("adam", (1e-3,), False, True, True, 0.05),
    ("adamw", (1e-3, 1e-5), False, False, None, None),
    ("adamw", (1e-3, 1e-3), True, True, True, 0.05),
    ("adamw", (1e-3, 1e-3), True, True, False, None),
]
IDS = [f"{k}{'_wdvec' if v else ''}{'_mult' if m else ''}"
       f"{'' if ok is None else '_ok' if ok else '_notok'}"
       f"{'_clip' if c else ''}" for k, _, v, m, ok, c in CASES]


def _operands(kind, n=1003, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(np.float32)
    w = rng.randn(n).astype(np.float32)
    state = [rng.randn(n).astype(np.float32) for _ in range(
        tfu._N_STATE[kind])]
    if kind in ("adam", "adamw"):
        state[1] = np.abs(state[1])           # a second moment
    wdv = rng.choice([0.0, 1e-4, 5e-3], n).astype(np.float32)
    return g, w, state, wdv


@pytest.mark.parametrize("kind,scalars,use_wdvec,use_mult,ok,clip", CASES,
                         ids=IDS)
def test_plain_version_matches_jax_reference(kind, scalars, use_wdvec,
                                             use_mult, ok, clip):
    g, w, state, wdv = _operands(kind)
    kw = dict(HYPER, kind=kind, wd=1e-4, clip_gradient=clip)
    mult = np.float32(0.37) if use_mult else None
    want = jfu.reference_update(
        jnp.asarray(g), jnp.asarray(w), tuple(jnp.asarray(s) for s in state),
        tuple(jnp.float32(s) for s in scalars),
        mult=None if mult is None else jnp.float32(mult),
        ok=None if ok is None else jnp.asarray(ok),
        wd_vec=jnp.asarray(wdv) if use_wdvec else None, **kw)
    t = torch.from_numpy
    ts = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    tw, tstate = t(w.copy()), tuple(t(s.copy()) for s in state)
    plain = tfu.reference_update(
        t(g), tw, tstate, tuple(ts(s) for s in scalars),
        mult=None if mult is None else ts(mult),
        ok=None if ok is None else torch.tensor(ok),
        wd_vec=t(wdv) if use_wdvec else None, **kw)
    for a, b in zip(plain, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    if ok is False:
        for a, b in zip(plain, (w, *state)):
            assert a.numpy().tobytes() == b.tobytes()
    # the wrapper on CPU tensors: the plain version, written in place
    before = tfu.fused_update.launches
    out = tfu.fused_update(
        t(g), tw, tstate, tuple(ts(s) for s in scalars),
        mult=None if mult is None else ts(mult),
        ok=None if ok is None else torch.tensor(ok),
        wd_vec=t(wdv) if use_wdvec else None, **kw)
    assert tfu.fused_update.launches == before
    assert out[0] is tw
    for a, b in zip((tw,) + tstate, plain):
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("budget", [4 << 20, 4096, 1000])
def test_plan_layout_equals_jax(budget):
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet = jax_resnet(num_classes=10, depth=50)
        tnet = mxt.models.resnet(num_classes=10, depth=50)
    shapes, _, _ = tnet.infer_shape(data=(2, 3, 32, 32),
                                    softmax_label=(2,))
    names = [n for n in tnet.list_arguments()
             if n not in ("data", "softmax_label")]
    assert names == [n for n in jnet.list_arguments()
                     if n not in ("data", "softmax_label")]
    shape_of = dict(zip(tnet.list_arguments(), shapes))
    jp = jfu.build_plan(names, shape_of, budget)
    tp = tfu.build_plan(names, shape_of, budget)
    assert tp.order == jp.order
    assert tp.buckets == jp.buckets
    assert tp.bucket_sizes == jp.bucket_sizes
    # the buckets tile the concatenation of the parameters in plan order
    offs, flat = tp.offsets, 0
    for bucket in tp.buckets:
        for n, s0, s1 in bucket:
            assert offs[n] + s0 == flat
            flat += s1 - s0
    assert flat == sum(int(np.prod(shape_of[n])) for n in names)


def test_resnet50_has_25_buckets():
    net = mxt.models.get_symbol("resnet", num_classes=1000, depth=50)
    shapes, _, _ = net.infer_shape(data=(1, 3, 224, 224),
                                   softmax_label=(1,))
    names = [n for n in net.list_arguments()
             if n not in ("data", "softmax_label")]
    plan = tfu.build_plan(names, dict(zip(net.list_arguments(), shapes)),
                          4 << 20)
    assert sum(plan.bucket_sizes) == 25557032
    assert len(plan.buckets) == 25
    assert max(plan.bucket_sizes) == 1 << 18 << 2


def test_wrapper_validates_operands():
    g = torch.zeros(8)
    lr = torch.tensor(0.1)
    with pytest.raises(MXNetError, match="state operands"):
        tfu.fused_update(g, g.clone(), (), (lr,), kind="sgd_momentum")
    with pytest.raises(MXNetError, match="flat float32"):
        tfu.fused_update(g, torch.zeros(7), (), (lr,), kind="sgd")
    with pytest.raises(MXNetError, match="one-element float32"):
        tfu.fused_update(g, g.clone(), (), (torch.zeros(2),), kind="sgd")
    with pytest.raises(MXNetError, match="bool"):
        tfu.fused_update(g, g.clone(), (), (lr,), kind="sgd",
                         ok=torch.tensor(1.0))
    with pytest.raises(MXNetError, match="unsupported fused kind"):
        tfu.fused_update(g, g.clone(), (), (lr,), kind="nag")


# ----------------------------------------------------------------------
# the fused trainer is a bitwise twin of the unfused one
# ----------------------------------------------------------------------

def _mlp(no_bias=False):
    with mxt.name.NameManager():
        d = S.Variable("data")
        net = S.FullyConnected(d, num_hidden=32, name="fc1", no_bias=no_bias)
        net = S.Activation(net, act_type="relu")
        net = S.FullyConnected(net, num_hidden=10, name="fc2",
                               no_bias=no_bias)
        return S.SoftmaxOutput(net, name="softmax")


def _trainer(fused, optimizer="sgd", opt_params=None, no_bias=False, **kw):
    tr = ShardedTrainer(_mlp(no_bias), optimizer=optimizer,
                        optimizer_params=opt_params
                        or {"learning_rate": 0.1, "momentum": 0.9},
                        fused_update=fused, device="cpu", seed=7, **kw)
    tr.bind(data_shapes={"data": (16, 8)},
            label_shapes={"softmax_label": (16,)})
    return tr


def _feeds(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.rand(16, 8).astype(np.float32),
             "softmax_label": rng.randint(0, 10, (16,)).astype(np.float32)}
            for _ in range(n)]


def _params_bytes(tr):
    return {n: v.asnumpy().tobytes() for n, v in tr.get_params()[0].items()}


def _state_bytes(tr):
    return {n: [s.numpy().tobytes() for s in ss]
            for n, ss in tr.opt_state_by_param().items()}


KINDS = [
    ("sgd", {"learning_rate": 0.1}, False),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, False),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.5}, True),
    ("adam", {"learning_rate": 1e-3}, False),
    ("adamw", {"learning_rate": 1e-3, "wd": 0.01}, True),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.5}, False),
    ("adamw", {"learning_rate": 1e-3, "wd": 0.01}, False),
]


@pytest.mark.parametrize("opt,op,no_bias", KINDS,
                         ids=["sgd", "sgd_momentum", "sgd_wd_clip", "adam",
                              "adamw", "sgd_wdvec", "adamw_wdvec"])
def test_fused_trainer_is_bitwise_twin_of_unfused(opt, op, no_bias):
    a = _trainer(True, opt, op, no_bias=no_bias)
    b = _trainer(False, opt, op, no_bias=no_bias)
    assert a._fused and not b._fused
    assert _params_bytes(a) == _params_bytes(b)        # same seeded init
    if op.get("wd") and not no_bias:
        assert a._flat_wd is not None
    for si, f in enumerate(_feeds()):
        ha, hb = a.step(f), b.step(f)
        assert ha[0].numpy().tobytes() == hb[0].numpy().tobytes(), si
        assert _params_bytes(a) == _params_bytes(b), si
        assert _state_bytes(a) == _state_bytes(b), si


@pytest.mark.parametrize("opt,op", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-3}),
], ids=["sgd_momentum", "adam"])
def test_fused_guard_twin_and_poisoned_step_is_bitwise_noop(opt, op):
    a = _trainer(True, opt, op, guard=True, clip_global_norm=0.1)
    b = _trainer(False, opt, op, guard=True, clip_global_norm=0.1)
    feeds = _feeds(4)
    feeds[2]["data"][0, 0] = np.nan
    for si, f in enumerate(feeds):
        pre_w, pre_s = _params_bytes(a), _state_bytes(a)
        a.step(f), b.step(f)
        if si == 2:
            assert _params_bytes(a) == pre_w
            assert _state_bytes(a) == pre_s
        assert _params_bytes(a) == _params_bytes(b), si
        assert _state_bytes(a) == _state_bytes(b), si
    assert int(a._guard_state["skipped"]) == 1


def test_multi_bucket_and_split_params_stay_bitwise():
    a = _trainer(True, grad_bucket_bytes=1024)
    b = _trainer(False, grad_bucket_bytes=1024)
    assert len(a._fused_plan.buckets) > 1
    per_bucket = [{n for n, _, _ in b_} for b_ in a._fused_plan.buckets]
    assert any(per_bucket[i] & per_bucket[i + 1]
               for i in range(len(per_bucket) - 1))
    for si, f in enumerate(_feeds()):
        a.step(f), b.step(f)
        assert _params_bytes(a) == _params_bytes(b), si
        assert _state_bytes(a) == _state_bytes(b), si


def test_eligibility_gate(monkeypatch):
    op = {"learning_rate": 1e-3, "wd": 0.01}
    tr = _trainer(None, "adamw", op)
    assert tr._fused and not tr._fused_wd_uniform
    assert set(np.unique(tr._flat_wd.numpy())) <= {np.float32(0.0),
                                                   np.float32(0.01)}
    # adam with weight decay cannot fuse: silent fallback, or an error
    assert not _trainer(None, "adam", op)._fused
    with pytest.raises(MXNetError, match="adam with weight decay"):
        _trainer(True, "adam", op)
    # per-param lr_mult cannot fuse
    opt = mxt.optimizer.create("sgd", learning_rate=0.1)
    opt.set_lr_mult({"fc1_weight": 0.5})
    tr = ShardedTrainer(_mlp(), optimizer=opt, fused_update=True,
                        device="cpu")
    with pytest.raises(MXNetError, match="lr_mult"):
        tr.bind({"data": (16, 8)}, {"softmax_label": (16,)})
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "0")
    assert not _trainer(None)._fused
    assert _trainer(True)._fused
