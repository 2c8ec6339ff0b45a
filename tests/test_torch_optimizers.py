"""The remaining optimizers and initializers of the PyTorch port
(mxnet_tpu_torch/optimizer.py, initializer.py) against the JAX package's.

* NAG, ccSGD, AdaGrad, RMSProp, AdaDelta and Test: ``_functional_step``
  over 5 steps on the same f32 weights, gradients and hyperparameters,
  within rtol 1e-6, atol 1e-7 (XLA:CPU may contract a multiply-add into
  an FMA, one rounding fewer), and through each package's
  ``ShardedTrainer`` (unfused, as in the JAX package: only ccSGD fuses)
  on the mlp within the trainer tests' rtol 1e-4, atol 1e-6.
* SGLD: its noise-free part equals the JAX step's, and its noise has mean
  0 and variance ``lr`` (PRNG bits cannot match).
* ccSGD's fused update (K2's plain version on the CPU) is bitwise its
  unfused update in the port.
* ``Load``, ``Mixed`` and the bilinear ``upsampling`` fill equal the JAX
  package's bitwise; ``Orthogonal`` and ``MSRAPrelu`` draw from a
  ``torch.Generator`` and are checked by their properties (orthogonal
  rows, the variance of the rule).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import initializer as jinit
from mxnet_tpu import models as jmodels
from mxnet_tpu import random as jrandom
from mxnet_tpu import nd as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_update as fu
from mxnet_tpu_torch.parallel import ShardedTrainer

@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    """Every JAX trainer draws its base key from the JAX package's global
    PRNG: restore it, so the test files that run after this one in the
    same process draw what they would draw without it."""
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


KW = {
    "nag": {"momentum": 0.9, "wd": 1e-3},
    "ccsgd": {"momentum": 0.9, "wd": 1e-3, "clip_gradient": 0.5},
    "adagrad": {"eps": 1e-6, "wd": 1e-3},
    "rmsprop": {"gamma1": 0.9, "gamma2": 0.8, "wd": 1e-3},
    "adadelta": {"rho": 0.95, "epsilon": 1e-5, "wd": 1e-3},
    "test": {},
}
LR = 0.05


def _leaves(s):
    """An optimizer state (None, one array or a tuple) as a list of numpy
    arrays."""
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [np.asarray(x) for x in s]
    return [np.asarray(s)]


@pytest.mark.parametrize("name", sorted(KW))
def test_functional_step_matches_jax(name):
    jo = jopt.create(name, rescale_grad=0.5, **KW[name])
    to = topt.create(name, rescale_grad=0.5, **KW[name])
    assert type(to).__name__ == type(jo).__name__
    assert to._hyper() == jo._hyper()
    rng = np.random.RandomState(0)
    w = rng.randn(7, 5).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w.copy())
    js = jo.state_zeros_like(jw)
    ts = to.state_zeros_like(tw)
    for t in range(1, 6):
        g = rng.randn(7, 5).astype(np.float32)
        jw, js = type(jo)._functional_step(jo._hyper(), jw, jnp.asarray(g),
                                           js, LR, jo._get_wd("fc_weight"),
                                           t, None)
        tw, ts = type(to)._functional_step(to._hyper(), tw,
                                           torch.from_numpy(g), ts, LR,
                                           to._get_wd("fc_weight"), t, None)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7, err_msg=f"{name} step {t}")
        assert len(_leaves(ts)) == len(_leaves(js))
        for a, b in zip(_leaves(ts), _leaves(js)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_imperative_updater_runs_the_new_optimizers():
    for name in sorted(KW):
        jup = jopt.get_updater(jopt.create(name, learning_rate=LR,
                                           **KW[name]))
        tup = topt.get_updater(topt.create(name, learning_rate=LR,
                                           **KW[name]))
        rng = np.random.RandomState(1)
        w = rng.randn(4, 3).astype(np.float32)
        jw, tw = jnd.array(w), tnd.array(w, ctx=mxt.cpu())
        for _ in range(3):
            g = rng.randn(4, 3).astype(np.float32)
            jup(0, jnd.array(g), jw)
            tup(0, tnd.array(g, ctx=mxt.cpu()), tw)
        np.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_sgld_noise_free_part_and_noise_statistics():
    rng = np.random.RandomState(2)
    n = 200_000
    w = rng.randn(n).astype(np.float32)
    g1, g2 = (rng.randn(n).astype(np.float32) for _ in range(2))
    hyper = topt.create("sgld", rescale_grad=2.0)._hyper()
    lr, wd = 0.01, 1e-3

    def port(g, seed=0):
        out, state = topt.SGLD._functional_step(
            hyper, torch.from_numpy(w), torch.from_numpy(g), None, lr, wd,
            1, torch.Generator().manual_seed(seed))
        assert state is None
        return out.double().numpy()

    def jax_(g):
        out, _ = jopt.SGLD._functional_step(
            hyper, jnp.asarray(w), jnp.asarray(g), None, lr, wd, 1,
            jax.random.PRNGKey(0))
        return np.asarray(out, np.float64)

    # one key (generator seed) draws the same noise for both gradients, so
    # the difference of two steps is the difference of the noise-free
    # parts, w - lr / 2 * (g * rescale + wd * w)
    np.testing.assert_allclose(port(g1) - port(g2), jax_(g1) - jax_(g2),
                               atol=1e-6)
    clean = (w - lr / 2 * (g1 * 2.0 + wd * w)).astype(np.float64)
    for z in (port(g1) - clean, jax_(g1) - clean):
        # mean 0 and variance lr, within 5 standard errors
        assert abs(z.mean()) < 5 * np.sqrt(lr / n)
        assert abs(z.var() / lr - 1) < 5 * np.sqrt(2 / n)
    assert port(g1).tobytes() == port(g1).tobytes()    # seeded: replays
    assert port(g1).tobytes() != port(g1, seed=1).tobytes()


def _mlp_pair(name, fused=None):
    with mx.name.NameManager(), mxt.name.NameManager():
        jsym, tsym = jmodels.mlp(), tmodels.mlp()
    shapes, _, _ = tsym.infer_shape(data=(8, 784), softmax_label=(8,))
    rng = np.random.RandomState(0)
    args = {n: (0.1 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    kw = dict(KW.get(name, {}), learning_rate=LR)
    jt = JaxTrainer(jsym, optimizer=name, optimizer_params=dict(kw),
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]),
                    guard=True, clip_global_norm=0.5)
    jt.bind({"data": (8, 784)}, {"softmax_label": (8,)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()})
    tt = ShardedTrainer(tsym, optimizer=name, optimizer_params=dict(kw),
                        guard=True, clip_global_norm=0.5,
                        fused_update=fused, device="cpu")
    tt.bind({"data": (8, 784)}, {"softmax_label": (8,)}, arg_params=args)
    return jt, tt


def _batches(n=3, seed=5):
    rng = np.random.RandomState(seed)
    return [{"data": rng.rand(8, 784).astype(np.float32),
             "softmax_label": rng.randint(0, 10, 8).astype(np.float32)}
            for _ in range(n)]


# RMSProp is left out: its JAX state is one zeros buffer three times over,
# which the JAX trainer's donating step rejects ("donate the same buffer
# twice"); its step is held to JAX's above
@pytest.mark.parametrize("name", sorted(set(KW) - {"rmsprop"}))
def test_trainer_with_each_optimizer_matches_jax(name):
    jt, tt = _mlp_pair(name)
    assert fu.fused_kind(tt.optimizer) == (
        "sgd_momentum" if name == "ccsgd" else None)
    assert tt._fused == (name == "ccsgd")
    for b in _batches():
        jt.step(b)
        tt.step(b)
    jargs, targs = jt.get_params()[0], tt.get_params()[0]
    for n in jargs:
        np.testing.assert_allclose(targs[n].asnumpy(), jargs[n].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_ccsgd_fused_update_is_bitwise_its_unfused_update():
    _, fused = _mlp_pair("ccsgd", fused=True)
    _, unfused = _mlp_pair("ccsgd", fused=False)
    for b in _batches(n=4):
        fused.step(b)
        unfused.step(b)
    fa, ua = fused.get_params()[0], unfused.get_params()[0]
    for n in fa:
        assert fa[n].asnumpy().tobytes() == ua[n].asnumpy().tobytes(), n
    fs, us = fused.opt_state_by_param(), unfused.opt_state_by_param()
    for n in fs:
        assert torch.equal(fs[n][0], us[n][0]), n


def test_sgld_trains_through_the_trainer_generator():
    def run(seed):
        with mxt.name.NameManager():
            sym = tmodels.mlp()
        tr = ShardedTrainer(sym, optimizer="sgld",
                            optimizer_params={"learning_rate": 1e-3},
                            device="cpu", seed=seed)
        tr.bind({"data": (8, 784)}, {"softmax_label": (8,)})
        before = tr.get_params()[0]["fc1_weight"].asnumpy()
        for b in _batches(n=2):
            tr.step(b)
        return before, tr.get_params()[0]["fc1_weight"].asnumpy()

    (b0, a0), (_, a0_again), (b1, a1) = run(0), run(0), run(1)
    assert not np.array_equal(b0, a0)
    assert a0.tobytes() == a0_again.tobytes()     # seeded: replays
    assert a0.tobytes() != a1.tobytes()


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _fill(init_pair, name, shape):
    jinit_obj, tinit_obj = init_pair
    ja = jnd.zeros(shape)
    ta = tnd.zeros(shape, ctx=mxt.cpu())
    jinit_obj(name, ja)
    tinit_obj(name, ta, generator=torch.Generator().manual_seed(0))
    return ta.asnumpy(), ja.asnumpy()


def test_bilinear_upsampling_fill_equals_jax():
    for shape in ((2, 3, 4, 4), (1, 1, 5, 3)):
        t, j = _fill((jinit.Uniform(), tinit.Uniform()),
                     "upsampling0_weight", shape)
        assert t.tobytes() == j.tobytes()


def test_load_and_mixed_equal_jax():
    rng = np.random.RandomState(3)
    saved = {"arg:fc_weight": rng.randn(3, 4).astype(np.float32),
             "aux:bn_moving_var": rng.rand(4).astype(np.float32)}
    pair = (jinit.Load({k: jnd.array(v) for k, v in saved.items()},
                       default_init=jinit.Constant(0.25)),
            tinit.Load({k: tnd.array(v, ctx=mxt.cpu())
                        for k, v in saved.items()},
                       default_init=tinit.Constant(0.25)))
    for name, shape in (("fc_weight", (3, 4)), ("bn_moving_var", (4,)),
                        ("other_bias", (2,))):
        t, j = _fill(pair, name, shape)
        assert t.tobytes() == j.tobytes(), name
    for m, err in ((jinit, mx.base.MXNetError), (tinit, MXNetError)):
        with pytest.raises(err, match="shape mismatch"):
            m.Load(saved)("fc_weight", (jnd.zeros((2, 2)) if m is jinit
                                        else tnd.zeros((2, 2),
                                                       ctx=mxt.cpu())))
    pair = (jinit.Mixed([r".*_bias$", r"fc\d_weight", ".*"],
                        [jinit.Constant(0.5), jinit.One(), jinit.Zero()]),
            tinit.Mixed([r".*_bias$", r"fc\d_weight", ".*"],
                        [tinit.Constant(0.5), tinit.One(), tinit.Zero()]))
    for name in ("fc1_bias", "fc2_weight", "conv_weight"):
        t, j = _fill(pair, name, (3, 2))
        assert t.tobytes() == j.tobytes(), name
    with pytest.raises(MXNetError, match="did not match"):
        tinit.Mixed(["fc"], [tinit.One()])("conv_weight",
                                           tnd.zeros((1,), ctx=mxt.cpu()))


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 10), (12, 3, 2)])
def test_orthogonal_rows_or_columns_are_orthonormal(shape, rand_type):
    a = tnd.zeros(shape, ctx=mxt.cpu())
    tinit.Orthogonal(scale=1.5, rand_type=rand_type)(
        "fc_weight", a, generator=torch.Generator().manual_seed(1))
    q = a.asnumpy().reshape(shape[0], -1).astype(np.float64) / 1.5
    gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
    np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-6)
    b = tnd.zeros(shape, ctx=mxt.cpu())
    tinit.Orthogonal(scale=1.5, rand_type=rand_type)(
        "fc_weight", b, generator=torch.Generator().manual_seed(1))
    assert a.asnumpy().tobytes() == b.asnumpy().tobytes()


def test_msra_prelu_has_the_variance_of_its_rule():
    shape = (256, 128, 3, 3)
    a = tnd.zeros(shape, ctx=mxt.cpu())
    tinit.MSRAPrelu(factor_type="in", slope=0.25)(
        "conv_weight", a, generator=torch.Generator().manual_seed(2))
    fan_in = 128 * 9
    want = 2.0 / (1 + 0.25 ** 2) / fan_in
    x = a.asnumpy().astype(np.float64)
    assert abs(x.mean()) < 5 * np.sqrt(want / x.size)
    assert abs(x.var() / want - 1) < 0.02
    assert tinit.MSRAPrelu().dumps() == jinit.MSRAPrelu().dumps()
    # the name rules still apply: biases and gammas are constants
    b = tnd.zeros((4,), ctx=mxt.cpu())
    tinit.MSRAPrelu()("conv_bias", b)
    assert (b.asnumpy() == 0).all()
