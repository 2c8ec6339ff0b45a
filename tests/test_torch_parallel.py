"""Data parallelism of the PyTorch port in one process
(``mxnet_tpu_torch.parallel``: meshes, collectives, ``ShardedTrainer``
over a mesh) against the JAX package's ``tests/test_parallel.py`` and
against the JAX trainer itself, on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
gives it; the port's meshes are the same number of CPU contexts
(``cpu(0)`` ... ``cpu(7)``, one torch device, reduced by copies along the
same bucketed branch the cards take through NCCL).

Tolerances, as stated in each test:

* integer-valued reductions: exact (``assert_array_equal``);
* the port against itself over 1 and 8 members: the JAX test's rtol
  2e-5, atol 2e-6 (the summation order of the member sum and of the
  split BatchNorm moments);
* the port against the JAX trainer: heads atol 1e-5, parameters and
  moving statistics rtol 1e-4, atol 1e-6 (f32 summation order differs
  between XLA and ATen, carried through a few updates).

The tensor-parallel test of ``tests/test_parallel.py`` is in
``tests/test_torch_tensor_parallel.py``.
"""
import logging
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import compile_cache as jcc
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import compile_cache as tcc
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import (ShardedTrainer, allreduce_sum,
                                      data_parallel_mesh, make_mesh)

HEAD_ATOL = 1e-5
RTOL, ATOL = 1e-4, 1e-6
SELF_RTOL, SELF_ATOL = 2e-5, 2e-6


@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


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


def cpus(n):
    return [mxt.cpu(i) for i in range(n)]


def tmesh(n):
    return make_mesh({"data": n}, cpus(n))


def jmesh(n):
    return jmake_mesh({"data": n}, jax.devices()[:n])


def _mlp(S, bn=False, normalization="null", use_ignore=False):
    net = S.Variable("data")
    if bn:
        net = S.BatchNorm(data=net, name="bn1", fix_gamma=False)
    net = S.FullyConnected(data=net, name="fc1", num_hidden=16)
    net = S.Activation(data=net, name="relu1", act_type="relu")
    if bn:
        net = S.BatchNorm(data=net, name="bn2", fix_gamma=False)
    net = S.FullyConnected(data=net, name="fc2", num_hidden=4)
    return S.SoftmaxOutput(data=net, name="softmax",
                           normalization=normalization,
                           use_ignore=use_ignore, ignore_label=0)


def _build(pkg_sym, **kw):
    with mx.name.NameManager(), mxt.name.NameManager():
        return _mlp(pkg_sym, **kw)


def _toy_batch(n=32, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    w = rs.randn(8, 4).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    return x, y


def _state(sym, batch, seed=4):
    shapes, _, aux_shapes = sym.infer_shape(data=(batch, 8),
                                            softmax_label=(batch,))
    rs = np.random.RandomState(seed)
    args = {n: (0.3 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (rs.rand(*s).astype(np.float32) + 0.5 if n.endswith("var")
               else (0.1 * rs.randn(*s)).astype(np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


# ---------------------------------------------------------------------------
# tests/test_parallel.py, mirrored
# ---------------------------------------------------------------------------

def test_make_mesh_axes():
    mesh = make_mesh({"data": 4, "model": 2}, cpus(8))
    assert mesh.shape == {"data": 4, "model": 2}
    mesh = make_mesh({"data": -1}, cpus(8))
    assert mesh.shape["data"] == 8
    with pytest.raises(MXNetError):
        make_mesh({"data": 3}, cpus(8))  # 8 devices not divisible
    with pytest.raises(MXNetError):
        make_mesh({"data": 2}, [mxt.cpu(0), mxt.cpu(0)])  # not distinct
    # the same axis arithmetic as the JAX package's
    assert jmake_mesh({"data": 4, "model": 2}).shape == {"data": 4,
                                                         "model": 2}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_allreduce_sum_exact(n):
    # member i contributes (i+1) * ones: the total is n(n+1)/2
    arrays = [mxt.nd.NDArray(torch.full((4, 3), i + 1.0), ctx=c)
              for i, c in enumerate(cpus(n))]
    out = allreduce_sum(arrays)
    for o, c in zip(out, cpus(n)):
        assert o.context == c
        np.testing.assert_array_equal(o.asnumpy(), n * (n + 1) / 2)
    jout = mx.parallel.allreduce_sum(
        [jax.device_put(jnp.full((4, 3), i + 1, jnp.float32), d)
         for i, d in enumerate(jax.devices()[:n])])
    np.testing.assert_array_equal(out[0].asnumpy(), np.asarray(jout[0]))


def test_allreduce_co_resident_fallback():
    arrays = [mxt.nd.NDArray(torch.full((2,), i + 1.0), ctx=mxt.cpu(0))
              for i in range(3)]
    with tpar.collectives.count_collectives() as stats:
        out = allreduce_sum(arrays)
    np.testing.assert_array_equal(out[0].asnumpy(), 6)
    assert [r["kind"] for r in stats.records] == ["tree"]


def test_kvstore_local_collective_reduce():
    kv = mxt.kvstore.create("local")
    shape = (3, 2)
    with mxt.cpu():
        kv.init(3, mxt.nd.zeros(shape))
        vals = [mxt.nd.NDArray(torch.full(shape, i + 1.0), ctx=c)
                for i, c in enumerate(cpus(4))]
        kv.push(3, vals)
        out = mxt.nd.zeros(shape)
        kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), 10.0)


def _port_trainer(sym, n, batch=32, args=None, aux=None, **kw):
    opt = kw.pop("optimizer_params", {"learning_rate": 0.1,
                                      "momentum": 0.9})
    tr = ShardedTrainer(sym, "sgd", opt, mesh=tmesh(n), seed=7, **kw)
    tr.bind({"data": (batch, 8)}, {"softmax_label": (batch,)},
            arg_params=args, aux_params=aux)
    return tr


def test_sharded_trainer_dp_matches_single_device():
    """Same init and global batch: the same parameters whether the mesh
    has 1 or 8 members (data parallelism is arithmetic-neutral)."""
    sym = _build(mxt.sym)
    x, y = _toy_batch(32)
    out = []
    for n in (1, 8):
        tr = _port_trainer(sym, n)
        for _ in range(3):
            tr.step({"data": x, "softmax_label": y})
        out.append(tr.get_params()[0])
    for k in out[0]:
        np.testing.assert_allclose(out[0][k].asnumpy(), out[1][k].asnumpy(),
                                   rtol=SELF_RTOL, atol=SELF_ATOL)


def test_sharded_trainer_fit_improves():
    sym = _build(mxt.sym)
    x, y = _toy_batch(256, seed=3)
    tr = _port_trainer(sym, 8, batch=64,
                       optimizer_params={"learning_rate": 0.3,
                                         "momentum": 0.9})
    tr.fit(mxt.io.NDArrayIter(x, y, batch_size=64, shuffle=False),
           num_epoch=10)
    m = tr.score(mxt.io.NDArrayIter(x, y, batch_size=64), "acc")
    assert m.get()[1] > 0.7


def test_sharded_trainer_aux_states_update():
    """BatchNorm moving statistics update and stay the same on every
    member."""
    with mxt.name.NameManager():
        S = mxt.sym
        bn = S.BatchNorm(data=S.Variable("data"), name="bn1")
        fc = S.FullyConnected(data=bn, name="fc1", num_hidden=2)
        sym = S.SoftmaxOutput(data=fc, name="softmax")
    tr = ShardedTrainer(sym, "sgd", {"learning_rate": 0.01}, mesh=tmesh(8))
    tr.bind({"data": (16, 6)}, {"softmax_label": (16,)})
    x = np.random.RandomState(0).randn(16, 6).astype(np.float32) * 3 + 1
    before = {n: v.clone() for n, v in tr._aux.items()}
    tr.step({"data": x, "softmax_label": np.zeros((16,), np.float32)})
    assert any(not torch.allclose(before[n], v) for n, v in tr._aux.items())
    for i in range(1, 8):
        for n, v in tr._member_aux(i).items():
            assert torch.equal(v, tr._aux[n])


def _accum_net(S):
    net = S.FullyConnected(data=S.Variable("data"), num_hidden=16,
                           name="fc1")
    net = S.Activation(data=net, act_type="tanh")
    net = S.FullyConnected(data=net, num_hidden=4, name="fc2")
    return S.SoftmaxOutput(data=net, name="softmax")


def test_grad_accum_matches_full_batch():
    """grad_accum=k over a 2-member mesh matches the full-batch step for a
    BN-free model (rtol 2e-5 / atol 2e-6 heads, 5e-5 / 5e-6 params, the
    JAX test's), and the inference path restitches the rows."""
    with mxt.name.NameManager():
        net = _accum_net(mxt.sym)
    arg_shapes, _, _ = net.infer_shape(data=(16, 8), softmax_label=(16,))
    rng = np.random.RandomState(5)
    arg_params = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
                  for n, s in zip(net.list_arguments(), arg_shapes)
                  if n not in ("data", "softmax_label")}

    def build(accum):
        tr = ShardedTrainer(net, "sgd", {"learning_rate": 0.5,
                                         "momentum": 0.9},
                            mesh=tmesh(2), grad_accum=accum)
        tr.bind({"data": (16, 8)}, {"softmax_label": (16,)},
                arg_params=arg_params)
        return tr

    full, accum = build(1), build(4)
    for _ in range(3):
        batch = {"data": rng.rand(16, 8).astype(np.float32),
                 "softmax_label": rng.randint(0, 4, (16,))
                 .astype(np.float32)}
        np.testing.assert_allclose(full.step(batch)[0].numpy(),
                                   accum.step(batch)[0].numpy(),
                                   rtol=2e-5, atol=2e-6)
    for n in full._params:
        np.testing.assert_allclose(
            full._params[n].detach().numpy(),
            accum._params[n].detach().numpy(), rtol=5e-5, atol=5e-6,
            err_msg=f"{n} diverged under grad_accum")
    batch = {"data": rng.rand(16, 8).astype(np.float32),
             "softmax_label": np.zeros(16, np.float32)}
    f1, f2 = full.forward(batch)[0], accum.forward(batch)[0]
    assert f2.shape == f1.shape
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# the port against the JAX trainer, implicit mode
# ---------------------------------------------------------------------------

def _jax_trainer(sym, n, batch, args, aux, **kw):
    opt = kw.pop("optimizer_params", {"learning_rate": 0.1,
                                      "momentum": 0.9})
    jt = JaxTrainer(sym, optimizer="sgd", optimizer_params=opt,
                    mesh=jmesh(n), **kw)
    jt.bind({"data": (batch, 8)}, {"softmax_label": (batch,)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()},
            aux_params={k: jnp.asarray(v) for k, v in aux.items()})
    return jt


def _assert_pair(jt, tt, what):
    jarg, jaux = jt.get_params()
    targ, taux = tt.get_params()
    for n in jarg:
        np.testing.assert_allclose(targ[n].asnumpy(), jarg[n].asnumpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{what} {n}")
    for n in jaux:
        np.testing.assert_allclose(taux[n].asnumpy(), jaux[n].asnumpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{what} {n}")


IMPLICIT_NETS = {"batchnorm": {"bn": True},
                 "mlp_batch_normalization": {"normalization": "batch"},
                 "mlp_valid_normalization": {"normalization": "valid",
                                             "use_ignore": True}}


@pytest.mark.parametrize("net", sorted(IMPLICIT_NETS))
@pytest.mark.parametrize("n", [4, 8])
def test_implicit_trainer_matches_jax(net, n):
    """The implicit mode over n members against the JAX trainer over n
    virtual devices: BatchNorm's statistics and the ``batch``/``valid``
    normalization's denominator (labels of class 0 ignored: the members
    hold different counts of them) count the global batch in both."""
    kw = IMPLICIT_NETS[net]
    jsym, tsym = _build(mx.sym, **kw), _build(mxt.sym, **kw)
    args, aux = _state(tsym, 32)
    jt = _jax_trainer(jsym, n, 32, args, aux)
    tt = _port_trainer(tsym, n, args=args, aux=aux)
    for step in range(3):
        x, y = _toy_batch(32, seed=10 + step)
        jh = np.asarray(jt.step({"data": x, "softmax_label": y})[0])
        th = tt.step({"data": x, "softmax_label": y})[0].numpy()
        np.testing.assert_allclose(th, jh, atol=HEAD_ATOL)
        _assert_pair(jt, tt, f"step {step}")


def test_implicit_batchnorm_statistics_are_global():
    """Over 4 members the moving statistics are those of the whole batch
    (the one-member trainer's, to the JAX dp tolerance), not of any
    member's rows."""
    sym = _build(mxt.sym, bn=True)
    args, aux = _state(sym, 32)
    x, y = _toy_batch(32, seed=2)
    x[:8] += 5.0    # the first member's rows differ from the rest
    got = []
    for n in (1, 4):
        tr = _port_trainer(sym, n, args=args, aux=aux)
        tr.step({"data": x, "softmax_label": y})
        got.append({k: v.clone() for k, v in tr._aux.items()})
    for k in got[0]:
        np.testing.assert_allclose(got[1][k].numpy(), got[0][k].numpy(),
                                   rtol=SELF_RTOL, atol=SELF_ATOL)
    # a per-member statistic would have moved bn1's mean differently
    m = aux["bn1_moving_mean"]
    local = 0.9 * m + 0.1 * x[:8].mean(axis=0)
    assert not np.allclose(got[1]["bn1_moving_mean"].numpy(), local,
                           atol=1e-3)


def _kl_net(S):
    net = S.FullyConnected(data=S.Variable("data"), name="fc1",
                           num_hidden=16)
    net = S.Activation(data=net, name="sig1", act_type="sigmoid")
    net = S.IdentityAttachKLSparseReg(data=net, name="kl1", penalty=0.05,
                                      sparseness_target=0.2, momentum=0.8)
    net = S.FullyConnected(data=net, name="fc2", num_hidden=4)
    return S.SoftmaxOutput(data=net, name="softmax")


def test_implicit_kl_sparse_reg_matches_jax():
    """The KL sparseness penalty over 4 members against the JAX trainer
    over 4 devices: its batch mean, the moving average ``avg`` and the
    penalty's gradient are over the global batch in both (heads atol
    1e-5, parameters and ``avg`` rtol 1e-4 / atol 1e-6); the moving
    average is the one-member trainer's (the JAX dp tolerance), not one
    of the lead member's rows."""
    with mx.name.NameManager(), mxt.name.NameManager():
        jsym, tsym = _kl_net(mx.sym), _kl_net(mxt.sym)
    args, aux = _state(tsym, 32)
    aux = {"kl1_avg": np.full(16, 0.5, np.float32)}
    jt = _jax_trainer(jsym, 4, 32, args, aux)
    tt = _port_trainer(tsym, 4, args=args, aux=aux)
    one = _port_trainer(tsym, 1, args=args, aux=aux)
    for step in range(3):
        x, y = _toy_batch(32, seed=30 + step)
        x[:8] += 3.0    # the lead member's rows differ from the rest
        batch = {"data": x, "softmax_label": y}
        jh = np.asarray(jt.step(batch)[0])
        th = tt.step(batch)[0].numpy()
        one.step(batch)
        np.testing.assert_allclose(th, jh, atol=HEAD_ATOL)
        _assert_pair(jt, tt, f"step {step}")
    np.testing.assert_allclose(tt._aux["kl1_avg"].numpy(),
                               one._aux["kl1_avg"].numpy(),
                               rtol=SELF_RTOL, atol=SELF_ATOL)
    for i in range(1, 4):
        assert torch.equal(tt._member_aux(i)["kl1_avg"], tt._aux["kl1_avg"])


def _combining_net(S, case):
    """A small net whose op ``case`` combines or moves rows of the
    batch."""
    x = S.FullyConnected(data=S.Variable("data"), name="fc1", num_hidden=8)
    if case in ("sum", "max", "min", "norm"):
        return S.MakeLoss(data=getattr(S, case)(x), name="loss")
    if case in ("sum_axis", "max_axis", "min_axis"):
        return S.MakeLoss(data=getattr(S, case)(x, axis=0), name="loss")
    if case == "softmax_cross_entropy":
        return S.MakeLoss(data=S.softmax_cross_entropy(
            x, S.Variable("label")), name="loss")
    if case == "scaled":
        # rows divided by the global batch's max: a row-split head over
        # a global reduction
        x = S.Activation(data=x, act_type="sigmoid")
        return S.MakeLoss(data=S.broadcast_div(x, S.max(x)), name="loss")
    if case == "transpose":
        x = S.transpose(x)
    elif case == "reshape":
        x = S.Reshape(x, shape=(4, -1))
    elif case == "concat":
        x = S.Concat(x, x, dim=0)
    elif case == "slice_axis":
        x = S.slice_axis(x, axis=-2, begin=0, end=4)
    return S.MakeLoss(data=x, name="loss")


@pytest.mark.parametrize("case", ["transpose", "reshape", "concat",
                                  "slice_axis"])
def test_implicit_refuses_ops_that_combine_rows(case):
    """An op that moves rows of the batch (a transpose or reshape of the
    rows, a concat or slice along them) has no member-by-member form: the
    implicit mode refuses it over several members (the JAX trainer
    computes it over the global batch), binds it over one, and the
    explicit mode, whose shards are local in the JAX package too, binds
    it over two.  Reductions over the rows are computed:
    :func:`test_implicit_reductions_match_jax`."""
    with mxt.name.NameManager():
        sym = _combining_net(mxt.sym, case)
    shapes = {"data": (8, 6)}
    op = {"reshape": "Reshape", "concat": "Concat"}.get(case, case)
    with pytest.raises(MXNetError, match="not ported") as err:
        ShardedTrainer(sym, "sgd", mesh=tmesh(2)).bind(shapes)
    assert f"implicit mode: op {op} " in str(err.value)
    ShardedTrainer(sym, "sgd", mesh=tmesh(1)).bind(shapes)
    ShardedTrainer(sym, "sgd", mesh=tmesh(2),
                   grad_compression="int8").bind(shapes)


REDUCTIONS = ["sum", "max", "min", "norm", "softmax_cross_entropy",
              "sum_axis", "max_axis", "min_axis", "scaled"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", REDUCTIONS)
def test_implicit_reductions_match_jax(case, n):
    """A reduction over the rows of the batch (whole-array, or over axis
    0) in the implicit mode over n members against the JAX trainer over
    n virtual devices: sums from partial sums, a norm from summed
    squares, a max or min from the members' extremes with the gradient
    split over the global batch's tied winners (the batch's first rows
    repeat its last, so the maxima tie across members), and a head of
    rows scaled by the global max.  Three SGD steps: heads rtol 1e-5 /
    atol 1e-5, parameters rtol 1e-4 / atol 1e-6."""
    with mx.name.NameManager(), mxt.name.NameManager():
        jsym, tsym = _combining_net(mx.sym, case), _combining_net(mxt.sym,
                                                                  case)
    shapes = {"data": (8, 6)}
    labels = ({"label": (8,)} if case == "softmax_cross_entropy" else None)
    arg_shapes, _, _ = tsym.infer_shape(**shapes, **(labels or {}))
    rs = np.random.RandomState(1)
    args = {k: (0.3 * rs.randn(*s)).astype(np.float32)
            for k, s in zip(tsym.list_arguments(), arg_shapes)
            if k not in ("data", "label")}
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    jt = JaxTrainer(jsym, optimizer="sgd", optimizer_params=dict(opt),
                    mesh=jmesh(n))
    jt.bind(shapes, labels,
            arg_params={k: jnp.asarray(v) for k, v in args.items()})
    tt = ShardedTrainer(tsym, "sgd", dict(opt), mesh=tmesh(n))
    tt.bind(shapes, labels, arg_params=args)
    for step in range(3):
        x = rs.randn(8, 6).astype(np.float32)
        x[:2] = x[-2:]
        batch = {"data": x}
        if labels:
            batch["label"] = rs.randint(0, 8, 8).astype(np.float32)
        jh = np.asarray(jt.step(batch)[0])
        th = tt.step(batch)[0].numpy()
        assert th.shape == jh.shape
        np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {step}")
    _assert_pair(jt, tt, case)


def test_fit_over_mesh_matches_jax(caplog):
    """``fit`` (the fused accuracy carry, the prefetcher splitting each
    batch over 4 members) against the JAX trainer's ``fit`` on 4
    devices: parameters to rtol 1e-4 / atol 1e-6 and the same epoch
    accuracy lines."""
    jsym, tsym = _build(mx.sym, bn=True), _build(mxt.sym, bn=True)
    args, aux = _state(tsym, 16)
    x, y = _toy_batch(64, seed=6)
    jt = _jax_trainer(jsym, 4, 16, args, aux)
    tt = _port_trainer(tsym, 4, batch=16, args=args, aux=aux)
    with caplog.at_level(logging.INFO):
        jt.fit(mx.io.NDArrayIter(x, y, batch_size=16), num_epoch=2)
        jlines = [r.getMessage() for r in caplog.records
                  if "Mesh-Train" in r.getMessage()]
        caplog.clear()
        tt.fit(mxt.io.NDArrayIter(x, y, batch_size=16), num_epoch=2)
        tlines = [r.getMessage() for r in caplog.records
                  if "Mesh-Train" in r.getMessage()]
    assert tlines == jlines and len(tlines) == 2
    _assert_pair(jt, tt, "fit")


def test_place_batch_splits_microbatches_as_jax():
    """Member i holds rows ``[:, i]`` of the batch viewed as
    ``[grad_accum, members, rows]``: each microbatch is split over the
    members as the JAX trainer shards it."""
    sym = _build(mxt.sym)
    tr = _port_trainer(sym, 4, batch=32, grad_accum=2)
    x = np.arange(32 * 8, dtype=np.float32).reshape(32, 8)
    placed = tr.place_batch({"data": x, "softmax_label": np.zeros(32)})
    for i, shard in enumerate(placed.shards):
        rows = x.reshape(2, 4, 4, 8)[:, i].reshape(8, 8)
        np.testing.assert_array_equal(shard["data"].numpy(), rows)


# ---------------------------------------------------------------------------
# meshes, placements, fingerprints, what still raises
# ---------------------------------------------------------------------------

def test_mesh_scope_and_shardings():
    mesh = make_mesh({"data": 4}, cpus(4))
    assert tpar.current_mesh() is None
    with tpar.default_mesh(mesh):
        assert tpar.current_mesh() is mesh
    assert tpar.current_mesh() is None
    v = np.arange(24, dtype=np.float32).reshape(8, 3)
    pieces = tpar.batch_sharding(mesh).place(v)
    assert [tuple(p.shape) for p in pieces] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(pieces).numpy(), v)
    rep = tpar.replicated(mesh).place(v)
    assert all(np.array_equal(p.numpy(), v) for p in rep)
    spec = tpar.PartitionSpec(None, "data")
    sh = tpar.param_sharding(mesh, spec)
    assert sh.shard_shape((3, 8)) == (3, 2)
    assert data_parallel_mesh(8, device_type="cpu").members == cpus(8)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_mesh_fingerprint_matches_jax(n):
    """The program key's mesh field: the JAX package's string for a mesh
    of n CPU contexts and one of n CPU devices."""
    assert (tcc.mesh_fingerprint(tmesh(n))
            == jcc.mesh_fingerprint(jmesh(n)))
    assert tcc.mesh_fingerprint(tmesh(n)) != tcc.mesh_fingerprint(None)


def test_unported_parts_still_raise():
    sym = _build(mxt.sym)
    # tensor, sequence, expert and pipeline parallelism are ported
    # (tests/test_torch_{tensor_parallel,ring,moe,pipeline*}.py): a seq
    # mesh takes the trainer, moe_ffn runs, and a pipe axis takes the
    # trainer as the JAX trainer does (parameters replicated along it,
    # the batch split over data): heads and parameters after 2 steps
    tr = ShardedTrainer(sym, mesh=make_mesh({"data": 2, "seq": 2}, cpus(4)))
    assert tr._dup_axes == ["seq"]
    bsym, jbsym = _build(mxt.sym, bn=True), _build(mx.sym, bn=True)
    args, aux = _state(bsym, 16)
    jt = JaxTrainer(jbsym, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                    mesh=jmake_mesh({"data": 2, "pipe": 2},
                                    jax.devices()[:4]))
    jt.bind({"data": (16, 8)}, {"softmax_label": (16,)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()},
            aux_params={k: jnp.asarray(v) for k, v in aux.items()})
    tt = ShardedTrainer(bsym, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                        mesh=make_mesh({"data": 2, "pipe": 2}, cpus(4)))
    tt.bind({"data": (16, 8)}, {"softmax_label": (16,)}, arg_params=args,
            aux_params=aux)
    assert tt._dup_axes == ["pipe"]
    for step in range(2):
        x, y = _toy_batch(16, seed=30 + step)
        jh = np.asarray(jt.step({"data": x, "softmax_label": y})[0])
        th = tt.step({"data": x, "softmax_label": y})[0].numpy()
        np.testing.assert_allclose(th, jh, atol=HEAD_ATOL)
    _assert_pair(jt, tt, "data x pipe")
    rng = np.random.RandomState(0)
    ins = [rng.randn(*s).astype(np.float32)
           for s in ((6, 3), (3, 2), (2, 3, 4), (2, 4), (2, 4, 3), (2, 3))]
    y, _ = tpar.moe_ffn(*map(torch.from_numpy, ins))
    jy, _ = mx.parallel.moe_ffn(*map(jnp.asarray, ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(MXNetError, match="not ported"):
        tpar.ElasticTrainer()
    with pytest.raises(MXNetError, match="launch"):
        mxt.kvstore.create("dist_sync")   # needs a launched cluster
    assert set(mx.parallel.__all__) <= set(tpar.__all__)


def test_lm_over_mesh_matches_jax():
    """The transformer LM (vocab 61, 2 layers, d 32, 2 heads, seq 128,
    blocks of 64, the loss head) over 2 members against the JAX trainer
    over 2 devices: each member's attention takes the flash family (the
    kernels' plain versions on the CPU); per-token losses rtol 1e-4,
    parameters rtol 1e-4 / atol 1e-6 after 3 SGD steps."""
    from mxnet_tpu import models as jmodels
    from mxnet_tpu_torch import models as tmodels
    tra = sys.modules["mxnet_tpu_torch.parallel.ring_attention"]
    kw = dict(vocab_size=61, num_layers=2, d_model=32, heads=2,
              batch_size=2, seq_len=128, loss_head=True, attn_block_size=64)
    with mx.name.NameManager(), mxt.name.NameManager():
        jsym = jmodels.get_symbol("transformer-lm", **kw)
        tsym = tmodels.get_symbol("transformer-lm", **kw)
    shapes = ({"data": (2, 128)}, {"softmax_label": (2, 128)})
    arg_shapes, _, _ = tsym.infer_shape(data=(2, 128),
                                        softmax_label=(2, 128))
    rs = np.random.RandomState(0)
    args = {n: ((1.0 + 0.1 * rs.randn(*s)) if n.endswith("_gamma")
                else 0.1 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    opt = {"learning_rate": 0.01, "momentum": 0.9}
    jt = JaxTrainer(jsym, optimizer="sgd", optimizer_params=dict(opt),
                    mesh=jmesh(2))
    jt.bind(*shapes, arg_params={k: jnp.asarray(v) for k, v in args.items()})
    tt = ShardedTrainer(tsym, "sgd", dict(opt), mesh=tmesh(2))
    tt.bind(*shapes, arg_params=args)
    for step in range(3):
        toks = rs.randint(0, 61, (2, 129))
        batch = {"data": toks[:, :-1].astype(np.float32),
                 "softmax_label": toks[:, 1:].astype(np.float32)}
        dense0 = tra.local_attention.dense_calls
        jh = np.asarray(jt.step(batch)[0])
        th = tt.step(batch)[0].numpy()
        assert tra.local_attention.dense_calls == dense0
        np.testing.assert_allclose(th, jh, rtol=1e-4, err_msg=f"{step}")
    _assert_pair(jt, tt, "LM")


def test_compile_over_several_members_runs_eagerly():
    """``compile()`` over two members records the eager reason (one graph
    a device is not captured) and its steps equal an uncompiled twin's
    bit for bit."""
    sym = _build(mxt.sym, bn=True)
    args, aux = _state(sym, 32)
    a = _port_trainer(sym, 2, args=args, aux=aux)
    b = _port_trainer(sym, 2, args=args, aux=aux)
    infos = a.compile(programs=("train", "eval"))
    assert [i["kind"] for i in infos] == ["train", "eval"]
    assert all("mesh path" in i.get("reason", "") for i in infos)
    for step in range(2):
        x, y = _toy_batch(32, seed=60 + step)
        ha = a.step({"data": x, "softmax_label": y})[0]
        hb = b.step({"data": x, "softmax_label": y})[0]
        assert torch.equal(ha, hb)
    for n, p in a._params.items():
        assert torch.equal(p, b._params[n]), n


def test_recompute_scope_with_a_batch_statistic_refuses_over_members():
    """The implicit mode's members meet at a cross-row statistic in the
    forward; a recompute scope holding a BatchNorm (and a normalized
    loss), replayed in the backward on one thread, reuses the global
    statistics its forward met with instead of meeting again: over 2 and
    4 members its steps equal the same steps without the scope, bit for
    bit (heads, parameters, moving statistics), and the one-member
    trainer's within the dp tolerance (rtol 2e-5, atol 2e-6)."""
    from mxnet_tpu_torch.attribute import AttrScope
    S = mxt.sym

    def build(remat):
        with mxt.name.NameManager():
            net = S.Variable("data")
            with AttrScope(remat_scope="block0") if remat \
                    else AttrScope():
                net = S.FullyConnected(data=net, num_hidden=16, name="fc1")
                net = S.BatchNorm(data=net, name="bn1", fix_gamma=False)
                net = S.Activation(data=net, act_type="relu")
            net = S.FullyConnected(data=net, num_hidden=4, name="fc2")
            return S.SoftmaxOutput(data=net, name="softmax",
                                   normalization="batch")

    x, y = _toy_batch(8, seed=3)
    runs = {}
    for n in (1, 2, 4):
        for remat in (True, False):
            tr = _port_trainer(build(remat), n, batch=8)
            heads = [tr.step({"data": x, "softmax_label": y})[0]
                     for _ in range(2)]
            runs[n, remat] = (heads, tr.get_params())
    for n in (2, 4):
        (ha, (pa, aa)), (hb, (pb, ab)) = runs[n, True], runs[n, False]
        assert all(torch.equal(a, b) for a, b in zip(ha, hb))
        for k in pa:
            np.testing.assert_array_equal(pa[k].asnumpy(), pb[k].asnumpy())
        for k in aa:
            np.testing.assert_array_equal(aa[k].asnumpy(), ab[k].asnumpy())
        for k, v in runs[1, True][1][0].items():
            np.testing.assert_allclose(pa[k].asnumpy(), v.asnumpy(),
                                       rtol=SELF_RTOL, atol=SELF_ATOL)
