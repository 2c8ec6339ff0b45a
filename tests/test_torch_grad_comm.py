"""Bucketed, prioritised and compressed gradient reduction of the PyTorch
port (``parallel.collectives``, ``kvstore``, ``ShardedTrainer``'s
explicit mode and error feedback) against the JAX package's
``tests/test_grad_comm.py`` and the error-feedback cases of
``tests/test_quant.py``, and against the JAX functions themselves.

Members are CPU contexts (``cpu(0)`` ... ``cpu(7)``): distinct, so they
take the bucketed branch the cards take through NCCL, with a copy as the
transport.  Tolerances:

* integer-valued f32 reductions: exact; the int8 wire: the JAX test's
  analytic bound (``n * scale / 2``, scale = global absmax / 127);
* ``psum_compressed`` against the JAX function on the same inputs
  (int8 and fp8, with and without residuals, over 2, 4 and 8 members):
  bitwise (division by the shared scale, round half to even, exact
  integer or e4m3 sums);
* the explicit-mode trainer against the JAX trainer: heads atol 1e-5;
  parameters rtol 1e-4, atol 1e-6 for bf16 and int8 without feedback,
  and for int8 with feedback atol 2e-5 (a gradient the two packages
  round 1 ulp apart may fall on the other side of a quantization step:
  one step of a 128-element block is absmax / 127 times the learning
  rate and the 1/batch rescale);
* the port's fused update against its unfused update: bitwise.
"""
import logging
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu._compat import shard_map
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import collectives as jcoll
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.parallel import (ShardedTrainer, allreduce_sum,
                                      make_mesh)
from mxnet_tpu_torch.parallel.collectives import (count_collectives,
                                                  plan_buckets,
                                                  psum_compressed)

HEAD_ATOL = 1e-5
RTOL, ATOL = 1e-4, 1e-6
EF_ATOL = 2e-5


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


def cpus(n=8):
    return [mxt.cpu(i) for i in range(n)]


def _nd(v, ctx, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(v))
    return mxt.nd.NDArray(t if dtype is None else t.to(dtype), ctx=ctx)


def _mixed_groups(shapes, n=8, seed=0, dtype=np.float32, lo=-4, hi=5):
    """One group per shape: one integer-valued tensor a member (integer
    values keep f32 sums exact)."""
    rs = np.random.RandomState(seed)
    groups = []
    for shape in shapes:
        vals = [rs.randint(lo, hi, size=shape).astype(dtype)
                for _ in range(n)]
        groups.append([_nd(v, c) for v, c in zip(vals, cpus(n))])
    return groups


MIXED_SHAPES = [(64, 32), (32,), (3, 3, 8, 16), (1,), (128, 64), (17,),
                (5, 7), (256,), (33, 9), (2, 2, 2), (100,), (64,),
                (12, 31), (8, 8, 8), (3,), (999,), (48, 16), (7,),
                (21, 5), (1, 1), (513,), (40, 10)]


# ---------------------------------------------------------------------------
# tests/test_grad_comm.py, mirrored
# ---------------------------------------------------------------------------

def test_plan_buckets_exact_ceiling():
    counts = [int(np.prod(s)) for s in MIXED_SHAPES]
    for bucket_bytes in (512, 4096, 1 << 20):
        plan = plan_buckets(counts, 4, bucket_bytes)
        per_bucket = max(1, bucket_bytes // 4)
        assert len(plan) == math.ceil(sum(counts) / per_bucket)
        seen = {i: 0 for i in range(len(counts))}
        for bucket in plan:
            for idx, start, stop in bucket:
                assert start == seen[idx]
                seen[idx] = stop
        assert all(seen[i] == c for i, c in enumerate(counts))
        assert plan == jcoll.plan_buckets(counts, 4, bucket_bytes)


def test_bucketed_f32_bit_identical_and_collective_count():
    """>= 20 mixed-shape f32 gradients through small buckets dispatch
    <= ceil(total_bytes / bucket_bytes) reductions, and the values are
    bit-identical to per-tensor reductions."""
    groups = _mixed_groups(MIXED_SHAPES)
    bucket_bytes = 4096
    total_bytes = sum(int(np.prod(s)) * 4 for s in MIXED_SHAPES)
    with count_collectives() as stats:
        fused = allreduce_sum(groups, bucket_bytes=bucket_bytes)
    assert stats.count <= math.ceil(total_bytes / bucket_bytes)
    assert stats.total_bytes == total_bytes
    ref = [allreduce_sum(g) for g in groups]
    for f_group, r_group, shape in zip(fused, ref, MIXED_SHAPES):
        for f, r in zip(f_group, r_group):
            assert f.shape == tuple(shape)
            np.testing.assert_array_equal(f.asnumpy(), r.asnumpy())


def test_bucketed_results_land_on_their_devices():
    groups = _mixed_groups([(16, 4), (9,)], seed=2)
    out = allreduce_sum(groups, bucket_bytes=128)
    for g in out:
        for o, c in zip(g, cpus()):
            assert o.context == c


def test_priority_orders_dispatch():
    """Higher priority, earlier bucket; ties keep submission order."""
    groups = _mixed_groups([(8,)] * 6, n=2, seed=3)
    priorities = [0, 5, 5, -1, 9, 0]
    with count_collectives() as stats:
        allreduce_sum(groups, priorities=priorities, bucket_bytes=32)
    dispatched = [idx for r in stats.records for idx in r["tensor_indices"]]
    assert dispatched == [4, 1, 2, 0, 5, 3]


def test_int8_within_analytic_bound():
    n = 8
    rs = np.random.RandomState(7)
    vals = [rs.randn(64, 32).astype(np.float32) for _ in range(n)]
    groups = [[_nd(v, c) for v, c in zip(vals, cpus(n))]]
    out = allreduce_sum(groups, compression="int8")[0][0].asnumpy()
    exact = np.sum(vals, axis=0)
    scale = max(np.abs(v).max() for v in vals) / 127.0
    assert np.abs(out - exact).max() <= n * scale / 2 + 1e-6
    small = _mixed_groups([(32,)], seed=8, lo=-40, hi=41)
    exact_small = allreduce_sum(small)[0][0].asnumpy()
    q_small = allreduce_sum(small, compression="int8")[0][0].asnumpy()
    np.testing.assert_allclose(q_small, exact_small, atol=n * 0.5)


def test_bf16_compression_roundtrip():
    groups = _mixed_groups([(16, 8)], seed=9, lo=-8, hi=9)
    exact = allreduce_sum(groups)[0][0].asnumpy()
    out = allreduce_sum(groups, compression="bf16")[0][0].asnumpy()
    np.testing.assert_array_equal(out, exact)


def test_mixed_dtypes_and_zero_size():
    """f32 + bf16 + int32 + a zero-size tensor in one call: dtype classes
    bucket separately, non-floats skip quantization, empties pass
    through."""
    n = 4
    rs = np.random.RandomState(11)
    specs = [((8, 3), torch.float32), ((7,), torch.bfloat16),
             ((5, 2), torch.int32), ((0,), torch.float32),
             ((33,), torch.float32)]
    groups = []
    for shape, dtype in specs:
        vals = [rs.randint(-3, 4, size=shape) for _ in range(n)]
        groups.append([_nd(v, c, dtype) for v, c in zip(vals, cpus(n))])
    int8_atol = n * (3.0 / 127.0) / 2 + 1e-6
    for compression in (None, "int8", "bf16"):
        out = allreduce_sum(groups, compression=compression,
                            bucket_bytes=64)
        for g_in, g_out, (shape, dtype) in zip(groups, out, specs):
            expect = np.sum([a.data.double().numpy() for a in g_in], axis=0)
            lossy = compression == "int8" and dtype.is_floating_point
            for o in g_out:
                assert o.shape == tuple(shape) and o.data.dtype == dtype
                got = o.data.double().numpy()
                if lossy:
                    np.testing.assert_allclose(got, expect, atol=int8_atol)
                else:
                    np.testing.assert_array_equal(got, expect)


def test_unknown_compression_rejected():
    with pytest.raises(MXNetError):
        allreduce_sum([torch.ones(3)], compression="fp4")
    with pytest.raises(MXNetError):
        mxt.kvstore.create("local", compression="fp4")


def test_kvstore_bucketed_push_fuses_collectives():
    """Small pushes flush as fused buckets with exact sums."""
    kv = mxt.kvstore.create("local", bucket_bytes=4096)
    assert kv.compression is None
    shapes = {1: (3, 2), 2: (17,), 3: (5, 5)}
    with mxt.cpu():
        for k, shape in shapes.items():
            kv.init(k, mxt.nd.zeros(shape))
        with count_collectives() as stats:
            for k, shape in shapes.items():
                kv.push(k, [_nd(np.full(shape, i + 1, np.float32), c)
                            for i, c in enumerate(cpus(4))])
            out = mxt.nd.zeros(shapes[3])
            kv.pull(3, out=out)
        np.testing.assert_array_equal(out.asnumpy(), 10.0)
        total = sum(int(np.prod(s)) * 4 for s in shapes.values())
        assert stats.count <= math.ceil(total / 4096)
        for k, shape in list(shapes.items())[:2]:
            out = mxt.nd.zeros(shape)
            kv.pull(k, out=out)
            np.testing.assert_array_equal(out.asnumpy(), 10.0)


def test_kvstore_int8_compression_smoke():
    kv = mxt.kvstore.create("local", compression="int8")
    assert kv.compression == "int8"
    shape = (6, 4)
    with mxt.cpu():
        kv.init(9, mxt.nd.zeros(shape))
        kv.push(9, [_nd(np.full(shape, i + 1, np.float32), c)
                    for i, c in enumerate(cpus(4))])
        out = mxt.nd.zeros(shape)
        kv.pull(9, out=out)
    np.testing.assert_allclose(out.asnumpy(), 10.0, atol=4 * 0.5)


def test_kvstore_priority_flush_order():
    kv = mxt.kvstore.create("local")
    with mxt.cpu():
        for k in (1, 2, 3):
            kv.init(k, mxt.nd.zeros((4,)))
        with count_collectives() as stats:
            for k, pr in ((1, 0), (2, 10), (3, 5)):
                kv.push(k, [_nd(np.full((4,), i + 1, np.float32), c)
                            for i, c in enumerate(cpus(2))], priority=pr)
            kv.barrier()
    order = [i for r in stats.records for i in r["tensor_indices"]]
    assert order == [1, 2, 0]


def _mlp(S):
    data = S.Variable("data")
    fc1 = S.FullyConnected(data=data, name="fc1", num_hidden=16)
    act = S.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = S.FullyConnected(data=act, name="fc2", num_hidden=4)
    return S.SoftmaxOutput(data=fc2, name="softmax")


def _sym(S=None):
    with mx.name.NameManager(), mxt.name.NameManager():
        return _mlp(S or mxt.sym)


def _toy_batch(n=32, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    w = rs.randn(8, 4).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    return x, y


def _mesh(n=8):
    return make_mesh({"data": n}, cpus(n))


def _fit_acc(grad_compression):
    x, y = _toy_batch(256, seed=3)
    tr = ShardedTrainer(_sym(), "sgd", {"learning_rate": 0.3,
                                        "momentum": 0.9},
                        mesh=_mesh(), grad_compression=grad_compression,
                        seed=5)
    assert tr.grad_compression == grad_compression
    tr.bind({"data": (64, 8)}, {"softmax_label": (64,)})
    tr.fit(mxt.io.NDArrayIter(x, y, batch_size=64, shuffle=False),
           num_epoch=10)
    return tr.score(mxt.io.NDArrayIter(x, y, batch_size=64),
                    "acc").get()[1]


def test_trainer_default_is_uncompressed():
    tr = ShardedTrainer(_sym(), "sgd", mesh=_mesh())
    assert tr.grad_compression is None


def test_trainer_int8_grads_converge():
    acc_f32 = _fit_acc(None)
    acc_int8 = _fit_acc("int8")
    assert acc_f32 > 0.7 and acc_int8 > 0.7
    assert acc_int8 >= acc_f32 - 0.05


def test_trainer_bf16_grads_match_closely():
    x, y = _toy_batch(32)

    def run(grad_compression):
        tr = ShardedTrainer(_sym(), "sgd", {"learning_rate": 0.1},
                            mesh=_mesh(), grad_compression=grad_compression,
                            seed=7)
        tr.bind({"data": (32, 8)}, {"softmax_label": (32,)})
        for _ in range(3):
            tr.step({"data": x, "softmax_label": y})
        return tr.get_params()[0]

    ref, bf = run(None), run("bf16")
    for n in ref:
        np.testing.assert_allclose(ref[n].asnumpy(), bf[n].asnumpy(),
                                   rtol=0.05, atol=5e-3)


def test_trainer_compression_requires_data_axis():
    with pytest.raises(MXNetError):
        ShardedTrainer(_sym(), "sgd", mesh=make_mesh({"model": -1}, cpus()),
                       grad_compression="int8")


# ---------------------------------------------------------------------------
# psum_compressed against the JAX function
# ---------------------------------------------------------------------------

def _jax_psum(xs, compression, residuals=None):
    n = len(xs)
    mesh = jmake_mesh({"d": n}, jax.devices()[:n])
    x = jnp.asarray(np.stack(xs))
    if residuals is None:
        f = shard_map(lambda v: jcoll.psum_compressed(v[0], "d",
                                                      compression)[None],
                      mesh=mesh, in_specs=JP("d"), out_specs=JP("d"))
        return np.asarray(jax.jit(f)(x)), None

    def body(v, r):
        red, nres = jcoll.psum_compressed(v[0], "d", compression,
                                          residual=r[0])
        return red[None], nres[None]
    f = shard_map(body, mesh=mesh, in_specs=(JP("d"), JP("d")),
                  out_specs=(JP("d"), JP("d")))
    red, nres = jax.jit(f)(x, jnp.asarray(np.stack(residuals)))
    return np.asarray(red), np.asarray(nres)


@pytest.mark.parametrize("compression", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("feedback", [False, True])
def test_psum_compressed_bitwise_jax(compression, n, feedback):
    """The same inputs (a tail that is not a whole block, an outlier in
    one member's block) through the port's ``psum_compressed`` over n
    members and the JAX function over n devices: bitwise the same sums
    and, with residuals, the same new residuals."""
    rs = np.random.RandomState(n)
    xs = [rs.randn(300).astype(np.float32) for _ in range(n)]
    xs[0][17] = 40.0
    res = ([(0.01 * rs.randn(300)).astype(np.float32) for _ in range(n)]
           if feedback else None)
    jred, jres = _jax_psum(xs, compression, res)
    out = psum_compressed([torch.from_numpy(x) for x in xs], compression,
                          residuals=(None if res is None else
                                     [torch.from_numpy(r) for r in res]))
    reds, nres = out if feedback else (out, None)
    for i in range(n):
        np.testing.assert_array_equal(reds[i].numpy().view(np.uint32),
                                      jred[i].view(np.uint32))
        if feedback:
            np.testing.assert_array_equal(nres[i].numpy().view(np.uint32),
                                          jres[i].view(np.uint32))


@pytest.mark.parametrize("compression", ["int8", "fp8"])
@pytest.mark.parametrize("n", [2, 8])
def test_allreduce_compressed_bitwise_jax(compression, n):
    """The bucketed ``allreduce_sum`` of the two packages over n members
    on the same random f32 gradients: bitwise the same results."""
    rs = np.random.RandomState(20 + n)
    shapes = [(40, 9), (77,), (3, 5, 7)]
    vals = [[rs.randn(*s).astype(np.float32) for _ in range(n)]
            for s in shapes]
    tout = allreduce_sum([[_nd(v, c) for v, c in zip(g, cpus(n))]
                          for g in vals], compression=compression,
                         bucket_bytes=1024)
    jout = jcoll.allreduce_sum(
        [[jax.device_put(jnp.asarray(v), d)
          for v, d in zip(g, jax.devices()[:n])] for g in vals],
        compression=compression, bucket_bytes=1024)
    for tg, jg in zip(tout, jout):
        np.testing.assert_array_equal(
            tg[0].asnumpy().view(np.uint32),
            np.asarray(jg[0]).view(np.uint32))


# ---------------------------------------------------------------------------
# the explicit mode against the JAX trainer
# ---------------------------------------------------------------------------

def _init(sym, batch=32, seed=4):
    shapes, _, _ = sym.infer_shape(data=(batch, 8), softmax_label=(batch,))
    rs = np.random.RandomState(seed)
    return {n: (0.3 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _pair(compression, ef, fused, n, bn=False):
    def build(S):
        net = S.Variable("data")
        if bn:
            net = S.BatchNorm(data=net, name="bn1", fix_gamma=False)
        return _mlp_on(S, net)
    with mx.name.NameManager(), mxt.name.NameManager():
        jsym, tsym = build(mx.sym), build(mxt.sym)
    args = _init(tsym)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jt = JaxTrainer(jsym, optimizer="sgd", optimizer_params=dict(opt),
                    mesh=jmake_mesh({"data": n}, jax.devices()[:n]),
                    grad_compression=compression, error_feedback=ef,
                    fused_update=fused, grad_bucket_bytes=256)
    jt.bind({"data": (32, 8)}, {"softmax_label": (32,)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()})
    tt = ShardedTrainer(tsym, "sgd", dict(opt), mesh=_mesh(n),
                        grad_compression=compression, error_feedback=ef,
                        fused_update=fused, grad_bucket_bytes=256)
    tt.bind({"data": (32, 8)}, {"softmax_label": (32,)}, arg_params=args)
    if fused:
        # the reduced buckets go to K2's bucket form as they are
        tt._fused_route = "bucket"
    return jt, tt


def _mlp_on(S, net):
    net = S.FullyConnected(data=net, name="fc1", num_hidden=16)
    net = S.Activation(data=net, name="relu1", act_type="relu")
    net = S.FullyConnected(data=net, name="fc2", num_hidden=4)
    return S.SoftmaxOutput(data=net, name="softmax")


@pytest.mark.parametrize("case", ["int8-ef-fused", "int8-ef-unfused",
                                  "int8-fused", "bf16-fused",
                                  "bf16-unfused"])
def test_explicit_trainer_matches_jax(case):
    """The explicit mode over 4 members against the JAX trainer's manual
    region over 4 devices (bucket bytes 256, so the MLP's gradients span
    several buckets and residuals): heads atol 1e-5, parameters and the
    error-feedback residuals within the stated tolerance."""
    comp, *rest = case.split("-")
    ef = "ef" in rest
    fused = "fused" in rest
    jt, tt = _pair(comp, ef if comp == "int8" else None, fused, 4)
    assert tt._fused == jt._fused == fused
    assert tt.error_feedback == jt.error_feedback == ef
    atol = EF_ATOL if ef else ATOL
    for step in range(4):
        x, y = _toy_batch(32, seed=40 + step)
        jh = np.asarray(jt.step({"data": x, "softmax_label": y})[0])
        th = tt.step({"data": x, "softmax_label": y})[0].numpy()
        np.testing.assert_allclose(th, jh, atol=HEAD_ATOL)
    jp, tp = jt.get_params()[0], tt.get_params()[0]
    for n in jp:
        np.testing.assert_allclose(tp[n].asnumpy(), jp[n].asnumpy(),
                                   rtol=RTOL, atol=atol, err_msg=n)
    if ef:
        keys = [k for k in jt._opt_state if k.startswith("efres:")]
        assert len(keys) == len(tt._ef_res[0]) > 1
        for b, k in enumerate(keys):
            want = np.asarray(jt._opt_state[k])
            got = torch.cat([r[b] for r in tt._ef_res]).numpy()
            np.testing.assert_allclose(got, want, atol=1e-3)


def test_explicit_fused_is_bitwise_unfused():
    """With int8 and feedback, the fused update over the reduced buckets
    (K2's bucket form, one launch a bucket) leaves parameters, momentum
    and residuals bitwise those of the unfused update."""
    runs = []
    for fused in (True, False):
        _, tt = _pair("int8", True, fused, 4)
        for step in range(3):
            x, y = _toy_batch(32, seed=50 + step)
            tt.step({"data": x, "softmax_label": y})
        runs.append(tt)
    a, b = runs
    for n, v in a.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(),
                                      b.get_params()[0][n].asnumpy())
    for n, leaves in a.opt_state_by_param().items():
        for x, y in zip(leaves, b.opt_state_by_param()[n]):
            assert torch.equal(x, y), n
    for ra, rb in zip(a._ef_res, b._ef_res):
        for x, y in zip(ra, rb):
            assert torch.equal(x, y)


def test_explicit_batchnorm_statistics_are_per_member():
    """Explicit mode: each member's BatchNorm statistics are its own rows'
    and the moving statistics their mean over members, as in the JAX
    trainer's manual region (rtol 1e-4 / atol 1e-6 against it)."""
    jt, tt = _pair("bf16", None, False, 4, bn=True)
    x, y = _toy_batch(32, seed=8)
    x[:8] += 3.0
    var0 = tt._aux["bn1_moving_var"].clone().numpy()
    jt.step({"data": x, "softmax_label": y})
    tt.step({"data": x, "softmax_label": y})
    jaux = jt.get_params()[1]
    for n, v in tt.get_params()[1].items():
        np.testing.assert_allclose(v.asnumpy(), jaux[n].asnumpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    # the mean of the members' variances, not the whole batch's
    local = np.mean([x[8 * i:8 * i + 8].var(axis=0) for i in range(4)], 0)
    np.testing.assert_allclose(tt._aux["bn1_moving_var"].numpy(),
                               0.9 * var0 + 0.1 * local, rtol=1e-4)
    assert not np.allclose(0.9 * var0 + 0.1 * x.var(axis=0), 0.9 * var0
                           + 0.1 * local, rtol=1e-2)


# ---------------------------------------------------------------------------
# error feedback (tests/test_quant.py)
# ---------------------------------------------------------------------------

def _ef_trainer(grad_compression, error_feedback=None, lr=0.05, **kw):
    tr = ShardedTrainer(_sym(), "sgd", {"learning_rate": lr,
                                        "momentum": 0.9},
                        mesh=_mesh(), grad_compression=grad_compression,
                        error_feedback=error_feedback, seed=9, **kw)
    tr.bind({"data": (32, 8)}, {"softmax_label": (32,)})
    return tr


def _toy_batches(n_steps, seed=3):
    rs = np.random.RandomState(seed)
    w = rs.randn(8, 4).astype(np.float32)
    out = []
    for _ in range(n_steps):
        x = rs.randn(32, 8).astype(np.float32)
        out.append({"data": x, "softmax_label":
                    np.argmax(x @ w, axis=1).astype(np.float32)})
    return out


def _param_vec(tr):
    params = tr.get_params()[0]
    return np.concatenate([params[n].asnumpy().ravel()
                           for n in sorted(params)])


def test_ef_defaults_and_validation(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_QUANT_EF", raising=False)
    assert _ef_trainer("int8").error_feedback is True
    assert _ef_trainer("fp8").error_feedback is True
    assert _ef_trainer("bf16").error_feedback is False
    assert _ef_trainer(None).error_feedback is False
    assert _ef_trainer("int8", error_feedback=False).error_feedback is False
    with pytest.raises(MXNetError):
        ShardedTrainer(_sym(), "sgd", mesh=_mesh(), error_feedback=True)
    monkeypatch.setenv("MXNET_TPU_QUANT_EF", "0")
    assert _ef_trainer("int8").error_feedback is False


def test_ef_grad_accum_falls_back_off(caplog):
    with caplog.at_level(logging.WARNING):
        tr = _ef_trainer("int8", error_feedback=True, grad_accum=2)
    assert tr.error_feedback is False
    assert any("error_feedback" in r.message and "grad_accum" in r.message
               for r in caplog.records)
    assert tr._ef_res == []
    tr.step(_toy_batches(1)[0])
    tr2 = ShardedTrainer(_sym(), "sgd", mesh=_mesh(),
                         grad_compression="int8", grad_accum=2)
    assert tr2.error_feedback is False


def test_efres_state_shape_and_sharding():
    tr = _ef_trainer("int8")
    assert len(tr._ef_res) == 8              # one list a member
    assert [len(r) for r in tr._ef_res] == [1] * 8
    res = tr._ef_res[0][0]
    assert res.dtype == torch.float32 and res.dim() == 1
    assert not torch.any(res)
    assert "opt:efres:0:0" in tr._state_arrays()
    assert tr._state_arrays()["opt:efres:0:0"].shape == (8 * res.numel(),)
    assert _ef_trainer("int8", error_feedback=False)._ef_res == []


def test_error_feedback_beats_plain_int8():
    """With feedback the quantized trajectory stays nearer the exact one
    than without (same seeds and batches, only the residual differs)."""
    batches = _toy_batches(40)
    runs = {}
    for name, (comp, ef) in {"f32": (None, None), "ef": ("int8", True),
                             "plain": ("int8", False)}.items():
        tr = _ef_trainer(comp, error_feedback=ef)
        for b in batches:
            tr.step(b)
        runs[name] = _param_vec(tr)
    drift_ef = np.linalg.norm(runs["ef"] - runs["f32"])
    drift_plain = np.linalg.norm(runs["plain"] - runs["f32"])
    assert drift_ef < drift_plain / 1.5, (drift_ef, drift_plain)


def test_int8_ef_converges_like_f32():
    batches = _toy_batches(8, seed=6)

    def final_acc(comp):
        tr = _ef_trainer(comp, lr=0.2)
        for _ in range(10):
            for b in batches:
                tr.step(b)
        x = np.concatenate([b["data"] for b in batches])
        y = np.concatenate([b["softmax_label"] for b in batches])
        return tr.score(mxt.io.NDArrayIter(x, y, batch_size=32),
                        "acc").get()[1]

    acc_f32 = final_acc(None)
    acc_int8 = final_acc("int8")
    assert acc_f32 > 0.7
    assert acc_int8 >= acc_f32 - 0.05


def test_efres_bitwise_checkpoint_roundtrip(tmp_path):
    batches = _toy_batches(6, seed=8)
    tr = _ef_trainer("int8")
    for b in batches[:3]:
        tr.step(b)
    before = [r[0].clone() for r in tr._ef_res]
    assert any(torch.any(r) for r in before)
    mgr = CheckpointManager(str(tmp_path))
    tr.save_state(mgr, blocking=True)
    tr2 = _ef_trainer("int8")
    tr2.restore_state(mgr)
    for a, b in zip(tr2._ef_res, before):
        assert torch.equal(a[0], b)
    for b in batches[3:]:
        tr.step(b)
        tr2.step(b)
    a, b2 = _param_vec(tr), _param_vec(tr2)
    np.testing.assert_array_equal(a.view(np.uint32), b2.view(np.uint32))
    mgr.close()
