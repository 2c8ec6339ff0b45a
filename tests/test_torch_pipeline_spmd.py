"""``SpmdPipelineTrainer`` and ``schedule_1f1b`` of the PyTorch port
(``parallel/pipeline_spmd.py``) against the JAX package's, its
``tests/test_pipeline_spmd.py``, the port's host-driven
``PipelineTrainer`` and its ``ShardedTrainer``, on the CPU.

The JAX side runs on the virtual CPU devices ``tests/conftest.py`` gives
it; the port's ``(data, pipe)`` meshes are CPU contexts ``cpu(0)`` ...
``cpu(7)``, one member thread a coordinate.  Inputs and parameters are
numpy arrays from a seed.

Tolerances, as stated in each test:

* the timetables and ring depths: exactly the JAX package's;
* f32 steps: ``tests/test_pipeline_spmd.py``'s bounds (heads rtol 2e-5 /
  atol 2e-6, parameters rtol 3e-5 / atol 3e-6, Adam's 1e-4 / 1e-5);
  against the host-driven pipeline at one data member: bitwise (the same
  ops in the same order over the flat buffers);
* bf16 compute against the JAX program: bf16's rtol 2e-2 / atol 2e-2.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import SpmdPipelineTrainer as JSpmd
from mxnet_tpu.parallel.pipeline_spmd import schedule_1f1b as jschedule

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import (PipelineTrainer, ShardedTrainer,
                                      SpmdPipelineTrainer)
from mxnet_tpu_torch.parallel import pipeline_spmd
from mxnet_tpu_torch.parallel.pipeline_spmd import schedule_1f1b

HEAD = dict(rtol=2e-5, atol=2e-6)
PARAM = dict(rtol=3e-5, atol=3e-6)
ADAM = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
OPT = {"learning_rate": 0.5, "momentum": 0.9}


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


def _mlp4(S, widths=(48, 32, 24, 10), grouped=False):
    pkg = mx if S is mx.sym else mxt
    net = S.Variable("data")
    for i, w in enumerate(widths):
        last = i == len(widths) - 1
        with (pkg.AttrScope(ctx_group=f"stage{i}") if grouped
              else pkg.AttrScope()):
            net = S.FullyConnected(data=net, num_hidden=w,
                                   name="fc_out" if last else f"fc{i}")
            if last:
                return S.SoftmaxOutput(data=net, name="softmax")
            net = S.Activation(data=net, act_type="tanh")


def _bn_net(S):
    pkg = mx if S is mx.sym else mxt
    net = S.Variable("data")
    with pkg.AttrScope(ctx_group="s0"):
        net = S.FullyConnected(data=net, num_hidden=16, name="bfc0")
        net = S.BatchNorm(data=net, name="bn0")
        net = S.Activation(data=net, act_type="relu")
    with pkg.AttrScope(ctx_group="s1"):
        net = S.FullyConnected(data=net, num_hidden=10, name="bfc1")
        return S.SoftmaxOutput(data=net, name="softmax")


def _pair(build=_mlp4, **kw):
    with mx.name.NameManager(), mxt.name.NameManager():
        return build(mx.sym, **kw), build(mxt.sym, **kw)


def _init(sym, shapes, seed=5):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.4, 0.4, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _batches(shapes, n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.rand(*shapes["data"]).astype(np.float32),
             "softmax_label": rng.randint(0, 10, shapes["softmax_label"])
             .astype(np.float32)} for _ in range(n)]


def _bind(tr, shapes, args=None, jax_side=False):
    tr.bind(data_shapes={"data": shapes["data"]},
            label_shapes={"softmax_label": shapes["softmax_label"]},
            arg_params=(None if args is None else
                        {k: jnp.asarray(v) for k, v in args.items()}
                        if jax_side else args))
    return tr


def _np(h):
    return h.detach().float().numpy() if isinstance(h, torch.Tensor) \
        else np.asarray(h)


def _assert_params(a, b, tol, what):
    a, b = a.get_params()[0], b.get_params()[0]
    for n in b:
        np.testing.assert_allclose(a[n].asnumpy(), b[n].asnumpy(), **tol,
                                   err_msg=f"{what}: {n}")


# ---------------------------------------------------------------------
# the timetable
# ---------------------------------------------------------------------

@pytest.mark.parametrize("S,M", [(1, 1), (2, 2), (4, 8), (4, 3), (3, 7)])
def test_1f1b_schedule_constraints(S, M):
    fwd, bwd = schedule_1f1b(S, M)
    T = fwd.shape[0]
    F, B = {}, {}
    for t in range(T):
        for s in range(S):
            if fwd[t, s] >= 0:
                F[(s, int(fwd[t, s]))] = t
            if bwd[t, s] >= 0:
                B[(s, int(bwd[t, s]))] = t
    assert set(F) == {(s, j) for s in range(S) for j in range(M)}
    assert set(B) == set(F)
    for s in range(S):
        for j in range(M):
            if s > 0:
                assert F[(s, j)] > F[(s - 1, j)], "activation arrives late"
            if s < S - 1:
                assert B[(s, j)] > B[(s + 1, j)], "cotangent arrives late"
            assert B[(s, j)] >= F[(s, j)]
            live = sum(1 for k in range(M)
                       if F[(s, k)] <= F[(s, j)] < B[(s, k)])
            assert live <= S - s, (s, j, live)


def test_1f1b_tables_and_ring_depth_match_jax():
    """The timetables equal the JAX function's for S 1..4 and M 1..8,
    and so does the ring depth computed from them; the tick counts of
    the JAX test's regression."""
    assert schedule_1f1b(4, 8)[0].shape[0] == 19
    assert schedule_1f1b(2, 2)[0].shape[0] == 4
    for S in range(1, 5):
        for M in range(1, 9):
            fwd, bwd = schedule_1f1b(S, M)
            jfwd, jbwd = jschedule(S, M)
            assert fwd.dtype == jfwd.dtype
            np.testing.assert_array_equal(fwd, jfwd)
            np.testing.assert_array_equal(bwd, jbwd)
            stub = types.SimpleNamespace(num_stages=S, num_microbatches=M,
                                         _fwd_tbl=fwd, _bwd_tbl=bwd)
            assert (SpmdPipelineTrainer._ring_depth(stub)
                    == JSpmd._ring_depth(stub)), (S, M)


# ---------------------------------------------------------------------
# equivalence
# ---------------------------------------------------------------------

def test_spmd_matches_sharded_trainer_and_host_pipeline():
    """4 stages x 4 microbatches over ``{"data": 1, "pipe": 4}``, SGD with
    momentum, 3 steps: bitwise the port's host-driven pipeline, within
    the JAX test's bounds of the port's ShardedTrainer and the JAX
    program."""
    shapes = {"data": (16, 20), "softmax_label": (16,)}
    jsym, sym = _pair()
    args = _init(sym, shapes)
    kw = dict(num_stages=4, num_microbatches=4, optimizer="sgd",
              optimizer_params=OPT)
    spmd = _bind(SpmdPipelineTrainer(sym, devices=cpus(4), **kw), shapes,
                 args)
    host = _bind(PipelineTrainer(sym, devices=cpus(4), **kw), shapes, args)
    jt = _bind(JSpmd(jsym, **kw), shapes, args, jax_side=True)
    ref = _bind(ShardedTrainer(sym, optimizer="sgd", optimizer_params=OPT,
                               device="cpu"), shapes, args)
    for b in _batches(shapes):
        out = spmd.step(b)[0]
        assert torch.equal(out, host.step(b)[0])
        np.testing.assert_allclose(_np(out), _np(ref.step(b)[0]), **HEAD)
        np.testing.assert_allclose(_np(out), _np(jt.step(b)[0]), **HEAD)
    a, h = spmd.get_params()[0], host.get_params()[0]
    for n in h:
        np.testing.assert_array_equal(a[n].asnumpy(), h[n].asnumpy())
    _assert_params(spmd, ref, PARAM, "ShardedTrainer")
    _assert_params(spmd, jt, PARAM, "JAX")


def test_spmd_single_dispatch_per_step():
    """One member run a step (the JAX program's one dispatch):
    ``dispatch_count`` and the calls of ``run_synced`` agree."""
    shapes = {"data": (8, 20), "softmax_label": (8,)}
    _, sym = _pair()
    spmd = _bind(SpmdPipelineTrainer(
        sym, num_stages=4, num_microbatches=4, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1}, devices=cpus(4)), shapes)
    calls = []
    inner = pipeline_spmd.run_synced
    pipeline_spmd.run_synced = \
        lambda *a, **k: (calls.append(1) or inner(*a, **k))
    try:
        for b in _batches(shapes, n=2):
            spmd.step(b)
    finally:
        pipeline_spmd.run_synced = inner
    assert len(calls) == 2, f"{len(calls)} member runs for 2 steps"
    assert spmd.dispatch_count == 2


@pytest.mark.parametrize("build", ["mlp", "batchnorm"])
def test_spmd_dp_times_pp_composition(build):
    """dp 2 x pp 4 over a ``(data, pipe)`` mesh of 8 contexts (the MLP, 4
    microbatches) and dp 2 x pp 2 (the BatchNorm net, 2 microbatches:
    each member's moments over its own 4 rows, aux averaged over data, as
    in the JAX program): 3 steps
    against the JAX program over 8 devices; the MLP also against the
    port's ShardedTrainer."""
    shapes = {"data": (16, 20), "softmax_label": (16,)}
    if build == "mlp":
        jsym, sym = _pair()
        kw = dict(num_stages=4)
    else:
        jsym, sym = _pair(_bn_net)
        kw = dict(num_stages=2, group2stage={"s0": 0, "s1": 1})
    args = _init(sym, shapes)
    kw.update(num_microbatches=4 if build == "mlp" else 2, data_parallel=2,
              optimizer="sgd", optimizer_params=OPT)
    n = kw["num_stages"] * 2
    spmd = _bind(SpmdPipelineTrainer(sym, devices=cpus(n), **kw), shapes,
                 args)
    assert spmd.mesh.shape == {"data": 2, "pipe": kw["num_stages"]}
    assert spmd.mesh.members == cpus(n) and len(spmd._pflat) == n
    jt = _bind(JSpmd(jsym, **kw), shapes, args, jax_side=True)
    for b in _batches(shapes):
        np.testing.assert_allclose(_np(spmd.step(b)[0]), _np(jt.step(b)[0]),
                                   **HEAD)
    _assert_params(spmd, jt, PARAM, "JAX")
    aux, jaux = spmd.get_params()[1], jt.get_params()[1]
    for name in jaux:
        np.testing.assert_allclose(aux[name].asnumpy(), jaux[name].asnumpy(),
                                   **PARAM, err_msg=name)
    if build == "mlp":
        ref = _bind(ShardedTrainer(sym, optimizer="sgd",
                                   optimizer_params=OPT, device="cpu"),
                    shapes, args)
        for b in _batches(shapes):
            ref.step(b)
        _assert_params(spmd, ref, PARAM, "ShardedTrainer")


def test_spmd_ctx_group_stages_and_adam():
    """ctx_group stage pinning and Adam (two state leaves a parameter
    through the flat packing): 2 steps against the JAX program and the
    port's ShardedTrainer."""
    shapes = {"data": (16, 20), "softmax_label": (16,)}
    jsym, sym = _pair(grouped=True)
    args = _init(sym, shapes)
    kw = dict(num_stages=4, num_microbatches=4,
              group2stage={f"stage{i}": i for i in range(4)},
              optimizer="adam", optimizer_params={"learning_rate": 0.01})
    spmd = _bind(SpmdPipelineTrainer(sym, devices=cpus(4), **kw), shapes,
                 args)
    assert [c for c, _ in spmd._state_defs[0].values()] == [2, 2]
    jt = _bind(JSpmd(jsym, **kw), shapes, args, jax_side=True)
    ref = _bind(ShardedTrainer(sym, optimizer="adam",
                               optimizer_params={"learning_rate": 0.01},
                               device="cpu", fused_update=False),
                shapes, args)
    for b in _batches(shapes, n=2):
        out = _np(spmd.step(b)[0])
        np.testing.assert_allclose(out, _np(jt.step(b)[0]), **HEAD)
        np.testing.assert_allclose(out, _np(ref.step(b)[0]), **HEAD)
    _assert_params(spmd, jt, ADAM, "JAX")
    _assert_params(spmd, ref, ADAM, "ShardedTrainer")


def test_spmd_batchnorm_aux_dp1():
    """BatchNorm's moving statistics through the timetable at one data
    member: bitwise the host-driven pipeline (the same microbatch order
    and aux snapshots), within the JAX test's bounds of the JAX
    program."""
    shapes = {"data": (8, 12), "softmax_label": (8,)}
    jsym, sym = _pair(_bn_net)
    args = _init(sym, shapes)
    kw = dict(num_stages=2, num_microbatches=2,
              group2stage={"s0": 0, "s1": 1}, optimizer="sgd",
              optimizer_params={"learning_rate": 0.1})
    spmd = _bind(SpmdPipelineTrainer(sym, devices=cpus(2), **kw), shapes,
                 args)
    host = _bind(PipelineTrainer(sym, devices=cpus(2), **kw), shapes, args)
    jt = _bind(JSpmd(jsym, **kw), shapes, args, jax_side=True)
    for b in _batches(shapes, n=2):
        out = spmd.step(b)[0]
        assert torch.equal(out, host.step(b)[0])
        np.testing.assert_allclose(_np(out), _np(jt.step(b)[0]), **HEAD)
    aux, haux, jaux = (t.get_params()[1] for t in (spmd, host, jt))
    for n in haux:
        np.testing.assert_array_equal(aux[n].asnumpy(), haux[n].asnumpy())
        np.testing.assert_allclose(aux[n].asnumpy(), jaux[n].asnumpy(),
                                   **HEAD, err_msg=n)


def test_spmd_eval_forward():
    """The fill-drain forward (no aux update, moving statistics) against
    the host-driven pipeline's forward and the JAX program's."""
    shapes = {"data": (8, 20), "softmax_label": (8,)}
    jsym, sym = _pair()
    args = _init(sym, shapes)
    kw = dict(num_stages=4, num_microbatches=2, optimizer="sgd",
              optimizer_params={"learning_rate": 0.1})
    spmd = _bind(SpmdPipelineTrainer(sym, devices=cpus(4), **kw), shapes,
                 args)
    host = _bind(PipelineTrainer(sym, devices=cpus(4), **kw), shapes, args)
    jt = _bind(JSpmd(jsym, **kw), shapes, args, jax_side=True)
    b = _batches(shapes, n=1)[0]
    out = spmd.forward(b)[0]
    assert torch.equal(out, host.forward(b)[0])
    np.testing.assert_allclose(_np(out), _np(jt.forward(b)[0]), **HEAD)
    assert spmd.dispatch_count == 1


def test_spmd_amp_and_its_refusals():
    """``compute_dtype="bfloat16"``: boundary tensors travel as f32 and
    the flat buffers stay f32; 2 steps against the JAX program at bf16's
    tolerance.  Repeated contexts are refused (PipelineTrainer's), and
    the per-stage dicts are gone after bind."""
    shapes = {"data": (16, 16), "softmax_label": (16,)}
    jsym, sym = _pair(widths=(32, 24, 16, 4))
    args = _init(sym, shapes, seed=6)
    kw = dict(num_stages=4, num_microbatches=2, optimizer="sgd",
              optimizer_params=OPT, compute_dtype="bfloat16")
    spmd = _bind(SpmdPipelineTrainer(sym, devices=cpus(4), **kw), shapes,
                 args)
    jt = _bind(JSpmd(jsym, **kw), shapes, args, jax_side=True)
    assert {dt for sp in spmd._envspecs for _, _, dt in sp.items} == \
        {torch.bfloat16}
    for b in _batches(shapes, n=2):
        np.testing.assert_allclose(_np(spmd.step(b)[0]), _np(jt.step(b)[0]),
                                   **BF16)
    _assert_params(spmd, jt, BF16, "JAX")
    assert all(p.dtype == torch.float32 for p in spmd._pflat)
    with pytest.raises(RuntimeError, match="dropped after compile"):
        spmd._params
    with pytest.raises(MXNetError, match="distinct contexts"):
        SpmdPipelineTrainer(sym, devices=[mxt.cpu(0)] * 4, **kw)
