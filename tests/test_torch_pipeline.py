"""``pipeline_apply`` of the PyTorch port (``parallel/pipeline.py``) and
``ShardedTrainer`` over a ``pipe`` axis, against the JAX package's
``tests/test_pipeline.py`` and the JAX functions themselves, on the CPU.

The JAX side runs on the virtual CPU devices ``tests/conftest.py`` gives
it; the port's meshes are CPU contexts ``cpu(0)`` ... ``cpu(n-1)`` (one
member thread a stage).  Inputs and parameters are numpy arrays from a
seed.

Tolerances, as stated in each test:

* the GPipe schedule against sequential stage application and against
  the JAX function: ``tests/test_pipeline.py``'s rtol 2e-5 / atol 2e-5;
  gradients: its rtol 5e-5 / atol 5e-5;
* ``ShardedTrainer`` over a pipe axis against the JAX trainer on the
  same mesh: heads atol 1e-5, parameters and moving statistics rtol
  1e-4 / atol 1e-6 (``tests/test_torch_parallel.py``'s bounds).

``tests/test_pipeline.py::test_pipeline_under_jit`` has no counterpart:
the port has no tracing compiler to put ``pipeline_apply`` under.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh, pipeline_apply

SEQ = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)
HEAD_ATOL = 1e-5
PARAM = dict(rtol=1e-4, atol=1e-6)


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


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _jstage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stacked(s=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(s, d, d).astype(np.float32) * 0.4,
            "b": rng.randn(s, d).astype(np.float32) * 0.1}


def _tparams(p, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in p.items()}


def _sequential(params, x, s):
    for i in range(s):
        x = _stage_fn({k: v[i] for k, v in params.items()}, x)
    return x


@pytest.mark.parametrize("num_microbatches", [1, 2, 4])
def test_pipeline_matches_sequential(num_microbatches):
    """Four stages over ``{"pipe": 4}``: the sequential stages and the
    JAX function over 4 virtual devices."""
    params = _stacked()
    x = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    out = pipeline_apply(_stage_fn, _tparams(params), torch.tensor(x),
                         make_mesh({"pipe": 4}, cpus(4)),
                         num_microbatches=num_microbatches)
    ref = _sequential(_tparams(params), torch.tensor(x), 4)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **SEQ)
    jout = jpipeline_apply(
        _jstage_fn, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x), jmake_mesh({"pipe": 4}, jax.devices()[:4]),
        num_microbatches=num_microbatches)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **SEQ)


def test_pipeline_gradients():
    """Gradients into the stacked parameters and into ``x``: the
    sequential stages' and the JAX function's."""
    params = _stacked(seed=2)
    x = np.random.RandomState(3).randn(4, 8).astype(np.float32)
    mesh = make_mesh({"pipe": 4}, cpus(4))
    tp, tx = _tparams(params, True), torch.tensor(x, requires_grad=True)
    (pipeline_apply(_stage_fn, tp, tx, mesh, num_microbatches=2) ** 2).sum() \
        .backward()
    sp, sx = _tparams(params, True), torch.tensor(x, requires_grad=True)
    (_sequential(sp, sx, 4) ** 2).sum().backward()
    jmesh = jmake_mesh({"pipe": 4}, jax.devices()[:4])

    def jloss(p, v):
        return (jpipeline_apply(_jstage_fn, p, v, jmesh,
                                num_microbatches=2) ** 2).sum()

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), sp[k].grad.numpy(),
                                   **GRAD, err_msg=k)
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   **GRAD, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), sx.grad.numpy(), **GRAD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD)


def test_pipeline_over_a_data_by_pipe_mesh_and_its_refusals():
    """A mesh with a data axis beside pipe runs the stages on its first
    pipe group (the JAX program repeats them on every data coordinate);
    a mesh without the axis, a stage count that differs from the axis
    and a batch the microbatches do not divide raise; a mesh of repeated
    contexts cannot be made (several stages on one device are
    PipelineTrainer's)."""
    params = _stacked(s=2, seed=4)
    x = np.random.RandomState(5).randn(6, 8).astype(np.float32)
    out = pipeline_apply(_stage_fn, _tparams(params), torch.tensor(x),
                         make_mesh({"data": 2, "pipe": 2}, cpus(4)),
                         num_microbatches=3)
    ref = _sequential(_tparams(params), torch.tensor(x), 2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **SEQ)
    with pytest.raises(MXNetError, match="no axis 'pipe'"):
        pipeline_apply(_stage_fn, _tparams(params), torch.tensor(x),
                       make_mesh({"data": 2}, cpus(2)), num_microbatches=1)
    with pytest.raises(MXNetError, match="2 stages"):
        pipeline_apply(_stage_fn, _tparams(params), torch.tensor(x),
                       make_mesh({"pipe": 3}, cpus(3)), num_microbatches=1)
    with pytest.raises(MXNetError, match="not divisible"):
        pipeline_apply(_stage_fn, _tparams(params), torch.tensor(x),
                       make_mesh({"pipe": 2}, cpus(2)), num_microbatches=4)
    with pytest.raises(MXNetError, match="distinct"):
        make_mesh({"pipe": 2}, [mxt.cpu(0), mxt.cpu(0)])


def _mlp(S, bn=False):
    net = S.Variable("data")
    if bn:
        net = S.BatchNorm(data=net, name="bn1", fix_gamma=False)
    net = S.FullyConnected(data=net, name="fc1", num_hidden=16)
    net = S.Activation(data=net, name="relu1", act_type="relu")
    net = S.FullyConnected(data=net, name="fc2", num_hidden=4)
    return S.SoftmaxOutput(data=net, name="softmax")


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


def _toy_batch(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    y = np.argmax(x @ rs.randn(8, 4).astype(np.float32), 1).astype(
        np.float32)
    return {"data": x, "softmax_label": y}


@pytest.mark.parametrize("axes,bn,compression", [
    ({"pipe": 2}, True, None),
    ({"pipe": 4}, False, None),
    ({"data": 2, "pipe": 2}, False, "int8"),
])
def test_sharded_trainer_over_a_pipe_axis_matches_jax(axes, bn, compression):
    """``ShardedTrainer`` over a mesh with a pipe axis, as the JAX trainer
    takes it: parameters replicated along the axis, the batch split over
    data where the mesh has it (else every member holds it whole), the
    same step on every member of a pipe group; in the implicit mode and
    in the explicit (int8) one.  Heads and parameters (and BatchNorm's
    moving statistics) after 2 SGD steps against the JAX trainer on the
    same mesh."""
    n = int(np.prod(list(axes.values())))
    with mx.name.NameManager(), mxt.name.NameManager():
        jsym, tsym = _mlp(mx.sym, bn), _mlp(mxt.sym, bn)
    args, aux = _state(tsym, 16)
    kw = {} if compression is None else {"grad_compression": compression}
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jt = JaxTrainer(jsym, optimizer="sgd", optimizer_params=opt,
                    mesh=jmake_mesh(axes, jax.devices()[:n]), **kw)
    jt.bind({"data": (16, 8)}, {"softmax_label": (16,)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()},
            aux_params={k: jnp.asarray(v) for k, v in aux.items()})
    tt = ShardedTrainer(tsym, "sgd", opt, mesh=make_mesh(axes, cpus(n)),
                        **kw)
    tt.bind({"data": (16, 8)}, {"softmax_label": (16,)}, arg_params=args,
            aux_params=aux)
    assert tt._dup_axes == ["pipe"]
    for step in range(2):
        b = _toy_batch(16, 40 + step)
        jh = np.asarray(jt.step(b)[0])
        th = tt.step(b)[0].numpy()
        np.testing.assert_allclose(th, jh, atol=HEAD_ATOL)
    jarg, jaux = jt.get_params()
    targ, taux = tt.get_params()
    for name in jarg:
        np.testing.assert_allclose(targ[name].asnumpy(),
                                   jarg[name].asnumpy(), **PARAM,
                                   err_msg=name)
    for name in jaux:
        np.testing.assert_allclose(taux[name].asnumpy(),
                                   jaux[name].asnumpy(), **PARAM,
                                   err_msg=name)


@pytest.mark.parametrize("axes", [{"pipe": 2, "model": 2},
                                  {"pipe": 2, "seq": 2},
                                  {"pipe": 2, "expert": 2}])
def test_pipe_beside_another_split_axis_refuses_by_name(axes):
    """A pipe axis beside the model, seq or expert axis takes the trainer
    as the JAX trainer takes it: the pipe axis replicates the step, the
    other axis is what it is alone (fc1 cut over the model axis by a
    rule; no op of this net meets along seq or expert, so their members
    replicate the step too).  Heads and parameters (and BatchNorm's
    moving statistics) after 2 SGD steps against the JAX trainer on the
    same mesh."""
    from jax.sharding import PartitionSpec as JP
    from mxnet_tpu.parallel import ShardingRules as JRules
    from mxnet_tpu_torch.parallel import PartitionSpec, ShardingRules
    with mx.name.NameManager(), mxt.name.NameManager():
        jsym, tsym = _mlp(mx.sym, True), _mlp(mxt.sym, True)
    args, aux = _state(tsym, 16)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    rules = [("fc1_weight", ("model", None)), ("fc1_bias", ("model",))]
    model = "model" in axes
    jt = JaxTrainer(jsym, optimizer="sgd", optimizer_params=opt,
                    mesh=jmake_mesh(axes, jax.devices()[:4]),
                    rules=JRules([(p, JP(*s)) for p, s in rules])
                    if model else None)
    jt.bind({"data": (16, 8)}, {"softmax_label": (16,)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()},
            aux_params={k: jnp.asarray(v) for k, v in aux.items()})
    tt = ShardedTrainer(tsym, "sgd", opt, mesh=make_mesh(axes, cpus(4)),
                        rules=ShardingRules([(p, PartitionSpec(*s))
                                             for p, s in rules])
                        if model else None)
    tt.bind({"data": (16, 8)}, {"softmax_label": (16,)}, arg_params=args,
            aux_params=aux)
    assert tt._dup_axes == sorted(a for a in axes if a != "model")
    if model:
        assert tuple(tt._member_params(3)["fc1_weight"].shape) == (8, 8)
    for step in range(2):
        b = _toy_batch(16, 50 + step)
        jh = np.asarray(jt.step(b)[0])
        th = tt.step(b)[0].numpy()
        np.testing.assert_allclose(th, jh, atol=HEAD_ATOL)
    jarg, jaux = jt.get_params()
    targ, taux = tt.get_params()
    for name in jarg:
        np.testing.assert_allclose(targ[name].asnumpy(),
                                   jarg[name].asnumpy(), **PARAM,
                                   err_msg=name)
    for name in jaux:
        np.testing.assert_allclose(taux[name].asnumpy(),
                                   jaux[name].asnumpy(), **PARAM,
                                   err_msg=name)
    assert {"pipeline_apply", "PipelineTrainer",
            "SpmdPipelineTrainer"} <= set(tpar.__all__)
