"""ZeRO optimizer-state sharding in the PyTorch port
(``ShardedTrainer(shard_optimizer=True)`` over a mesh of CPU contexts)
against the JAX package's ``tests/test_zero.py`` and the JAX trainer.

Each member holds the state of its slice of every parameter (cut along
the first dimension the member count divides, else flattened and padded
to a multiple of it), updates that slice, and the slices are gathered.
Tolerances: ZeRO against the replicated path of the port, bitwise (the
JAX test's ``atol=0``: elementwise optimizers give the same bits on a
slice); the port against the JAX trainer, parameters rtol 1e-4, atol
1e-6 (f32 summation order of the gradients); the checkpoint's state
arrays have the JAX trainer's names and global shapes.  The test that
composes ZeRO with Megatron tensor parallelism is in
``tests/test_torch_tensor_parallel.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.parallel import PartitionSpec, ShardedTrainer, make_mesh


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


N = 8
SHAPES = {"data": (16, 32), "softmax_label": (16,)}


def _mlp(S):
    net = S.FullyConnected(data=S.Variable("data"), num_hidden=64,
                           name="fc1")
    net = S.Activation(data=net, act_type="relu")
    net = S.FullyConnected(data=net, num_hidden=10, name="fc2")
    return S.SoftmaxOutput(data=net, name="softmax")


def _syms():
    with mx.name.NameManager(), mxt.name.NameManager():
        return _mlp(mx.sym), _mlp(mxt.sym)


def _init_params(sym, seed=3):
    arg_shapes, _, _ = sym.infer_shape(**SHAPES)
    rng = np.random.RandomState(seed)
    # integer-valued params and data make the cross-path comparison exact
    return {n: rng.randint(-2, 3, size=s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in SHAPES}


def _make(shard_optimizer, arg_params, optimizer="sgd", opt_params=None,
          n=N):
    tr = ShardedTrainer(
        _syms()[1], mesh=make_mesh({"data": n}, [mxt.cpu(i)
                                                 for i in range(n)]),
        optimizer=optimizer,
        optimizer_params=opt_params or {"learning_rate": 0.5,
                                        "momentum": 0.9},
        shard_optimizer=shard_optimizer)
    tr.bind(data_shapes={"data": SHAPES["data"]},
            label_shapes={"softmax_label": SHAPES["softmax_label"]},
            arg_params=arg_params)
    return tr


def _batches(k=3):
    rng = np.random.RandomState(0)
    return [{"data": rng.randint(0, 3, SHAPES["data"]).astype(np.float32),
             "softmax_label": rng.randint(0, 10, (16,)).astype(np.float32)}
            for _ in range(k)]


OPTIMIZERS = [("sgd", {"learning_rate": 0.5, "momentum": 0.9}),
              ("adam", {"learning_rate": 0.1})]


@pytest.mark.parametrize("optimizer,opt_params", OPTIMIZERS)
def test_zero_matches_replicated(optimizer, opt_params):
    arg_params = _init_params(_syms()[1])
    t_rep = _make(False, arg_params, optimizer, opt_params)
    t_zero = _make(True, arg_params, optimizer, opt_params)
    assert not t_zero._fused       # the fused update refuses ZeRO
    for b in _batches():
        t_rep.step(b)
        t_zero.step(b)
    for n in t_rep._params:
        np.testing.assert_allclose(
            t_rep._params[n].detach().numpy(),
            t_zero._params[n].detach().numpy(), rtol=0, atol=0,
            err_msg=f"param {n} diverged between ZeRO and replicated paths")
    for n, leaves in t_rep.opt_state_by_param().items():
        for a, b in zip(leaves, t_zero.opt_state_by_param()[n]):
            assert torch.equal(a, b), n


def test_zero_shards_state_bytes():
    arg_params = _init_params(_syms()[1])
    t_rep = _make(False, arg_params)
    t_zero = _make(True, arg_params)
    rep = t_rep.optimizer_state_bytes_per_device()
    zero = t_zero.optimizer_state_bytes_per_device()
    assert zero < rep, (rep, zero)
    # the big fc1 weight's state: 1/N of it on each member
    for st in t_zero._zero_state:
        leaf = st["fc1_weight"]
        assert leaf.numel() == 64 * 32 // N


def test_zero_indivisible_params_flatten_pad():
    t = _make(True, _init_params(_syms()[1]))
    # fc2_bias (10,) does not divide by 8: flat pad to 16
    assert t._zero_specs["fc2_bias"] == PartitionSpec("data")
    assert t._zero_flat["fc2_bias"] == -(-10 // N) * N
    assert t._zero_flat["fc1_weight"] is None  # dim-sharded, no pad
    for st in t._zero_state:
        assert st["fc2_bias"].shape == (t._zero_flat["fc2_bias"] // N,)


def test_zero_replicated_state_under_5pct():
    t = _make(True, _init_params(_syms()[1]))
    total = sum(leaf.numel() * leaf.element_size() * N
                for st in t._zero_state[:1] for leaf in st.values())
    assert total > 0
    # every state is cut over the members: nothing is held whole
    for n in t._param_names:
        whole = int(np.prod(t._params[n].shape))
        assert t._zero_state[0][n].numel() * N >= whole
        assert t._zero_state[0][n].numel() < whole or whole < N


@pytest.mark.parametrize("optimizer,opt_params", OPTIMIZERS)
def test_zero_matches_jax(optimizer, opt_params):
    """The port's ZeRO trainer against the JAX trainer's over 8 devices:
    its placement plan (specs, padded lengths) and, after three steps,
    its parameters (rtol 1e-4, atol 1e-6) and the checkpoint's optimizer
    arrays (names and global shapes; values to the same tolerance)."""
    jsym, tsym = _syms()
    arg_params = _init_params(tsym)
    jt = JaxTrainer(jsym, mesh=jmake_mesh({"data": N}), optimizer=optimizer,
                    optimizer_params=dict(opt_params), shard_optimizer=True)
    jt.bind(data_shapes={"data": SHAPES["data"]},
            label_shapes={"softmax_label": SHAPES["softmax_label"]},
            arg_params={k: jnp.asarray(v) for k, v in arg_params.items()})
    tt = _make(True, arg_params, optimizer, opt_params)
    assert {n: tuple(s) for n, s in tt._zero_specs.items()} == \
        {n: tuple(s) for n, s in jt._zero_specs.items()}
    assert tt._zero_flat == jt._zero_flat
    for b in _batches():
        jt.step(b)
        tt.step(b)
    jp, tp = jt.get_params()[0], tt.get_params()[0]
    for n in jp:
        np.testing.assert_allclose(tp[n].asnumpy(), jp[n].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    jarr = {k: np.asarray(v) for k, v in jt._state_arrays().items()
            if k.startswith("opt:")}
    tarr = {k: v.numpy() for k, v in tt._state_arrays().items()
            if k.startswith("opt:")}
    assert sorted(tarr) == sorted(jarr)
    for k in jarr:
        assert tarr[k].shape == jarr[k].shape, k
        np.testing.assert_allclose(tarr[k], jarr[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
