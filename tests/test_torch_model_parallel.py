"""Model parallelism through ``ctx_group``/``group2ctx`` in the PyTorch
port's executor, against the JAX package's ``tests/test_model_parallel.py``
and the JAX executor, on the CPU.

Symbol attributes place layer groups on contexts; the executor keeps
each weight and its gradient on its group's context and moves every
value that crosses between groups through ``_CrossDeviceCopy``'s
function (counted; the gradient crosses back).  On the CPU the groups are
the contexts ``cpu(0)`` ... ``cpu(3)`` of the one host device, as the JAX
tests use its virtual devices.

Tolerances: outputs and gradients against the single-device run and the
JAX executor, the JAX test's rtol 1e-6 (the same ops in the same order;
``atol`` 1e-7 for gradients that are zero up to rounding).
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import nn_ops as tnn
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-6, 1e-7


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


def _two_group_mlp(pkg):
    sym = pkg.symbol
    with pkg.AttrScope(ctx_group="stage1"):
        net = sym.FullyConnected(data=sym.Variable("data"), num_hidden=16,
                                 name="fc1")
        net = sym.Activation(data=net, act_type="relu", name="relu1")
    with pkg.AttrScope(ctx_group="stage2"):
        net = sym.FullyConnected(data=net, num_hidden=4, name="fc2")
        net = sym.SoftmaxOutput(data=net, name="softmax")
    return net


def _chain(pkg, stages=4):
    sym = pkg.symbol
    net = sym.Variable("data")
    for i in range(stages):
        with pkg.AttrScope(ctx_group=f"stage{i}"):
            net = sym.FullyConnected(data=net, num_hidden=8, name=f"fc{i}")
            net = sym.Activation(data=net, act_type="tanh", name=f"act{i}")
    return sym.LinearRegressionOutput(data=net, name="lro")


def _run(pkg, net, group2ctx, shapes, seed, steps=1):
    """Bind on ``cpu(0)`` with ``group2ctx``, fill every argument from
    ``seed``, run forward/backward; returns the executor, the outputs and
    the gradients."""
    ex = net.simple_bind(ctx=pkg.cpu(0), group2ctx=group2ctx, **shapes)
    r = np.random.RandomState(seed)
    for n in sorted(ex.arg_dict):
        a = ex.arg_dict[n]
        a[:] = r.uniform(-0.3, 0.3, a.shape).astype(np.float32)
    if "softmax_label" in ex.arg_dict:
        ex.arg_dict["softmax_label"][:] = r.randint(
            0, 4, shapes["softmax_label"]).astype(np.float32)
    for _ in range(steps):
        ex.forward(is_train=True)
        ex.backward()
    return (ex, ex.outputs[0].asnumpy(),
            {n: g.asnumpy() for n, g in ex.grad_dict.items()})


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def test_group2ctx_placement_and_training():
    """Weights and their gradients live on their group's context; the
    output is a distribution; gradients flow across the boundary (one
    crossing forward, one back), and both equal the JAX executor's."""
    g2c = {"stage1": mxt.cpu(0), "stage2": mxt.cpu(1)}
    jg2c = {"stage1": mx.cpu(0), "stage2": mx.cpu(1)}
    shapes = {"data": (8, 10), "softmax_label": (8,)}
    c0 = tnn.cross_device_copy.crossings
    g0 = tnn.cross_device_copy.grad_crossings
    ex, out, grads = _run(mxt, _two_group_mlp(mxt), g2c, shapes, 0)
    assert tnn.cross_device_copy.crossings - c0 == 1
    assert tnn.cross_device_copy.grad_crossings - g0 == 1
    assert ex.arg_dict["fc1_weight"].context == mxt.cpu(0)
    assert ex.arg_dict["fc2_weight"].context == mxt.cpu(1)
    assert ex.grad_dict["fc1_weight"].context == mxt.cpu(0)
    assert ex.grad_dict["fc2_weight"].context == mxt.cpu(1)
    assert ex.outputs[0].context == mxt.cpu(1)
    assert out.shape == (8, 4)
    np.testing.assert_allclose(out.sum(axis=1), np.ones(8), rtol=1e-5)
    assert np.abs(grads["fc1_weight"]).sum() > 0
    with mx.name.NameManager():
        jnet = _two_group_mlp(mx)
    jex, jout, jgrads = _run(mx, jnet, jg2c, shapes, 0)
    assert next(iter(jex.arg_dict["fc2_weight"].data.devices())) \
        == jax.devices()[1]
    _close(out, jout, "outputs")
    for n in jgrads:
        _close(grads[n], jgrads[n], n)


def test_group2ctx_matches_single_device():
    """Two-group execution computes exactly what one context does, in
    both packages."""
    shapes = {"data": (6, 10), "softmax_label": (6,)}
    net = _two_group_mlp(mxt)
    _, out_mp, grads_mp = _run(mxt, net, {"stage1": mxt.cpu(0),
                                          "stage2": mxt.cpu(1)}, shapes, 2)
    _, out_sd, grads_sd = _run(mxt, net, None, shapes, 2)
    with mx.name.NameManager():
        jnet = _two_group_mlp(mx)
    _, jout, jgrads = _run(mx, jnet, {"stage1": mx.cpu(0),
                                      "stage2": mx.cpu(1)}, shapes, 2)
    _close(out_mp, out_sd, "outputs")
    _close(out_mp, jout, "outputs vs JAX")
    for n in grads_sd:
        _close(grads_mp[n], grads_sd[n], n)
        _close(grads_mp[n], jgrads[n], f"{n} vs JAX")


def test_model_parallel_pipeline_chain():
    """Four stages over four contexts (the model-parallel LSTM layout):
    each weight on its stage's context, four crossings (three between
    the stages, one into the head, which has no group and runs on the
    executor's context), outputs and gradients equal to the JAX
    executor's and to one context's."""
    shapes = {"data": (4, 8), "lro_label": (4, 8)}
    g2c = {f"stage{i}": mxt.cpu(i) for i in range(4)}
    c0 = tnn.cross_device_copy.crossings
    ex, out, grads = _run(mxt, _chain(mxt), g2c, shapes, 3)
    assert tnn.cross_device_copy.crossings - c0 == 4
    for i in range(4):
        assert ex.arg_dict[f"fc{i}_weight"].context == mxt.cpu(i)
        assert np.abs(grads[f"fc{i}_weight"]).sum() > 0
    _, out1, grads1 = _run(mxt, _chain(mxt), None, shapes, 3)
    with mx.name.NameManager():
        jnet = _chain(mx)
    _, jout, jgrads = _run(mx, jnet, {f"stage{i}": mx.cpu(i)
                                      for i in range(4)}, shapes, 3)
    _close(out, out1, "outputs")
    _close(out, jout, "outputs vs JAX")
    for n in jgrads:
        _close(grads[n], grads1[n], n)
        _close(grads[n], jgrads[n], f"{n} vs JAX")


def test_group2ctx_with_batchnorm_and_add_grad():
    """A group's BatchNorm keeps its moving statistics on its context and
    updates them as one context does; ``grad_req="add"`` accumulates two
    backwards across the boundary; warmup runs the placement eagerly,
    saying why."""
    S = mxt.symbol

    def net():
        with mxt.AttrScope(ctx_group="a"):
            x = S.FullyConnected(data=S.Variable("data"), num_hidden=8,
                                 name="fc1")
            x = S.BatchNorm(data=x, name="bn1", fix_gamma=False)
        with mxt.AttrScope(ctx_group="b"):
            x = S.FullyConnected(data=x, num_hidden=3, name="fc2")
        return S.SoftmaxOutput(data=x, name="softmax")

    shapes = {"data": (5, 4), "softmax_label": (5,)}
    sym = net()
    res = []
    for g2c in ({"a": mxt.cpu(2), "b": mxt.cpu(3)}, None):
        ex = sym.simple_bind(ctx=mxt.cpu(0), grad_req="add",
                             group2ctx=g2c, **shapes)
        r = np.random.RandomState(5)
        for n in sorted(ex.arg_dict):
            ex.arg_dict[n][:] = r.uniform(-0.5, 0.5, ex.arg_dict[n].shape)
        ex.arg_dict["softmax_label"][:] = r.randint(0, 3, (5,))
        ex.aux_dict["bn1_moving_var"][:] = 1.0
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
        if g2c is not None:
            assert ex.aux_dict["bn1_moving_mean"].context == mxt.cpu(2)
            infos = ex.warmup()
            assert all("group2ctx" in i.get("reason", "") for i in infos)
        res.append(({n: g.asnumpy() for n, g in ex.grad_dict.items()},
                    {n: a.asnumpy() for n, a in ex.aux_dict.items()}))
    for k in res[1][0]:
        _close(res[0][0][k], res[1][0][k], k)
    for k in res[1][1]:
        _close(res[0][1][k], res[1][1][k], k)


def test_cross_device_copy_is_registered_as_in_jax():
    """``_CrossDeviceCopy``, the last of the JAX package's ops: identity
    in a graph, with the JAX op's arguments, and every JAX op registered
    in the port."""
    from mxnet_tpu.ops import registry as jreg
    op, jop = treg.get_op("_CrossDeviceCopy"), jreg.get_op("_CrossDeviceCopy")
    assert list(op.arguments) == list(jop.arguments)
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(op.forward(None, {}, x), x)
    assert set(treg.list_ops()) == set(jreg.list_ops())
