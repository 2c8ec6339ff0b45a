"""Executor of the PyTorch port (mxnet_tpu_torch/executor.py,
``Symbol.bind``/``simple_bind``, models/mnist.py, the imperative
optimizer API) against the JAX package's, on the CPU.

Both packages build each net under a fresh NameManager (same argument
names), get the same numpy parameters and batches, and run
``forward(is_train=True)`` + ``backward()``; outputs and BatchNorm
moving statistics agree within rtol 1e-5 (atol 1e-6: f32 matmul/conv
summation order differs between XLA and ATen), gradients within 1e-4 of
each array's largest magnitude (a sum over hundreds of terms that nearly
cancels keeps only that summation-order noise).  grad_req
``write``/``add``/``null``, ``copy_params_from``, the monitor callback and
``Optimizer.update``/``get_updater`` (SGD with momentum and wd, Adam,
AdamW; rtol 1e-6 after three updates, the same operation order) are held
against the JAX executor and optimizer too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd, sym as jsym

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd as tnd, sym as tsym
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


def _small_mlp(S):
    data = S.Variable("data")
    fc1 = S.FullyConnected(data=data, num_hidden=8, name="fc1")
    act1 = S.Activation(data=fc1, act_type="relu", name="relu1")
    fc2 = S.FullyConnected(data=act1, num_hidden=4, name="fc2")
    return S.SoftmaxOutput(data=fc2, name="softmax")


def _bn_net(S):
    net = S.Convolution(data=S.Variable("data"), kernel=(3, 3), pad=(1, 1),
                        num_filter=4, name="conv")
    net = S.BatchNorm(data=net, name="bn", momentum=0.5, fix_gamma=False)
    net = S.Activation(data=net, act_type="relu", name="relu")
    net = S.Flatten(data=net)
    net = S.FullyConnected(data=net, num_hidden=3, name="fc")
    return S.SoftmaxOutput(data=net, name="softmax")


NETS = {
    "small_mlp": (lambda: _small_mlp(jsym), lambda: _small_mlp(tsym),
                  (6, 10), 4),
    "mnist_mlp": (lambda: mx.models.mlp(), lambda: mxt.models.mlp(),
                  (5, 784), 10),
    "lenet": (lambda: mx.models.get_symbol("lenet", num_classes=5),
              lambda: mxt.models.get_symbol("lenet", num_classes=5),
              (2, 1, 28, 28), 5),
    "batchnorm": (lambda: _bn_net(jsym), lambda: _bn_net(tsym),
                  (8, 2, 4, 4), 3),
}


def _both(name):
    jmake, tmake, dshape, ncls = NETS[name]
    with mx.name.NameManager(), mxt.name.NameManager():
        return jmake(), tmake(), dshape, ncls


def _params(ex, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for n in sorted(ex.arg_dict):
        if n in ("data", "softmax_label"):
            continue
        shape = ex.arg_dict[n].shape
        out[n] = (rng.uniform(-0.3, 0.3, shape) if n.endswith("weight")
                  else rng.uniform(0.5, 1.5, shape) if n.endswith("gamma")
                  else rng.uniform(-0.1, 0.1, shape)).astype(np.float32)
    return out


def _close(t, j, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("name", sorted(NETS))
def test_simple_bind_forward_backward_matches_jax(name):
    jnet, tnet, dshape, ncls = _both(name)
    assert tnet.list_arguments() == jnet.list_arguments()
    jex = jnet.simple_bind(mx.cpu(), data=dshape)
    tex = tnet.simple_bind(mxt.cpu(), data=dshape)
    assert sorted(tex.arg_dict) == sorted(jex.arg_dict)
    assert sorted(tex.aux_dict) == sorted(jex.aux_dict)
    params = _params(jex)
    rng = np.random.RandomState(1)
    batches = [(rng.randn(*dshape).astype(np.float32),
                rng.randint(0, ncls, dshape[0]).astype(np.float32))
               for _ in range(2)]
    for ex in (jex, tex):
        ex.copy_params_from(params)
        for n in ex.aux_dict:
            ex.aux_dict[n][:] = 1.0 if n.endswith("var") else 0.0
    for x, y in batches:
        outs = [ex.forward(is_train=True, data=x, softmax_label=y)
                for ex in (jex, tex)]
        for ex in (jex, tex):
            ex.backward()
        _close(outs[1][0], outs[0][0], "outputs")
        for n in params:
            j = jex.grad_dict[n].asnumpy()
            if name == "batchnorm" and n == "conv_bias":
                # BatchNorm removes the channel mean: the exact gradient
                # is 0 and both packages hold rounding noise there
                assert np.abs(j).max() < 1e-5
                assert np.abs(tex.grad_dict[n].asnumpy()).max() < 1e-5
                continue
            np.testing.assert_allclose(tex.grad_dict[n].asnumpy(), j, rtol=0,
                                       atol=1e-4 * np.abs(j).max(),
                                       err_msg=f"grad {n}")
        np.testing.assert_array_equal(tex.grad_dict["softmax_label"]
                                      .asnumpy(), 0)
        for n in jex.aux_dict:
            _close(tex.aux_dict[n], jex.aux_dict[n], f"aux {n}")
    # inference forward: moving statistics untouched
    aux_before = {n: a.asnumpy() for n, a in tex.aux_dict.items()}
    _close(tex.forward(is_train=False)[0], jex.forward(is_train=False)[0],
           "inference outputs")
    for n, v in aux_before.items():
        np.testing.assert_array_equal(tex.aux_dict[n].asnumpy(), v)
    assert tex.arg_arrays[0] is tex.arg_dict[tnet.list_arguments()[0]]
    assert len(tex.grad_arrays) == len(tex.arg_arrays)
    assert [a.shape for a in tex.aux_arrays] == [a.shape
                                                 for a in jex.aux_arrays]


def test_batchnorm_aux_update_equals_reference_rule():
    data = tsym.Variable("data")
    bn = tsym.BatchNorm(data=data, name="bn", momentum=0.5)
    ex = bn.simple_bind(mxt.cpu(), data=(8, 3, 2, 2))
    assert set(ex.aux_dict) == {"bn_moving_mean", "bn_moving_var"}
    x = np.random.RandomState(1).randn(8, 3, 2, 2).astype(np.float32) + 5.0
    ex.arg_dict["data"][:] = x
    ex.arg_dict["bn_gamma"][:] = 1.0
    ex.forward(is_train=True)
    ex.backward()
    np.testing.assert_allclose(ex.aux_dict["bn_moving_mean"].asnumpy(),
                               0.5 * x.mean(axis=(0, 2, 3)), rtol=1e-4)


def _loss_graph(S):
    x, w = S.Variable("x"), S.Variable("w")
    return (x * w) ** 2.0


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_matches_jax(req):
    xv = np.array([1.0, 2.0, 3.0], np.float32)
    wv = np.array([2.0, -1.0, 0.5], np.float32)
    head = np.array([1.0, 0.5, 2.0], np.float32)
    exs = []
    for S, nd, ctx in ((jsym, jnd, mx.cpu()), (tsym, tnd, mxt.cpu())):
        gw = nd.full((3,), 7.0)
        gx = nd.full((3,), 7.0)
        ex = _loss_graph(S).bind(ctx, {"x": nd.array(xv), "w": nd.array(wv)},
                                 args_grad={"w": gw, "x": gx},
                                 grad_req={"w": req, "x": "null"})
        for _ in range(2):
            ex.forward(is_train=True)
            if req == "null":
                with pytest.raises((MXNetError, mx.MXNetError),
                                   match="without gradient arrays"):
                    ex.backward([nd.array(head)])
            else:
                ex.backward([nd.array(head)])
        exs.append((ex, gw, gx))
    (jex, jgw, jgx), (tex, tgw, tgx) = exs
    _close(tgw, jgw, "w grad")
    np.testing.assert_array_equal(tgx.asnumpy(), 7.0)    # null: untouched
    want = {"write": 2 * xv ** 2 * wv * head,
            "add": 7.0 + 2 * (2 * xv ** 2 * wv * head),
            "null": np.full(3, 7.0)}[req]
    np.testing.assert_allclose(tgw.asnumpy(), want, rtol=1e-6)


TIES = {
    "abs": (lambda S, x: S.abs(x), jnp.abs, [0.0, -0.0, 1.0, -2.0]),
    "clip": (lambda S, x: S.clip(x, a_min=0.0, a_max=1.0),
             lambda x: jnp.clip(x, 0.0, 1.0), [0.0, 1.0, 0.5, -1.0, 2.0]),
}


@pytest.mark.parametrize("op", sorted(TIES))
def test_gradient_at_ties_matches_jax_grad(op):
    """abs has gradient 1 at 0, clip 0.5 at a_min and at a_max, as
    jax.grad gives them; the forward values are those of JAX too."""
    make, jfn, xs = TIES[op]
    xv = np.array(xs, np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x)))(jnp.asarray(xv)))
    got = []
    for S, nd, ctx in ((jsym, jnd, mx.cpu()), (tsym, tnd, mxt.cpu())):
        g = nd.zeros(xv.shape)
        ex = make(S, S.Variable("x")).bind(ctx, {"x": nd.array(xv)},
                                           args_grad={"x": g})
        y = ex.forward(is_train=True)[0]
        ex.backward([nd.ones(xv.shape)])
        got.append((y.asnumpy(), g.asnumpy()))
    (jy, jg), (ty, tg) = got
    np.testing.assert_array_equal(jg, want)
    np.testing.assert_array_equal(tg, want)
    np.testing.assert_array_equal(ty, jy)
    if op == "abs":
        assert not np.signbit(ty).any()     # abs(-0.0) is 0.0, as in JAX


def test_arithmetic_sugar_and_list_bind():
    a, b = tsym.Variable("a"), tsym.Variable("b")
    c = (a + b) * 2.0 - a / b
    ex = c.bind(mxt.cpu(), [tnd.array([4.0]), tnd.array([2.0])])
    assert float(ex.forward()[0].asnumpy()[0]) == (4 + 2) * 2 - 4 / 2
    with pytest.raises(MXNetError, match="expected 2 args"):
        c.bind(mxt.cpu(), [tnd.array([4.0])])
    with pytest.raises(MXNetError, match="missing arguments"):
        c.bind(mxt.cpu(), {"a": tnd.array([4.0])})


def test_backward_without_a_training_forward_runs_one():
    jnet, tnet, dshape, ncls = _both("small_mlp")
    exs = [net.simple_bind(ctx, data=dshape)
           for net, ctx in ((jnet, mx.cpu()), (tnet, mxt.cpu()))]
    params = _params(exs[0])
    x = np.random.RandomState(2).randn(*dshape).astype(np.float32)
    y = np.arange(dshape[0], dtype=np.float32) % ncls
    for ex in exs:
        ex.copy_params_from(params)
        ex.forward(is_train=False, data=x, softmax_label=y)
        ex.backward()
    _close(exs[1].grad_dict["fc1_weight"], exs[0].grad_dict["fc1_weight"],
           "grad after an inference forward", rtol=1e-4)
    fresh = tnet.simple_bind(mxt.cpu(), data=dshape)
    with pytest.raises(MXNetError, match="before reading outputs"):
        fresh.outputs
    with pytest.raises(MXNetError, match="before backward"):
        fresh.backward()
    with pytest.raises(MXNetError, match="no argument named"):
        fresh.forward(nope=x)
    with pytest.raises(MXNetError, match="head grads"):
        fresh.forward(is_train=True)
        fresh.backward([tnd.ones((dshape[0], ncls))] * 2)


def test_monitor_callback_sees_what_jax_sees():
    jnet, tnet, dshape, _ = _both("small_mlp")
    seen = {}
    for key, net, ctx in (("j", jnet, mx.cpu()), ("t", tnet, mxt.cpu())):
        ex = net.simple_bind(ctx, data=(4, 6))
        ex.copy_params_from(_params(ex))
        seen[key] = {}
        ex.set_monitor_callback(
            lambda name, arr, d=seen[key]: d.__setitem__(name, arr.asnumpy()))
        ex.arg_dict["data"][:] = np.ones((4, 6), np.float32)
        ex.forward(is_train=False)
    assert sorted(seen["t"]) == sorted(seen["j"])
    assert "fc1_output" in seen["t"]
    for name in seen["j"]:
        np.testing.assert_allclose(seen["t"][name], seen["j"][name],
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_copy_params_from_and_debug_str():
    net = _small_mlp(tsym)
    ex = net.simple_bind(mxt.cpu(), data=(4, 6))
    ex.copy_params_from({"fc1_weight": tnd.ones((8, 6))},
                        allow_extra_params=False)
    np.testing.assert_allclose(ex.arg_dict["fc1_weight"].asnumpy(), 1.0)
    ex.copy_params_from({"fc1_bias": np.full(8, 2.0, np.float32),
                         "nope": tnd.ones((1,))}, allow_extra_params=True)
    np.testing.assert_allclose(ex.arg_dict["fc1_bias"].asnumpy(), 2.0)
    with pytest.raises(MXNetError, match="no argument"):
        ex.copy_params_from({"nope": tnd.ones((1,))})
    with pytest.raises(MXNetError, match="no aux state"):
        ex.copy_params_from({}, {"nope": tnd.ones((1,))})
    text = ex.debug_str()
    assert "FullyConnected" in text and "fc2" in text


def test_simple_bind_grad_req_and_shared_exec():
    net = _small_mlp(tsym)
    ex = net.simple_bind(mxt.cpu(), grad_req={"fc1_weight": "write"},
                         data=(4, 6))
    assert list(ex.grad_dict) == ["fc1_weight"]
    ex2 = net.simple_bind(mxt.cpu(), data=(4, 6), shared_exec=ex)
    assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    ex3 = net.simple_bind(mxt.cpu(), grad_req="null", data=(4, 6))
    assert ex3.grad_dict == {}


def test_unported_executor_parts_raise():
    net = _small_mlp(tsym)
    ex = net.simple_bind(mxt.cpu(), data=(4, 6))
    # the program cache is ported: three programs, resolved eagerly on
    # the CPU (tests/test_torch_compile_cache.py holds them to JAX's)
    assert ex.program_cache_size() == 0
    infos = ex.warmup()
    assert [i["kind"] for i in infos][:2] == ["fwd_False", "fwd_True"]
    assert {i["source"] for i in infos} == {"eager"}
    assert ex.program_cache_size() == 3
    # model-parallel placement is ported: a group absent from the graph
    # leaves every array on the executor's context
    # (tests/test_torch_model_parallel.py holds placements to JAX's)
    ex2 = net.simple_bind(mxt.cpu(), data=(4, 6), group2ctx={"a": mxt.cpu(1)})
    assert {a.context for a in ex2.arg_dict.values()} == {mxt.cpu()}
    ex2.forward(is_train=True, data=np.ones((4, 6), np.float32))
    ex2.backward()
    assert ex2.outputs[0].context == mxt.cpu()


@pytest.mark.parametrize("kind,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
             "rescale_grad": 0.5}),
    ("sgd", {"learning_rate": 0.05, "clip_gradient": 0.1}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
    ("adamw", {"learning_rate": 0.01, "wd": 1e-2}),
])
def test_imperative_update_matches_jax(kind, kw):
    rng = np.random.RandomState(3)
    names = {0: "fc_weight", 1: "fc_bias"}
    shapes = {0: (4, 3), 1: (4,)}
    w0 = {i: rng.randn(*s).astype(np.float32) for i, s in shapes.items()}
    grads = [{i: rng.randn(*s).astype(np.float32) for i, s in shapes.items()}
             for _ in range(3)]
    results = []
    for opt_mod, nd in ((mx.optimizer, jnd), (mxt.optimizer, tnd)):
        opt = opt_mod.create(kind, param_idx2name=names, **kw)
        opt.set_lr_mult({"fc_bias": 2.0})
        updater = opt_mod.get_updater(opt)
        ws = {i: nd.array(w) for i, w in w0.items()}
        for g in grads:
            for i in ws:
                updater(i, nd.array(g[i]), ws[i])
        results.append((ws, updater.states, opt))
    (jws, jst, jopt), (tws, tst, topt) = results
    for i in w0:
        _close(tws[i], jws[i], f"weight {i}", rtol=1e-6, atol=1e-7)
    assert topt.num_update == jopt.num_update == 3
    assert (topt._get_wd(1), topt._get_wd(0)) == (0.0, kw.get("wd", 0.0))
    for i in w0:
        js, ts = jst[i], tst[i]
        js = js if isinstance(js, tuple) else (js,)
        ts = ts if isinstance(ts, tuple) else (ts,)
        for a, b in zip(ts, js):
            if b is None:
                assert a is None
            else:
                _close(a, b, f"state {i}", rtol=1e-6, atol=1e-7)
