"""The port's tuned conv backward (``mxnet_tpu_torch/ops/conv_backward.py``)
against the JAX package's (``mxnet_tpu/ops/conv_backward.py``), on the CPU.

Both modules read ``MXNET_TPU_CONV_BWD``; each test sets it for both.
Tolerances:

* ``_conv2d_bwd`` against the JAX ``_conv2d_bwd`` on the JAX test's eight
  shapes, under both policies: dx rtol/atol 2e-5, dw rtol 2e-5 and atol
  2e-4 (the JAX test's own bounds against XLA's VJP: f32 summation order);
* the tuned backward against float64 finite differences: ``gradcheck``'s
  defaults (eps 1e-6, atol 1e-5, rtol 1e-3);
* bf16: the JAX test's 3e-2 against the backend's own transpose;
* the trainers: the trainer tests' bounds (heads atol 1e-5, parameters
  and moving statistics rtol 1e-4, atol 1e-6).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu import symbol as jsym
from mxnet_tpu.ops import conv_backward as jcb
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.ops import conv_backward as tcb
from mxnet_tpu_torch.parallel import ShardedTrainer

ENV = "MXNET_TPU_CONV_BWD"

# (cin, hw, cout, k, s, p): tests/test_conv_backward.py's SHAPES
SHAPES = [
    (8, 14, 16, 1, 1, 0),     # 1x1 s1 -> dgrad_mm + wgrad_mm
    (16, 7, 8, 1, 1, 0),
    (8, 14, 16, 1, 2, 0),     # 1x1 s2 shortcut -> phase dgrad
    (8, 15, 16, 1, 2, 0),     # odd spatial
    (8, 14, 16, 3, 2, 1),     # 3x3 s2 -> phase dgrad
    (8, 15, 16, 3, 2, 1),
    (4, 16, 8, 7, 2, 3),      # stem-like 7x7 s2
    (8, 14, 16, 3, 1, 1),     # 3x3 s1 -> the backend keeps both
]


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


def _operands(cin, hw, cout, k, s, p, seed=0, n=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, cin, hw, hw).astype(np.float32)
    w = (rng.randn(cout, cin, k, k) * 0.2).astype(np.float32)
    ho = (hw + 2 * p - k) // s + 1
    dy = rng.randn(n, cout, ho, ho).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("policy", ["xla", "tuned"])
@pytest.mark.parametrize("cin,hw,cout,k,s,p", SHAPES)
def test_backward_matches_jax(cin, hw, cout, k, s, p, policy, monkeypatch):
    monkeypatch.setenv(ENV, policy)
    x, w, dy = _operands(cin, hw, cout, k, s, p)
    kinds = tcb._policy(x.shape, w.shape, (s, s), (p, p))
    assert kinds == jcb._policy(x.shape, w.shape, (s, s), (p, p))
    assert (kinds == ("xla", "xla")) == (policy == "xla" or k == 3 and s == 1)
    jdx, jdw = jcb._conv2d_bwd((s, s), (p, p),
                               (jnp.asarray(x), jnp.asarray(w)),
                               jnp.asarray(dy))
    tdx, tdw = tcb._conv2d_bwd((s, s), (p, p),
                               (torch.from_numpy(x), torch.from_numpy(w)),
                               torch.from_numpy(dy))
    assert tdx.dtype == tdw.dtype == torch.float32
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=2e-5,
                               atol=2e-4)


def test_policy_equals_jax_over_a_grid(monkeypatch):
    x_shapes = [(2, 8, 14, 14), (4, 64, 56, 56), (1, 3, 224, 224)]
    w_shapes = [(16, 8, 1, 1), (16, 8, 3, 3), (64, 3, 7, 7), (16, 8, 3, 1)]
    confs = [((1, 1), (0, 0)), ((2, 2), (0, 0)), ((1, 1), (1, 1)),
             ((2, 2), (1, 1)), ((2, 2), (3, 3)), ((2, 1), (1, 1)),
             ((2, 2), (1, 0)), ((3, 3), (1, 1))]
    seen = set()
    for value in (None, "xla", "tuned", "TUNED", ""):
        if value is None:
            monkeypatch.delenv(ENV, raising=False)
        else:
            monkeypatch.setenv(ENV, value)
        for xs in x_shapes:
            for ws in w_shapes:
                for stride, pad in confs:
                    got = tcb._policy(xs, ws, stride, pad)
                    assert got == jcb._policy(xs, ws, stride, pad), \
                        (value, xs, ws, stride, pad)
                    seen.add(got)
    assert seen == {("xla", "xla"), ("mm", "mm"), ("phase", "xla")}


@pytest.mark.parametrize("cin,hw,cout,k,s,p", [
    (3, 7, 4, 3, 2, 1), (3, 6, 4, 1, 1, 0), (2, 9, 3, 7, 2, 3),
    (3, 7, 4, 1, 2, 0)])
def test_tuned_grad_against_finite_differences(cin, hw, cout, k, s, p,
                                               monkeypatch):
    monkeypatch.setenv(ENV, "tuned")
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, cin, hw, hw)).requires_grad_()
    w = torch.from_numpy(rng.randn(cout, cin, k, k) * 0.3).requires_grad_()
    out = tcb.conv2d(x, w, stride=(s, s), pad=(p, p))
    assert type(out.grad_fn).__name__ == "_TunedConv2dBackward"
    assert torch.autograd.gradcheck(
        lambda a, b: tcb.conv2d(a, b, stride=(s, s), pad=(p, p)), (x, w))


def test_bf16_dtypes_kept(monkeypatch):
    monkeypatch.setenv(ENV, "tuned")
    rng = np.random.RandomState(4)
    for cin, hw, cout, k, s, p in (SHAPES[0], SHAPES[4]):
        x = torch.from_numpy(rng.randn(2, cin, hw, hw).astype(np.float32)) \
            .to(torch.bfloat16).requires_grad_()
        w = torch.from_numpy((rng.randn(cout, cin, k, k) * 0.2)
                             .astype(np.float32)).to(torch.bfloat16) \
            .requires_grad_()
        out = tcb.conv2d(x, w, stride=(s, s), pad=(p, p))
        (out.float() ** 2).sum().backward()
        assert x.grad.dtype == w.grad.dtype == torch.bfloat16
        dx, dw = tcb._backend_grads(2 * out.detach(), x.detach(), w.detach(),
                                    (s, s), (p, p), (True, True))
        np.testing.assert_allclose(x.grad.float().numpy(),
                                   dx.float().numpy(), rtol=3e-2, atol=3e-2)
        np.testing.assert_allclose(w.grad.float().numpy(),
                                   dw.float().numpy(), rtol=3e-2, atol=3e-2)


def test_fall_through_cases(monkeypatch):
    """Grouped, dilated, asymmetric and padded-1x1 convolutions take the
    backend under ``tuned``, and the default takes it everywhere; the
    policy a forward saw is the one its backward runs."""
    monkeypatch.setenv(ENV, "tuned")
    rng = np.random.RandomState(3)

    def leaf(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
            .requires_grad_()

    x = leaf(1, 4, 8, 8)
    for w, kw in ((leaf(8, 2, 3, 3), dict(groups=2)),
                  (leaf(8, 4, 3, 3), dict(dilate=(2, 2))),
                  (leaf(8, 4, 1, 1), {})):
        pad = (1, 1)
        out = tcb.conv2d(x, w, stride=(1, 1), pad=pad, **kw)
        assert type(out.grad_fn).__name__ == "ConvolutionBackward0", kw
        gx, gw = torch.autograd.grad(out.square().sum(), (x, w))
        ref = torch.nn.functional.conv2d(
            x, w, padding=pad, dilation=kw.get("dilate", 1),
            groups=kw.get("groups", 1))
        rx, rw = torch.autograd.grad(ref.square().sum(), (x, w))
        assert torch.equal(gx, rx) and torch.equal(gw, rw)
    for xs, ws, stride, pad in (((2, 8, 14, 14), (16, 8, 3, 3), (2, 2),
                                 (1, 0)),
                                ((2, 8, 14, 14), (16, 8, 1, 1), (1, 1),
                                 (1, 1)),
                                ((2, 8, 14, 14), (16, 8, 3, 3), (2, 1),
                                 (1, 1))):
        assert tcb._policy(xs, ws, stride, pad) == ("xla", "xla")
    # asymmetric pad through _conv2d_bwd equals the backend's transpose
    x, w = leaf(2, 4, 10, 10), leaf(8, 4, 3, 3)
    dy = torch.from_numpy(rng.randn(2, 8, 5, 4).astype(np.float32))
    got = tcb._conv2d_bwd((2, 2), (1, 0), (x.detach(), w.detach()), dy)
    ref = tcb._backend_grads(dy, x.detach(), w.detach(), (2, 2), (1, 0),
                             (True, True))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # a forward under tuned keeps its policy through a later change
    x, w = leaf(2, 8, 6, 6), leaf(16, 8, 1, 1)
    out = tcb.conv2d(x, w, stride=(1, 1), pad=(0, 0))
    monkeypatch.setenv(ENV, "xla")
    calls = []
    real = tcb._conv2d_bwd
    monkeypatch.setattr(tcb, "_conv2d_bwd",
                        lambda *a: calls.append(a[4]) or real(*a))
    out.sum().backward()
    assert calls == [("mm", "mm")]
    assert type(tcb.conv2d(x, w, stride=(1, 1), pad=(0, 0)).grad_fn) \
        .__name__ == "ConvolutionBackward0"
    # a forward that records no gradient runs the backend's conv
    monkeypatch.setenv(ENV, "tuned")
    with torch.no_grad():
        assert tcb.conv2d(x, w, stride=(1, 1), pad=(0, 0)).grad_fn is None


BATCH = 4
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _conv_net(S):
    """A stem 5x5 s2, a 1x1 s1, a 3x3 s2 and a 1x1 s2 projection beside
    it, a 3x3 s1, global pool, classifier: every tuned kind."""
    net = S.Convolution(data=S.Variable("data"), num_filter=8,
                        kernel=(5, 5), stride=(2, 2), pad=(2, 2),
                        name="stem")
    net = S.Activation(data=net, act_type="relu")
    a = S.Convolution(data=net, num_filter=8, kernel=(1, 1), name="c1x1")
    a = S.Activation(data=a, act_type="relu")
    a = S.Convolution(data=a, num_filter=16, kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), name="c3x3s2")
    b = S.Convolution(data=net, num_filter=16, kernel=(1, 1), stride=(2, 2),
                      name="proj")
    net = S.Activation(data=a + b, act_type="relu")
    net = S.Convolution(data=net, num_filter=16, kernel=(3, 3), pad=(1, 1),
                        name="c3x3")
    net = S.Pooling(data=net, pool_type="avg", kernel=(4, 4),
                    global_pool=True)
    net = S.FullyConnected(data=S.Flatten(data=net), num_hidden=10,
                           name="fc")
    return S.SoftmaxOutput(data=net, name="softmax")


def test_conv_net_through_both_trainers_under_tuned(monkeypatch):
    monkeypatch.setenv(ENV, "tuned")
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet, tnet = _conv_net(jsym), _conv_net(tsym)
    image = (3, 15, 15)
    shapes, _, _ = tnet.infer_shape(data=(BATCH,) + image,
                                    softmax_label=(BATCH,))
    rng = np.random.RandomState(0)
    args = {n: (0.2 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(tnet.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    jt = JaxTrainer(jnet, optimizer="sgd", optimizer_params=dict(OPT),
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    jt.bind(data_shapes={"data": (BATCH,) + image},
            label_shapes={"softmax_label": (BATCH,)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()})
    trainers = {}
    for policy in ("tuned", "xla"):
        monkeypatch.setenv(ENV, policy)
        tt = ShardedTrainer(tnet, optimizer="sgd",
                            optimizer_params=dict(OPT), device="cpu")
        tt.bind(data_shapes={"data": (BATCH,) + image},
                label_shapes={"softmax_label": (BATCH,)}, arg_params=args)
        trainers[policy] = tt
    calls = []
    real = tcb._conv2d_bwd
    monkeypatch.setattr(tcb, "_conv2d_bwd",
                        lambda *a: calls.append(a[4]) or real(*a))
    for step in range(2):
        batch = {"data": rng.rand(BATCH, *image).astype(np.float32),
                 "softmax_label": rng.randint(0, 10, BATCH)
                 .astype(np.float32)}
        monkeypatch.setenv(ENV, "tuned")
        jh = jt.step(batch)
        th = trainers["tuned"].step(batch)
        monkeypatch.setenv(ENV, "xla")
        xh = trainers["xla"].step(batch)
        np.testing.assert_allclose(th[0].numpy(), np.asarray(jh[0]), rtol=0,
                                   atol=1e-5, err_msg=f"heads, step {step}")
        jargs = jt.get_params()[0]
        for policy, tt in trainers.items():
            targs = tt.get_params()[0]
            for n in jargs:
                np.testing.assert_allclose(
                    targs[n].asnumpy(), jargs[n].asnumpy(), rtol=1e-4,
                    atol=1e-6, err_msg=f"{policy}: {n}, step {step}")
        np.testing.assert_allclose(xh[0].numpy(), th[0].numpy(), rtol=0,
                                   atol=1e-5)
    # stem and c3x3s2 and proj take the phase form, c1x1 both products;
    # c3x3 stays with the backend: four tuned backwards a tuned step
    assert sorted(calls) == sorted([("phase", "xla")] * 6
                                   + [("mm", "mm")] * 2)
