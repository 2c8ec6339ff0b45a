"""CTC of the PyTorch port (``mxnet_tpu_torch/ops/ctc.py``) against the JAX
package's, on the CPU.

``ctc_loss`` and its gradient (autograd through the alpha recursion)
agree with the JAX function within rtol 1e-5 in float32 (the log-softmax
and logaddexp of XLA and ATen round differently), over labels with
repeats, zero padding and an empty label; an impossible label gives the
same large finite loss (> 1e9, not ``inf``).  ``WarpCTC`` as a loss head
(``simple_bind``, forward and backward with the default and a scaled
head cotangent) agrees with the JAX executor within rtol 1e-5.  A small
net of ``examples/lstm_ocr.py``'s shape (column LSTM, per-step
classifier, WarpCTC head) trains 4 steps through ``ShardedTrainer``
(Adam, as the example) from the same weights and batches in both
packages: losses and parameters agree within rtol 1e-4 (float32
summation order, as the other trainer tests).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu import sym as jsym
from mxnet_tpu.ops.ctc import ctc_loss as jctc
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
import torch
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import sym as tsym
from mxnet_tpu_torch.ops.ctc import ctc_loss as tctc
from mxnet_tpu_torch.parallel import ShardedTrainer

RTOL = 1e-5
# the OCR net, cut down from examples/lstm_ocr.py (20 columns of 16, 4
# labels, 11 classes, 64 hidden units, batch 32)
SEQ, HEIGHT, LABELS, CLASSES, HIDDEN, BATCH = 8, 6, 3, 5, 8, 4
STEPS = 4


@pytest.fixture(autouse=True)
def _keep_random_state():
    """Both packages' executors and trainers draw from their global
    generators: restore them for the test files that run after this one
    in the same process."""
    saved_j, saved_t = dict(jrandom._state), dict(trandom._state)
    gens = {d: g.get_state() for d, g in trandom._generators.items()}
    yield
    jrandom._state.update(saved_j)
    trandom._state.update(saved_t)
    for d in list(trandom._generators):
        if d in gens:
            trandom._generators[d].set_state(gens[d])
        else:
            del trandom._generators[d]


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


LABEL_SETS = {
    "repeats_and_padding": np.array([[1, 2, 2, 0], [3, 0, 0, 0],
                                     [4, 4, 4, 1], [2, 1, 3, 4]], np.int32),
    "empty_label": np.array([[0, 0, 0, 0], [1, 3, 0, 0], [2, 2, 0, 0],
                             [4, 0, 0, 0]], np.int32),
}


@pytest.mark.parametrize("labels", sorted(LABEL_SETS))
def test_ctc_loss_and_grad_match_jax(labels):
    lab = LABEL_SETS[labels]
    rng = np.random.RandomState(0)
    lg = rng.randn(9, 4, 5).astype(np.float32)
    cot = rng.rand(4).astype(np.float32)
    jl, vjp = jax.vjp(lambda x: jctc(x, jnp.asarray(lab)), jnp.asarray(lg))
    jg = np.asarray(vjp(jnp.asarray(cot))[0])
    x = torch.tensor(lg, requires_grad=True)
    tl = tctc(x, torch.tensor(lab))
    tl.backward(torch.tensor(cot))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=RTOL,
                               atol=RTOL * np.abs(jg).max())


def test_impossible_label_is_large_and_finite():
    # one step cannot emit a 2-symbol label
    t = float(tctc(torch.zeros(1, 1, 4), torch.tensor([[1, 2]]))[0])
    j = float(jctc(jnp.zeros((1, 1, 4), jnp.float32),
                   jnp.asarray([[1, 2]], jnp.int32))[0])
    assert np.isfinite(t) and t > 1e9
    assert t == pytest.approx(j, rel=RTOL)


def _warpctc_pair():
    with mx.name.NameManager(), mxt.name.NameManager():
        nets = [S.WarpCTC(data=S.Variable("data"), label=S.Variable("label"),
                          input_length=6, label_length=3, name="ctc")
                for S in (jsym, tsym)]
    return nets


@pytest.mark.parametrize("head_scale", [None, 0.5])
def test_warpctc_head_matches_jax_executor(head_scale):
    jnet, tnet = _warpctc_pair()
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.infer_shape(data=(12, 5)) == jnet.infer_shape(data=(12, 5))
    rng = np.random.RandomState(1)
    data = rng.randn(12, 5).astype(np.float32)       # T=6, B=2, C=5
    label = np.array([1, 2, 2, 3, 0, 0], np.float32)
    jex = jnet.simple_bind(mx.cpu(), data=(12, 5))
    tex = tnet.simple_bind(mxt.cpu(), data=(12, 5))
    outs = []
    for ex in (jex, tex):
        ex.arg_dict["data"][:] = data
        ex.arg_dict["label"][:] = label
        ex.forward(is_train=True)
        grads = (None if head_scale is None
                 else [np.full((12, 5), head_scale, np.float32)])
        ex.backward(grads) if grads else ex.backward()
        outs.append((ex.outputs[0].asnumpy(),
                     ex.grad_dict["data"].asnumpy(),
                     ex.grad_dict["label"].asnumpy()))
    (jo, jg, jl), (to, tg, tl) = outs
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(to.sum(axis=1), 1.0, rtol=RTOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL,
                               atol=RTOL * np.abs(jg).max())
    assert not tl.any() and not jl.any()


def _ocr_net(S):
    """``examples/lstm_ocr.py``'s ``lstm_ctc_unroll`` at the test's size."""
    i2h_w, i2h_b = S.Variable("i2h_weight"), S.Variable("i2h_bias")
    h2h_w, h2h_b = S.Variable("h2h_weight"), S.Variable("h2h_bias")
    cls_w, cls_b = S.Variable("cls_weight"), S.Variable("cls_bias")
    c, h = S.Variable("init_c"), S.Variable("init_h")
    cols = S.SliceChannel(data=S.Variable("data"), num_outputs=SEQ, axis=1,
                          squeeze_axis=True, name="cols")
    outs = []
    for t in range(SEQ):
        i2h = S.FullyConnected(data=cols[t], num_hidden=HIDDEN * 4,
                               weight=i2h_w, bias=i2h_b, name=f"t{t}_i2h")
        h2h = S.FullyConnected(data=h, num_hidden=HIDDEN * 4, weight=h2h_w,
                               bias=h2h_b, name=f"t{t}_h2h")
        gates = S.SliceChannel(data=i2h + h2h, num_outputs=4,
                               name=f"t{t}_gates")
        in_g = S.Activation(data=gates[0], act_type="sigmoid")
        in_t = S.Activation(data=gates[1], act_type="tanh")
        f_g = S.Activation(data=gates[2], act_type="sigmoid")
        o_g = S.Activation(data=gates[3], act_type="sigmoid")
        c = (f_g * c) + (in_g * in_t)
        h = o_g * S.Activation(data=c, act_type="tanh")
        fc = S.FullyConnected(data=h, num_hidden=CLASSES, weight=cls_w,
                              bias=cls_b, name=f"t{t}_cls")
        outs.append(S.expand_dims(fc, axis=0))
    logits = S.Reshape(data=S.Concat(*outs, dim=0, name="tconcat"),
                       shape=(-1, CLASSES))
    return S.WarpCTC(data=logits, label=S.Variable("label"),
                     input_length=SEQ, label_length=LABELS, name="ctc")


def test_ocr_net_trains_as_jax():
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet, tnet = _ocr_net(jsym), _ocr_net(tsym)
    assert tnet.tojson() == jnet.tojson()
    data_shapes = {"data": (BATCH, SEQ, HEIGHT), "init_c": (BATCH, HIDDEN),
                   "init_h": (BATCH, HIDDEN)}
    label_shapes = {"label": (BATCH * LABELS,)}
    shapes, _, _ = tnet.infer_shape(**data_shapes, **label_shapes)
    rng = np.random.RandomState(2)
    args = {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(tnet.list_arguments(), shapes)
            if n not in data_shapes and n not in label_shapes}
    opt = {"learning_rate": 0.01}
    jt = JaxTrainer(jnet, optimizer="adam", optimizer_params=opt,
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    jt.bind(data_shapes=data_shapes, label_shapes=label_shapes,
            arg_params={k: jnp.asarray(v) for k, v in args.items()})
    tt = ShardedTrainer(tnet, optimizer="adam", optimizer_params=opt,
                        device="cpu")
    tt.bind(data_shapes=data_shapes, label_shapes=label_shapes,
            arg_params=args)
    zeros = np.zeros((BATCH, HIDDEN), np.float32)
    for step in range(STEPS):
        img = rng.rand(BATCH, SEQ, HEIGHT).astype(np.float32)
        lab = rng.randint(1, CLASSES, (BATCH, LABELS)).astype(np.float32)
        lab[0, -1] = 0                                  # a shorter label
        batch = {"data": img, "init_c": zeros, "init_h": zeros,
                 "label": lab.reshape(-1)}
        jp = np.asarray(jt.step(batch)[0])
        tp = tt.step(batch)[0].detach().numpy()
        np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-6,
                                   err_msg=f"step {step}")
        # the losses the heads stand for
        labels = torch.tensor(lab, dtype=torch.int64)
        jloss = tctc(torch.log(torch.tensor(jp)).reshape(SEQ, BATCH,
                                                         CLASSES), labels)
        tloss = tctc(torch.log(torch.tensor(tp)).reshape(SEQ, BATCH,
                                                         CLASSES), labels)
        np.testing.assert_allclose(tloss.numpy(), jloss.numpy(), rtol=1e-4)
    jarg, _ = jt.get_params()
    targ, _ = tt.get_params()
    for name in args:
        np.testing.assert_allclose(targ[name].asnumpy(),
                                   np.asarray(jarg[name].asnumpy()),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
