"""The image-classification zoo's ops and the legacy heads of the PyTorch
port (``mxnet_tpu_torch/ops/nn_ops.py``) against the JAX package's, on
the CPU.

Each case builds the op over variables in both packages under a fresh
NameManager, binds it with ``simple_bind`` (float32 on both sides),
writes the same numpy inputs (seeded), runs ``forward(is_train=True)``
and ``backward`` with the same numpy head gradients, and compares:
outputs within rtol 1e-5, atol 1e-6 (f32; the convolutions' summation
order differs between XLA and ATen), gradients within 1e-5 of each
array's largest magnitude.  Dropout's masks cannot equal JAX's PRNG bits:
its eval, ``p=0`` and train-mode statistics are checked in the port, and
its train-mode parity holds with both packages' masks supplied by the
test (the JAX side patched in this process only).
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu import nd as jnd, sym as jsym
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd as tnd, random as trandom, sym as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn_ops as tnn
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5          # of each gradient's largest magnitude
DEFERRED = set()


@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    """JAX executors and initializers draw from the JAX package's global
    PRNG: restore it, so the test files that run after this one in the
    same process draw what they would draw without it."""
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


def _values(name, shape, rng, kind):
    if kind == "prob" or name == "label":
        return rng.uniform(0.05, 0.95, shape).astype(np.float32)
    if name == "gamma":
        return rng.uniform(0.1, 0.3, shape).astype(np.float32)
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def _build(S, op, params, inputs, positional):
    vars_ = [S.Variable(n) for n, _ in inputs]
    fn = getattr(S, op)
    if positional:
        return fn(*vars_, name="op", **params)
    return fn(name="op", **{n: v for (n, _), v in zip(inputs, vars_)},
              **params)


def _run_pair(op, params, inputs, positional=False, kind="", seed=0,
              is_train=True, grads=True, aux=None):
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet = _build(jsym, op, params, inputs, positional)
        tnet = _build(tsym, op, params, inputs, positional)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_outputs() == jnet.list_outputs()
    shapes = dict(inputs)
    req = "write" if grads else "null"
    jex = jnet.simple_bind(mx.cpu(), grad_req=req, **shapes)
    tex = tnet.simple_bind(mxt.cpu(), grad_req=req, **shapes)
    rng = np.random.RandomState(seed)
    vals = {n: _values(n, s, rng, kind) for n, s in inputs}
    for ex in (jex, tex):
        for n, v in (aux or {}).items():
            ex.aux_dict[n][:] = v
    jout = jex.forward(is_train=is_train, **vals)
    tout = tex.forward(is_train=is_train, **vals)
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{op} output")
    if not grads:
        return jex, tex, vals
    heads = [rng.uniform(-1, 1, o.shape).astype(np.float32) for o in jout]
    jex.backward([jnd.array(h) for h in heads])
    tex.backward([tnd.array(h) for h in heads])
    for n in jex.grad_dict:
        j = jex.grad_dict[n].asnumpy()
        t = tex.grad_dict[n].asnumpy()
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(j).max(), 1e-6),
                                   err_msg=f"{op} grad {n}")
    for n in jex.aux_dict:
        np.testing.assert_allclose(tex.aux_dict[n].asnumpy(),
                                   jex.aux_dict[n].asnumpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{op} aux {n}")
    return jex, tex, vals


X4 = (2, 3, 6, 6)
CASES = {
    # shape and plumbing
    "concat": ("Concat", {"dim": 1}, [("a", (2, 3, 4, 4)),
                                      ("b", (2, 2, 4, 4)),
                                      ("c", (2, 1, 4, 4))], True),
    "concat_dim0": ("Concat", {"dim": 0}, [("a", (2, 5)), ("b", (3, 5))],
                    True),
    "slice_channel": ("SliceChannel", {"num_outputs": 3},
                      [("data", (2, 6, 3))], False),
    "slice_channel_squeeze": ("SliceChannel",
                              {"num_outputs": 3, "axis": 1,
                               "squeeze_axis": True},
                              [("data", (2, 3, 4))], False),
    "swap_axis": ("SwapAxis", {"dim1": 0, "dim2": 2},
                  [("data", (2, 3, 4))], False),
    "element_wise_sum": ("ElementWiseSum", {}, [("a", (3, 4)), ("b", (3, 4)),
                                                ("c", (3, 4))], True),
    "block_grad": ("BlockGrad", {}, [("data", (3, 4))], False),
    "crop_offset": ("Crop", {"offset": (1, 2), "h_w": (3, 3)},
                    [("data", X4)], False),
    "crop_center": ("Crop", {"h_w": (4, 3), "center_crop": True},
                    [("data", X4)], False),
    "crop_like": ("Crop", {"num_args": 2, "offset": (2, 1)},
                  [("data", X4), ("crop_like", (2, 3, 3, 4))], False),
    "upsampling_nearest": ("UpSampling", {"scale": 2},
                           [("arg0", (2, 3, 3, 4))], True),
    "upsampling_nearest_two": ("UpSampling", {"scale": 2, "num_args": 2},
                               [("arg0", (2, 2, 4, 4)),
                                ("arg1", (2, 3, 2, 2))], True),
    "upsampling_bilinear_s2": ("UpSampling",
                               {"scale": 2, "sample_type": "bilinear",
                                "num_args": 2, "num_filter": 3},
                               [("data", (2, 3, 4, 5)),
                                ("weight", (3, 1, 4, 4))], False),
    "upsampling_bilinear_s3": ("UpSampling",
                               {"scale": 3, "sample_type": "bilinear",
                                "num_args": 2, "num_filter": 2},
                               [("data", (1, 2, 3, 3)),
                                ("weight", (2, 1, 5, 5))], False),
    # the weightless path: jax.image.resize against F.interpolate, border
    # rows included
    "upsampling_bilinear_resize": ("UpSampling",
                                   {"scale": 2, "sample_type": "bilinear"},
                                   [("data", (2, 2, 4, 5))], False),
    "upsampling_bilinear_resize_s3": ("UpSampling",
                                      {"scale": 3,
                                       "sample_type": "bilinear"},
                                      [("data", (1, 2, 3, 4))], False),
    # layers
    "leaky": ("LeakyReLU", {"act_type": "leaky", "slope": 0.1},
              [("data", (4, 5))], False),
    "elu": ("LeakyReLU", {"act_type": "elu", "slope": 0.3},
            [("data", (4, 5))], False),
    "prelu": ("LeakyReLU", {"act_type": "prelu"},
              [("data", (2, 3, 4, 4)), ("gamma", (3,))], False),
    "deconv": ("Deconvolution", {"kernel": (3, 3), "stride": (2, 2),
                                 "pad": (1, 1), "num_filter": 4},
               [("data", (2, 3, 4, 5)), ("weight", (3, 4, 3, 3))], False),
    "deconv_groups_bias_adj": ("Deconvolution",
                               {"kernel": (4, 3), "stride": (2, 3),
                                "pad": (1, 0), "adj": (1, 2),
                                "num_filter": 6, "num_group": 2,
                                "no_bias": False},
                               [("data", (2, 4, 3, 3)),
                                ("weight", (4, 3, 4, 3)), ("bias", (6,))],
                               False),
    # target 9x6 from 4x4: adjustments 2 (= the stride) and -1
    "deconv_target_shape": ("Deconvolution",
                            {"kernel": (3, 3), "stride": (2, 2),
                             "pad": (1, 1), "num_filter": 2,
                             "num_group": 2, "no_bias": False,
                             "target_shape": (9, 6)},
                            [("data", (2, 2, 4, 4)),
                             ("weight", (2, 1, 3, 3)), ("bias", (2,))],
                            False),
    "lrn_odd": ("LRN", {"nsize": 5, "alpha": 1e-2, "beta": 0.75,
                        "knorm": 1.0}, [("data", (2, 7, 3, 3))], False),
    "lrn_even": ("LRN", {"nsize": 4, "alpha": 2e-2}, [("data", (2, 6, 3, 3))],
                 False),
    "l2norm_instance": ("L2Normalization", {}, [("data", X4)], False),
    "l2norm_channel": ("L2Normalization", {"mode": "channel"},
                       [("data", X4)], False),
    "l2norm_spatial": ("L2Normalization", {"mode": "spatial"},
                       [("data", X4)], False),
    "softmax_activation_instance": ("SoftmaxActivation", {},
                                    [("data", (4, 7))], False),
    "softmax_activation_channel": ("SoftmaxActivation", {"mode": "channel"},
                                   [("data", (2, 3, 4, 4))], False),
    # heads
    "linear_regression": ("LinearRegressionOutput", {"grad_scale": 2.0},
                          [("data", (4, 3)), ("label", (4, 3))], False),
    "logistic_regression": ("LogisticRegressionOutput", {},
                            [("data", (4, 3)), ("label", (4, 3))], False),
    "mae_regression": ("MAERegressionOutput", {"grad_scale": 0.5},
                       [("data", (5, 1)), ("label", (5, 1))], False),
    "make_loss": ("MakeLoss", {"grad_scale": 0.25}, [("data", (3, 4))],
                  False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_forward_backward_matches_jax(case):
    op, params, inputs, positional = CASES[case]
    _run_pair(op, params, inputs, positional)


def test_kl_sparse_reg_matches_jax_with_its_moving_average():
    jex, tex, _ = _run_pair("IdentityAttachKLSparseReg",
                            {"sparseness_target": 0.2, "penalty": 0.01,
                             "momentum": 0.8},
                            [("data", (4, 6))], kind="prob",
                            aux={"op_avg": 0.3})
    # the training forward moved the average off its initial value
    assert not np.allclose(tex.aux_dict["op_avg"].asnumpy(), 0.3)


def test_cast_matches_jax_values_and_types():
    for dtype in ("float16", "int32", "float64"):
        jex, tex, _ = _run_pair("Cast", {"dtype": dtype}, [("data", (3, 4))],
                                grads=False)
        assert tex.outputs[0].dtype == jex.outputs[0].dtype
        with mx.name.NameManager(), mxt.name.NameManager():
            j = jsym.Cast(jsym.Variable("data"), dtype=dtype)
            t = tsym.Cast(tsym.Variable("data"), dtype=dtype)
        assert (t.infer_type(data="float32")[1]
                == j.infer_type(data="float32")[1])


def test_rrelu_eval_takes_the_mean_slope_and_train_draws_within_bounds():
    # eval: the mean slope, equal to JAX's
    _run_pair("LeakyReLU", {"act_type": "rrelu", "lower_bound": 0.1,
                            "upper_bound": 0.3},
              [("data", (4, 5))], is_train=False, grads=False)
    x = -torch.rand(2000) - 0.5
    op = treg.get_op("LeakyReLU")
    p = op.parse_params({"act_type": "rrelu", "lower_bound": "0.1",
                         "upper_bound": "0.3"})
    key = trandom.GraphKey(7, "cpu")
    y = op.forward(treg.OpContext(is_train=True, rng=key.generator(3)), p, x)
    slope = (y / x).numpy()
    assert slope.min() >= 0.1 and slope.max() <= 0.3
    assert abs(slope.mean() - 0.2) < 0.01
    y2 = op.forward(treg.OpContext(is_train=True, rng=key.generator(3)), p, x)
    assert torch.equal(y, y2)


def _dropout_exec(S, p, shape, ctx, grad=True):
    with (mx.name.NameManager() if S is jsym else mxt.name.NameManager()):
        net = S.Dropout(S.Variable("data"), p=p, name="drop")
    return net.simple_bind(ctx, grad_req="write" if grad else "null",
                           data=shape)


def test_dropout_eval_p0_and_train_statistics():
    x = np.random.RandomState(0).uniform(0.5, 1.5, (64, 128)) \
        .astype(np.float32)
    # eval, and p=0 in training: identity
    ex = _dropout_exec(tsym, 0.5, x.shape, mxt.cpu())
    np.testing.assert_array_equal(ex.forward(is_train=False, data=x)[0]
                                  .asnumpy(), x)
    ex0 = _dropout_exec(tsym, 0.0, x.shape, mxt.cpu())
    np.testing.assert_array_equal(ex0.forward(is_train=True, data=x)[0]
                                  .asnumpy(), x)
    # train: about half kept, scaled by 1/keep; the gradient is mask/keep
    for p in (0.5, 0.2):
        ex = _dropout_exec(tsym, p, x.shape, mxt.cpu())
        out = ex.forward(is_train=True, data=x)[0].asnumpy()
        mask = out != 0
        keep = 1.0 - p
        assert abs(mask.mean() - keep) < 0.01
        np.testing.assert_allclose(out[mask], x[mask] / np.float32(keep),
                                   rtol=1e-6)
        ex.backward([tnd.ones(x.shape)])
        np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(),
                                   mask / np.float32(keep), rtol=1e-6)
        # a second forward draws a new mask
        again = ex.forward(is_train=True, data=x)[0].asnumpy() != 0
        assert (again != mask).any()


def _fixed_mask(shape, keep, seed=3):
    return np.random.RandomState(seed).uniform(size=shape) < keep


def test_dropout_matches_jax_with_supplied_masks(monkeypatch):
    shape, p = (8, 16), 0.3
    keep = 1.0 - p
    mask = _fixed_mask(shape, keep)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, k, s: jax.numpy.asarray(
                            _fixed_mask(tuple(s), k)))
    monkeypatch.setattr(tnn, "dropout_mask",
                        lambda x, k, g: torch.as_tensor(
                            _fixed_mask(tuple(x.shape), k)))
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    g = np.random.RandomState(2).uniform(-1, 1, shape).astype(np.float32)
    res = []
    for S, ctx, nd_ in ((jsym, mx.cpu(), jnd), (tsym, mxt.cpu(), tnd)):
        ex = _dropout_exec(S, p, shape, ctx)
        out = ex.forward(is_train=True, data=x)[0].asnumpy()
        ex.backward([nd_.array(g)])
        res.append((out, ex.grad_dict["data"].asnumpy()))
    (jo, jg), (to, tg) = res
    np.testing.assert_array_equal(to != 0, mask)
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=0)


def test_slice_channel_errors_match_jax():
    for params, shape in (({"num_outputs": 4}, (2, 6)),
                          ({"num_outputs": 2, "squeeze_axis": True},
                           (2, 4))):
        with mx.name.NameManager(), mxt.name.NameManager():
            j = jsym.SliceChannel(jsym.Variable("data"), **params)
            t = tsym.SliceChannel(tsym.Variable("data"), **params)
        with pytest.raises(mx.base.MXNetError):
            j.infer_shape(data=shape)
        with pytest.raises(MXNetError):
            t.infer_shape(data=shape)


def test_registry_and_loss_flags_match_jax():
    assert treg.list_ops() == treg.OP_REGISTRY.list()
    assert set(treg.list_ops()) == set(jreg.list_ops()) - DEFERRED
    for name in treg.list_ops():
        j, t = jreg.get_op(name), treg.get_op(name)
        assert (t.is_loss, t.needs_rng) == (j.is_loss, j.needs_rng), name
    for name in {c[0] for c in CASES.values()} | {
            "Cast", "Dropout", "IdentityAttachKLSparseReg"}:
        assert treg.get_op(name).func_name == jreg.get_op(name).func_name


def test_element_wise_sum_nd_function_matches_jax():
    rng = np.random.RandomState(5)
    arrs = [rng.randn(3, 4).astype(np.float32) for _ in range(3)]
    t = tnd._element_wise_sum(*[tnd.array(a) for a in arrs], num_args=3)
    j = jnd._element_wise_sum(*[jnd.array(a) for a in arrs], num_args=3)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


# ---------------------------------------------------------------------------
# The keyed generator of the graph's sampling ops (trainer and executor)
# ---------------------------------------------------------------------------

def _noisy_net(S):
    data = S.Variable("data")
    noisy = data + S._sample_normal(shape=(4, 8), name="noise")
    net = S.FullyConnected(S.Dropout(noisy, p=0.5, name="drop"),
                           num_hidden=3, name="fc")
    return S.SoftmaxOutput(net, name="softmax")


def _noisy_trainer(seed=0, begin=0):
    from mxnet_tpu_torch.parallel import ShardedTrainer
    with mxt.name.NameManager():
        net = _noisy_net(tsym)
    tr = ShardedTrainer(net, "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                     "begin_num_update": begin},
                        guard=True, device="cpu", seed=seed)
    rng = np.random.RandomState(0)
    tr.bind({"data": (4, 8)}, {"softmax_label": (4,)},
            arg_params={"fc_weight": rng.randn(3, 8).astype(np.float32),
                        "fc_bias": np.zeros(3, np.float32)})
    return tr


def _noisy_batch(seed, nan=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 8).astype(np.float32)
    if nan:
        x[:] = np.nan
    return {"data": x, "softmax_label": rng.randint(0, 3, 4)
            .astype(np.float32)}


def _state(tr):
    return {n: p.detach().clone() for n, p in tr._params.items()}


def test_sampling_graph_trains_through_the_trainer():
    tr = _noisy_trainer()
    before = _state(tr)
    heads = tr.step(_noisy_batch(1))
    assert heads[0].shape == (4, 3) and torch.isfinite(heads[0]).all()
    assert not torch.equal(before["fc_weight"], tr._params["fc_weight"])
    assert len(tr.forward(_noisy_batch(2))[0]) == 4


def test_trainer_draws_are_keyed_by_seed_and_step():
    a, b, c = _noisy_trainer(), _noisy_trainer(), _noisy_trainer(seed=1)
    for t in range(1, 4):
        ha, hb, hc = (tr.step(_noisy_batch(t))[0] for tr in (a, b, c))
        assert torch.equal(ha, hb)
        assert not torch.equal(ha, hc)
    for n, v in _state(a).items():
        assert torch.equal(v, _state(b)[n])
    # eval forwards draw from their own stream: the same in both trainers
    assert torch.equal(a.forward(_noisy_batch(9))[0],
                       b.forward(_noisy_batch(9))[0])


def test_guard_skipped_step_does_not_shift_later_draws():
    skipping = _noisy_trainer()
    skipping.step(_noisy_batch(1, nan=True))          # t = 1, skipped
    assert int(skipping._guard_state["skipped"]) == 1
    fresh = _noisy_trainer(begin=1)                   # its first step is t=2
    ha = skipping.step(_noisy_batch(2))[0]
    hb = fresh.step(_noisy_batch(2))[0]
    assert torch.equal(ha, hb)
    for n, v in _state(skipping).items():
        assert torch.equal(v, _state(fresh)[n])


def test_executor_backward_reuses_the_forward_draws():
    with mxt.name.NameManager():
        net = tsym.Variable("data") * tsym._sample_normal(shape=(3, 5))
    ex = net.simple_bind(mxt.cpu(), data=(3, 5))
    ones = np.ones((3, 5), np.float32)
    trandom.seed(11)
    y = ex.forward(is_train=False, data=ones)[0].asnumpy()
    ex.backward()
    # d(data * noise)/d(data) is the noise the forward returned
    np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(), y)
    y2 = ex.forward(is_train=True, data=ones)[0].asnumpy()
    assert not np.array_equal(y, y2)
    trandom.seed(11)
    np.testing.assert_array_equal(ex.forward(data=ones)[0].asnumpy(), y)


def test_graph_key_draws_per_node():
    key = trandom.GraphKey(5, "cpu")
    a = torch.rand(4, generator=key.generator(2))
    b = torch.rand(4, generator=key.generator(3))
    assert not torch.equal(a, b)
    assert torch.equal(a, torch.rand(4, generator=trandom.GraphKey(
        5, "cpu").generator(2)))
