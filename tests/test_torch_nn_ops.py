"""NN ops of the PyTorch port (mxnet_tpu_torch/ops/nn_ops.py) against the
JAX package's ``get_op(name).forward`` on the same numpy inputs, on the
CPU; gradients against ``jax.vjp`` of the same forward.

Tolerances: float32 elementwise ops within atol 1e-6; reductions,
convolutions and matmuls within rtol 1e-5 / atol 1e-5 (summation order
differs between XLA and ATen); bfloat16 softmax within 1e-2 (one bf16
rounding of the output).  Inputs are float32 (importing mxnet_tpu
enables x64, so every array is cast explicitly).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import nn_ops as jnn
from mxnet_tpu.ops.registry import OpContext as JCtx
from mxnet_tpu.ops.registry import get_op as jget_op

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn_ops as tnn
from mxnet_tpu_torch.ops.registry import OpContext as TCtx
from mxnet_tpu_torch.ops.registry import get_op as tget_op

F32 = dict(rtol=1e-5, atol=1e-5)


def _run(name, raw, inputs, *, is_train=False, aux=None, cot=None):
    """Forward (and, with ``cot``, input gradients) of op ``name`` in both
    packages.  Returns ((jax_out, jax_grads, jax_aux_updates),
    (torch_out, torch_grads, torch_aux_updates))."""
    jop, top = jget_op(name), tget_op(name)
    jp, tp = jop.parse_params(raw), top.parse_params(raw)
    aux = aux or {}
    jctx = JCtx(is_train=is_train, aux={k: jnp.asarray(v)
                                        for k, v in aux.items()})

    def jfwd(*xs):
        return jop.forward(jctx, jp, *xs)

    jin = [jnp.asarray(x) for x in inputs]
    if cot is None:
        jout, jgrads = jfwd(*jin), None
    else:
        jout, vjp = jax.vjp(jfwd, *jin)
        jgrads = vjp(jnp.asarray(cot))
    tctx = TCtx(is_train=is_train, aux={k: torch.from_numpy(v)
                                        for k, v in aux.items()})
    tin = [torch.from_numpy(x).requires_grad_(x.dtype == np.float32)
           for x in inputs]
    tout = top.forward(tctx, tp, *tin)
    tgrads = None
    if cot is not None:
        tout.backward(torch.from_numpy(cot))
        tgrads = [None if t.grad is None else t.grad.numpy() for t in tin]
    return ((np.asarray(jout), jgrads, jctx.aux_updates),
            (tout.detach().numpy(), tgrads, tctx.aux_updates))


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu"])
def test_activation(act):
    rng = np.random.RandomState(0)
    x = _rand(rng, 4, 5)
    (jo, jg, _), (to, tg, _) = _run("Activation", {"act_type": act}, [x],
                                    cot=_rand(rng, 4, 5))
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg[0], np.asarray(jg[0]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected_flattens_and_matches(no_bias):
    rng = np.random.RandomState(1)
    ins = [_rand(rng, 3, 2, 4), _rand(rng, 6, 8)]
    if not no_bias:
        ins.append(_rand(rng, 6))
    (jo, jg, _), (to, tg, _) = _run(
        "FullyConnected", {"num_hidden": "6", "no_bias": str(no_bias)}, ins,
        cot=_rand(rng, 3, 6))
    np.testing.assert_allclose(to, jo, **F32)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), **F32)


@pytest.mark.parametrize("kw", [
    dict(kernel="(3, 3)", pad="(1, 1)", num_filter="4", no_bias="True"),
    dict(kernel="(7, 7)", stride="(2, 2)", pad="(3, 3)", num_filter="4",
         no_bias="True"),
    dict(kernel="(1, 1)", stride="(2, 2)", num_filter="6"),
    dict(kernel="(3, 3)", dilate="(2, 2)", num_group="2", num_filter="4"),
], ids=["3x3", "7x7s2", "1x1s2_bias", "dilated_grouped"])
def test_convolution(kw):
    rng = np.random.RandomState(2)
    op = tget_op("Convolution")
    p = op.parse_params(kw)
    x = _rand(rng, 2, 4, 11, 11)
    shapes, outs, _ = op.infer_shape(p, [x.shape, None, None])
    ins = [x, _rand(rng, *shapes[1])]
    if p["no_bias"] is False:
        ins.append(_rand(rng, *shapes[2]))
    (jo, jg, _), (to, tg, _) = _run("Convolution", kw, ins,
                                    cot=_rand(rng, *outs[0]))
    assert to.shape == jo.shape == outs[0]
    np.testing.assert_allclose(to, jo, **F32)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)


POOL_CASES = [
    # ResNet-50's stem pool: 112 -> 57 (torch's floor rule gives 56)
    ("max", 112, dict(kernel="(3, 3)", stride="(2, 2)", pad="(1, 1)"), 57),
    ("max", 14, dict(kernel="(3, 3)", stride="(2, 2)", pad="(1, 1)"), 8),
    ("max", 10, dict(kernel="(3, 3)", stride="(2, 2)"), 5),
    # ceil edge window: avg divides by kh*kw, padding included
    ("avg", 10, dict(kernel="(3, 3)", stride="(2, 2)", pad="(1, 1)"), 6),
    ("sum", 9, dict(kernel="(2, 2)", stride="(2, 2)"), 5),
    ("avg", 7, dict(kernel="(7, 7)", global_pool="True"), 1),
]


@pytest.mark.parametrize("ptype,size,kw,out", POOL_CASES,
                         ids=[f"{c[0]}{c[1]}to{c[3]}" for c in POOL_CASES])
def test_pooling_ceil_convention(ptype, size, kw, out):
    rng = np.random.RandomState(3)
    raw = dict(kw, pool_type=ptype)
    x = _rand(rng, 2, 3, size, size)
    jop, top = jget_op("Pooling"), tget_op("Pooling")
    jshape = jop.infer_shape(jop.parse_params(raw), [x.shape])[1][0]
    tshape = top.infer_shape(top.parse_params(raw), [x.shape])[1][0]
    assert tshape == jshape == (2, 3, out, out)
    (jo, jg, _), (to, tg, _) = _run("Pooling", raw, [x],
                                    cot=_rand(rng, *tshape))
    assert to.shape == tshape
    np.testing.assert_allclose(to, jo, **F32)
    np.testing.assert_allclose(tg[0], np.asarray(jg[0]), **F32)


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_train_outputs_aux_and_grads(fix_gamma):
    rng = np.random.RandomState(4)
    x = (3.0 + 2.0 * _rand(rng, 4, 3, 5, 5)).astype(np.float32)
    gamma = (1.0 + 0.1 * _rand(rng, 3)).astype(np.float32)
    beta = _rand(rng, 3)
    aux = {"moving_mean": _rand(rng, 3),
           "moving_var": rng.rand(3).astype(np.float32)}
    raw = {"fix_gamma": str(fix_gamma), "momentum": "0.8"}
    (jo, jg, ja), (to, tg, ta) = _run("BatchNorm", raw, [x, gamma, beta],
                                      is_train=True, aux=aux,
                                      cot=_rand(rng, 4, 3, 5, 5))
    np.testing.assert_allclose(to, jo, **F32)
    for k in ("moving_mean", "moving_var"):
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]), **F32)
    np.testing.assert_allclose(tg[0], np.asarray(jg[0]), rtol=1e-4,
                               atol=1e-5)
    if fix_gamma:
        assert tg[1] is None or not tg[1].any()
    else:
        np.testing.assert_allclose(tg[1], np.asarray(jg[1]), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(tg[2], np.asarray(jg[2]), rtol=1e-4,
                               atol=1e-4)


def test_batchnorm_eval_uses_moving_stats():
    rng = np.random.RandomState(5)
    x = _rand(rng, 2, 3, 4, 4)
    aux = {"moving_mean": _rand(rng, 3),
           "moving_var": rng.rand(3).astype(np.float32)}
    (jo, _, ja), (to, _, ta) = _run(
        "BatchNorm", {"fix_gamma": "False"},
        [x, _rand(rng, 3), _rand(rng, 3)], aux=aux)
    np.testing.assert_allclose(to, jo, **F32)
    assert ta == {} and ja == {}


def test_flatten():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    (jo, _, _), (to, _, _) = _run("Flatten", {}, [x])
    np.testing.assert_array_equal(to, jo)


SOFTMAX_CASES = [
    {},
    {"grad_scale": "0.5"},
    {"normalization": "batch"},
    {"use_ignore": "True", "ignore_label": "2", "normalization": "valid"},
    {"use_ignore": "True", "ignore_label": "2", "grad_scale": "3"},
    {"normalization": "valid"},
    {"multi_output": "True", "normalization": "batch"},
]


@pytest.mark.parametrize("raw", SOFTMAX_CASES,
                         ids=["plain", "grad_scale", "batch", "ignore_valid",
                              "ignore_scale", "valid", "multi_output"])
def test_softmax_output_forward_and_gradient(raw):
    rng = np.random.RandomState(6)
    multi = raw.get("multi_output") == "True"
    x = _rand(rng, 6, 5, 3) if multi else _rand(rng, 6, 5)
    label = rng.randint(0, 5, (6, 3) if multi else (6,)).astype(np.float32)
    cot = rng.rand(*x.shape).astype(np.float32)
    (jo, jg, _), (to, tg, _) = _run("SoftmaxOutput", raw, [x, label],
                                    cot=cot)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg[0], np.asarray(jg[0]), rtol=1e-5,
                               atol=1e-6)
    assert not np.asarray(jg[1]).any()      # the label gets no gradient


SOFTMAX_SHAPES = [(64, 1000), (8, 10), (3, 16384), (37, 1001)]


@pytest.mark.parametrize("shape", SOFTMAX_SHAPES,
                         ids=["x".join(map(str, s)) for s in SOFTMAX_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_version_matches_jax_softmax_rows(shape, dtype):
    """K1's plain version against the JAX package's own CPU route of
    nn_ops._softmax_rows (its Pallas kernel has no interpret switch)."""
    rng = np.random.RandomState(7)
    x = (4.0 * rng.randn(*shape)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    want = np.asarray(jnn._softmax_rows(jx).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    before = tnn.softmax_rows.launches
    got = tnn.softmax_rows(tx)
    assert tnn.softmax_rows.launches == before     # CPU: no kernel launch
    assert got.dtype == tx.dtype and tuple(got.shape) == shape
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_k1_dispatch_rule():
    x = torch.randn(4, 3, 5)
    assert torch.equal(tnn._softmax_rows(x), torch.softmax(x, dim=-1))
    wide = torch.randn(2, tnn.SOFTMAX_MAX_COLS + 1)
    assert torch.equal(tnn._softmax_rows(wide), torch.softmax(wide, dim=-1))
    f64 = torch.randn(2, 5, dtype=torch.float64)
    assert torch.equal(tnn._softmax_rows(f64), torch.softmax(f64, dim=-1))
    ok = torch.randn(3, 7)
    assert torch.equal(tnn._softmax_rows(ok), tnn.softmax_rows_ref(ok))


@pytest.mark.parametrize("bad,match", [
    (torch.randn(2, 3, 4), r"\[N, C\]"),
    (torch.randn(2, 3, dtype=torch.float64), "float32 or bfloat16"),
    (torch.randn(1, tnn.SOFTMAX_MAX_COLS + 1), "columns"),
])
def test_k1_wrapper_rejects(bad, match):
    with pytest.raises(MXNetError, match=match):
        tnn.softmax_rows(bad)


@pytest.mark.parametrize("ncols,want", [
    (1, "warp"), (1000, "warp"), (1024, "warp"), (1025, "block"),
    (16384, "block"),
])
def test_k1_form_by_columns(ncols, want):
    assert tnn.softmax_rows_form(ncols) == want
    x = torch.randn(2, ncols)
    k1 = tnn.softmax_rows
    before = (k1.launches, dict(k1.launches_by_form))
    # on the CPU every allowed form runs the plain version, uncounted
    for form in (None, "block", want):
        assert torch.equal(tnn.softmax_rows(x, form=form),
                           tnn.softmax_rows_ref(x))
    assert (k1.launches, k1.launches_by_form) == before


@pytest.mark.parametrize("ncols,form", [(1025, "warp"), (16384, "warp"),
                                        (10, "row"), (10, "hopper")])
def test_k1_form_refusals(ncols, form):
    with pytest.raises(MXNetError, match=f"form '{form}'"):
        tnn.softmax_rows(torch.randn(3, ncols), form=form)


def test_unported_options_raise():
    x = torch.randn(2, 3, requires_grad=True)
    # MoEFFN is ported (tests/test_torch_moe.py): its forward is the JAX
    # op's on the same inputs
    moe, jmoe = tget_op("MoEFFN"), jget_op("MoEFFN")
    raw = {"num_experts": "2", "hidden_size": "4", "aux_loss": "True"}
    rng = np.random.RandomState(0)
    ins = [x.detach().numpy()] + [rng.randn(*s).astype(np.float32)
                                  for s in ((3, 2), (2, 3, 4), (2, 4),
                                            (2, 4, 3), (2, 3))]
    tout = moe.forward(TCtx(), moe.parse_params(raw),
                       *[torch.from_numpy(a) for a in ins])
    jout = jmoe.forward(JCtx(), jmoe.parse_params(raw),
                        *[jnp.asarray(a) for a in ins])
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    # FullyConnected(quant='fp8') is ported: the block-scaled fp8 product
    # (tests/test_torch_quant.py holds it against the JAX package)
    fc = tget_op("FullyConnected")
    w = torch.randn(2, 3)
    out = fc.forward(TCtx(), fc.parse_params({"num_hidden": "2",
                                              "quant": "fp8"}),
                     x, w, torch.zeros(2))
    from mxnet_tpu_torch import quant
    assert out.shape == (2, 2) and out.dtype == torch.float32
    assert torch.equal(out, quant.fp8_linear(x, w,
                                             quant.resolve_quant("fp8")))
