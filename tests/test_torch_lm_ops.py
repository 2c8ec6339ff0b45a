"""Ops of the transformer-LM path in the PyTorch port (Reshape, Embedding,
LayerNorm, SoftmaxOutput's loss mode in ops/nn_ops.py; RingAttention and
MoEFFN in ops/attention_ops.py) against the JAX package's
``get_op(name).forward`` on the same numpy inputs, on the CPU; gradients
against ``jax.vjp`` of the same forward.

Tolerances: reshapes and gathers exact; LayerNorm and the loss head in
f32 within rtol/atol 1e-5 (reduction order of XLA and ATen); attention
within 2e-5 (forward) and 2e-4 (gradients), as in
tests/test_flash_attention.py.  bf16 inputs: LayerNorm's output within
one bf16 unit in the last place (rtol 2^-7) and the loss head within 1e-5
(its math is f32 in both packages; only the input is bf16).  Inputs are
float32 or bfloat16 explicitly (importing mxnet_tpu enables x64).
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.registry import OpContext as JCtx
from mxnet_tpu.ops.registry import get_op as jget_op

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import OpContext as TCtx
from mxnet_tpu_torch.ops.registry import get_op as tget_op
from mxnet_tpu_torch.parallel import flash_attention as tfa
# the port's `parallel.ring_attention` attribute is the function, as
# the JAX package's is: the module comes from sys.modules
tra = sys.modules["mxnet_tpu_torch.parallel.ring_attention"]

BF16 = (jnp.bfloat16, torch.bfloat16)


def _run(name, raw, inputs, *, cot=None, grad_of=None, dtype=None):
    """Forward and (with ``cot``) input gradients of op ``name`` in both
    packages on numpy ``inputs``; ``dtype`` (a (jax, torch) pair) casts
    the inputs listed in ``grad_of`` (default: all float32 inputs)."""
    jop, top = jget_op(name), tget_op(name)
    jp, tp = jop.parse_params(raw), top.parse_params(raw)
    grad_of = (range(len(inputs)) if grad_of is None else grad_of)
    jin, tin = [], []
    for i, x in enumerate(inputs):
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        if dtype is not None and i in grad_of:
            jx, tx = jx.astype(dtype[0]), tx.to(dtype[1])
        jin.append(jx)
        tin.append(tx.requires_grad_(i in grad_of))
    jfwd = lambda *xs: jop.forward(JCtx(is_train=True), jp, *xs)
    if cot is None:
        jout, jgrads = jfwd(*jin), None
    else:
        jout, vjp = jax.vjp(jfwd, *jin)
        jgrads = vjp(jnp.asarray(cot).astype(jout.dtype))
    tout = top.forward(TCtx(is_train=True), tp, *tin)
    tgrads = None
    if cot is not None:
        tout.backward(torch.from_numpy(cot).to(tout.dtype))
        tgrads = [None if t.grad is None else t.grad.float().numpy()
                  for t in tin]
    return (np.asarray(jout).astype(np.float32), jgrads, jout.dtype,
            tout.detach().float().numpy(), tgrads, tout.dtype)


@pytest.mark.parametrize("raw, in_shape", [
    ({"shape": "(-1, 8)"}, (2, 3, 8)),
    ({"shape": "(-1, 3, 2, 4)"}, (6, 8)),
    ({"shape": "(-1,)"}, (4, 5)),
    ({"target_shape": "(0, 12)"}, (2, 3, 4)),      # legacy: 0 = batch
    ({"shape": "(4, -1)"}, (2, 2, 6)),
])
def test_reshape_wildcards(raw, in_shape):
    x = np.arange(np.prod(in_shape), dtype=np.float32).reshape(in_shape)
    cot = np.random.RandomState(0).randn(*np.asarray(x).reshape(
        jget_op("Reshape").forward(JCtx(), jget_op("Reshape").parse_params(
            raw), jnp.asarray(x)).shape).shape).astype(np.float32)
    jo, jg, _, to, tg, _ = _run("Reshape", raw, [x], cot=cot)
    assert to.shape == jo.shape
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tg[0], np.asarray(jg[0]))
    top = tget_op("Reshape")
    _, outs, _ = top.infer_shape(top.parse_params(raw), [in_shape])
    assert outs == [jo.shape]
    with pytest.raises(MXNetError, match="shape"):
        top.forward(TCtx(), top.parse_params({}), torch.from_numpy(x))


def test_embedding_values_and_scatter_add_gradient():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 11, (3, 7)).astype(np.float32)
    ids[0, :3] = 4.0                   # repeated ids sum their gradients
    w = rng.randn(11, 5).astype(np.float32)
    cot = rng.randn(3, 7, 5).astype(np.float32)
    raw = {"input_dim": "11", "output_dim": "5"}
    jo, jg, _, to, tg, _ = _run("Embedding", raw, [ids, w], cot=cot,
                                grad_of=(1,))
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(tg[1], np.asarray(jg[1]), rtol=1e-6,
                               atol=1e-6)
    top = tget_op("Embedding")
    shapes, outs, _ = top.infer_shape(top.parse_params(raw), [(3, 7)])
    assert shapes[1] == (11, 5) and outs == [(3, 7, 5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_f32_statistics(dtype):
    rng = np.random.RandomState(2)
    x = (3.0 * rng.randn(4, 6, 16) + 1.0).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(16)).astype(np.float32)
    b = (0.1 * rng.randn(16)).astype(np.float32)
    cot = rng.randn(4, 6, 16).astype(np.float32)
    dt = BF16 if dtype == "bfloat16" else None
    jo, jg, jdt, to, tg, tdt = _run("LayerNorm", {}, [x, g, b], cot=cot,
                                    dtype=dt)
    assert str(tdt).replace("torch.", "") == str(jdt) == dtype
    if dtype == "float32":
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
        for a, e in zip(tg, jg):
            np.testing.assert_allclose(a, np.asarray(e), rtol=1e-5,
                                       atol=1e-5)
    else:
        np.testing.assert_allclose(to, jo, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("ignore", [None, 3.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_output_loss_mode(dtype, ignore):
    rng = np.random.RandomState(3)
    x = (2.0 * rng.randn(12, 9)).astype(np.float32)
    label = rng.randint(0, 9, 12).astype(np.float32)
    label[[1, 5, 6]] = 3.0
    raw = {"out_mode": "loss"}
    if ignore is not None:
        raw.update(use_ignore="True", ignore_label=str(ignore))
    cot = np.ones(12, np.float32)
    cot[2] = 0.5                         # a label-shaped cotangent
    dt = BF16 if dtype == "bfloat16" else None
    jo, jg, jdt, to, tg, tdt = _run("SoftmaxOutput", raw, [x, label],
                                    cot=cot, grad_of=(0,), dtype=dt)
    assert to.shape == (12,) and tdt == torch.float32
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    if ignore is not None:
        assert (to[[1, 5, 6]] == 0).all()
    gx = np.asarray(jg[0]).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(tg[0], gx, rtol=1e-5, atol=1e-6)
    else:
        # the gradient is rounded to bf16 in both packages at the end
        np.testing.assert_allclose(tg[0], gx, rtol=2 ** -7, atol=1e-6)
    if ignore is not None:
        assert (tg[0][[1, 5, 6]] == 0).all()
    # the probabilities head still runs K1's path, and the loss mode
    # gives the same gradient for a ones cotangent
    raw_p = {k: v for k, v in raw.items() if k != "out_mode"}
    *_, tgp, _ = _run("SoftmaxOutput", raw_p, [x, label],
                      cot=np.ones((12, 9), np.float32), grad_of=(0,))
    _, _, _, _, tgl, _ = _run("SoftmaxOutput", raw, [x, label],
                              cot=np.ones(12, np.float32), grad_of=(0,))
    np.testing.assert_array_equal(tgl[0], tgp[0])


ATTN = {
    # name: (layout, q shape, block_size, expected path)
    "bhld_dense_below_switch": ("bhld", (1, 2, 96, 8), 0, "dense"),
    "bhld_forced_dense": ("bhld", (1, 2, 128, 8), -1, "dense"),
    "bhld_explicit_block": ("bhld", (1, 2, 128, 8), 64, "flash"),
    "blhd_explicit_block": ("blhd", (2, 128, 2, 8), 64, "flash"),
    "blhd_ragged_padded": ("blhd", (1, 100, 2, 8), 64, "flash"),
    "bhld_ragged_padded": ("bhld", (1, 2, 100, 8), 64, "flash"),
    "blhd_dense": ("blhd", (1, 96, 2, 8), 0, "dense"),
    "blhd_auto_switch_1024": ("blhd", (1, 1024, 1, 8), 0, "flash"),
}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_ring_attention_op_paths(case):
    layout, shape, block, path = ATTN[case]
    rng = np.random.RandomState(len(case))
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    cot = rng.randn(*shape).astype(np.float32)
    raw = {"causal": "True", "layout": layout, "block_size": str(block)}
    dense0 = tra.local_attention.dense_calls
    blockwise0 = tra.blockwise_attention.calls
    jo, jg, _, to, tg, _ = _run("RingAttention", raw, [q, k, v], cot=cot)
    ran = {"dense": tra.local_attention.dense_calls - dense0,
           "blockwise": tra.blockwise_attention.calls - blockwise0}
    # the flash family runs the kernels' plain versions on the CPU
    assert ran == {"dense": int(path == "dense"), "blockwise": 0}
    assert to.shape == shape
    np.testing.assert_allclose(to, jo, rtol=2e-5, atol=2e-5)
    for n, a, e in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, np.asarray(e), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{n}")


def test_ring_attention_non_causal_cross_lengths():
    rng = np.random.RandomState(11)
    q = rng.randn(1, 64, 2, 8).astype(np.float32)
    k, v = (rng.randn(1, 128, 2, 8).astype(np.float32) for _ in range(2))
    raw = {"causal": "False", "layout": "blhd", "block_size": "64"}
    jo, _, _, to, _, _ = _run("RingAttention", raw, [q, k, v])
    np.testing.assert_allclose(to, jo, rtol=2e-5, atol=2e-5)


def test_ring_attention_shape_and_moe_not_ported():
    top = tget_op("RingAttention")
    p = top.parse_params({"layout": "blhd"})
    assert top.infer_shape(p, [(2, 16, 4, 8), None, None])[1] == \
        [(2, 16, 4, 8)]
    with pytest.raises(MXNetError, match="RingAttention expects"):
        top.infer_shape(p, [(2, 16, 8), None, None])
    moe = tget_op("MoEFFN")
    mp = moe.parse_params({"num_experts": "4", "hidden_size": "8"})
    jmoe = jget_op("MoEFFN")
    jmp = jmoe.parse_params({"num_experts": "4", "hidden_size": "8"})
    assert moe.infer_shape(mp, [(6, 5)]) == jmoe.infer_shape(jmp, [(6, 5)])
    # the forward is ported (tests/test_torch_moe.py): the JAX op's output
    # on the inferred shapes
    shapes, _, _ = moe.infer_shape(mp, [(6, 5)])
    rng = np.random.RandomState(1)
    ins = [rng.randn(*s).astype(np.float32) for s in shapes]
    tout = moe.forward(TCtx(), mp, *[torch.from_numpy(a) for a in ins])
    jout = jmoe.forward(JCtx(), jmp, *[jnp.asarray(a) for a in ins])
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)


def test_flash_kernels_are_not_launched_on_cpu_tensors():
    before = (tfa.flash_fwd.launches, tfa.flash_bwd.launches)
    q = torch.randn(1, 2, 64, 8, requires_grad=True)
    tfa.flash_attention(q, q, q, causal=True).sum().backward()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches) == before
