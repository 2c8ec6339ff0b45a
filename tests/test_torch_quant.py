"""fp8 quantization of the PyTorch port (mxnet_tpu_torch/quant.py) against
the JAX package's ``mxnet_tpu/quant.py``.

``rowwise_quantize`` gives the JAX package's payload bytes and f32 scales
BITWISE: e4m3 and e5m2, f32 and bf16 input, rows whose magnitudes span
0.01 to 30, all-zero rows (scale clamped to 1e-30 / max, payload 0) and
rows of one huge element.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import quant as jq
from mxnet_tpu_torch import quant as tq
from mxnet_tpu_torch.base import MXNetError


def _rows(seed, shape=(257, 4, 8)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.choice([0.01, 1.0, 30.0],
                                        (shape[0],) + (1,) * (len(shape) - 1))
         ).astype(np.float32)
    x[3] = 0.0                       # a zero row: the 1e-30 clamp
    x[5] = 0.0
    x[5].flat[0] = 1e6               # one element carries the whole row
    return x


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(257, 4, 8), (64, 96), (33, 2, 3, 5)])
def test_rowwise_quantize_bitwise_equals_jax(fmt, dtype, shape):
    x = _rows(len(shape) + (fmt == "e5m2"), shape)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    qj, sj = jq.rowwise_quantize(xj, fmt)
    qt, st = tq.rowwise_quantize(xt, fmt)
    assert qt.dtype == tq.FP8_DTYPES[fmt] and qt.shape == x.shape
    assert st.dtype == torch.float32 and st.shape == (shape[0],)
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(),
                                  np.asarray(qj).view(np.uint8))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))
    # the row absmax lands on the format's maximum: no overflow to NaN
    assert torch.isfinite(qt.float()).all()
    assert qt.float().abs().amax().item() == tq.FP8_MAX[fmt]


def test_rowwise_quantize_zero_row_and_round_trip():
    x = torch.from_numpy(_rows(0))
    q, s = tq.rowwise_quantize(x, "e4m3")
    assert not q[3].float().any() and s[3].item() == np.float32(1e-30 / 448)
    back = q.float() * s[:, None, None]
    rel = ((back - x).abs().amax(dim=(1, 2))
           / x.abs().amax(dim=(1, 2)).clamp_min(1e-30))
    assert rel.max().item() <= 2 ** -4        # e4m3: 3 mantissa bits
    assert tq.FP8_MAX == jq.FP8_MAX


def test_rowwise_quantize_rejects_unknown_format():
    with pytest.raises(MXNetError, match="unknown fp8 format"):
        tq.rowwise_quantize(torch.zeros(2, 3), "e3m4")


# ---------------------------------------------------------------------------
# The compute half: block scales, the fp8 product, fp8_linear, the policy
# ---------------------------------------------------------------------------

def _operand(seed, shape):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.choice([0.01, 1.0, 30.0], (shape[0], 1))
         ).astype(np.float32)
    x[1] = 0.0                        # a zero row: the 1e-30 clamp
    return x


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("shape,block", [((33, 300), 128), ((16, 256), 128),
                                         ((7, 50), 16)])
def test_block_quantize_bitwise_equals_jax(fmt, shape, block):
    """Payload bytes and f32 scales equal the JAX package's, with the
    contraction ragged against the block (zero-padded)."""
    x = _operand(shape[1], shape)
    qj, sj = jq.block_quantize(jnp.asarray(x), fmt, block)
    qt, st = tq.block_quantize(torch.from_numpy(x), fmt, block)
    nb = -(-shape[1] // block)
    assert qt.shape == (nb, shape[0], block) and st.shape == (nb, shape[0], 1)
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(),
                                  np.asarray(qj).view(np.uint8))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))


def _close_f32(got, want, terms, what):
    """Within the f32 summation-order bound: the products are the same
    (fp8 values are exact in f32), only their order of summation
    differs, by at most 1e-5 of the magnitude (``terms``: the same sum
    over absolute values; 128 terms a block at 2^-24 each)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= 1e-5 * np.asarray(terms) + 1e-30), (
        what, float(err.max()))


@pytest.mark.parametrize("fmts", [("e4m3", "e4m3"), ("e5m2", "e4m3"),
                                  ("e5m2", "e5m2")])
def test_fp8_dot_matches_jax(fmts):
    a, b = _operand(1, (24, 300)), _operand(2, (40, 300))
    got = tq.fp8_dot(torch.from_numpy(a), torch.from_numpy(b), *fmts, 128)
    want = np.asarray(jq.fp8_dot(jnp.asarray(a), jnp.asarray(b), *fmts, 128))
    qa, sa = tq.block_quantize(torch.from_numpy(a), fmts[0], 128)
    qb, sb = tq.block_quantize(torch.from_numpy(b), fmts[1], 128)
    terms = tq.block_dot_ref(
        qa.float().abs().to(qa.dtype), sa, qb.float().abs().to(qb.dtype), sb)
    assert got.dtype == torch.float32 and got.shape == (24, 40)
    _close_f32(got.numpy(), want, terms.numpy(), fmts)
    # on CPU tensors the plain version runs, with no route counted
    assert tq.block_dot_route(qa, qb) == "plain"


POLICIES = {"fwd+bwd": ("e4m3", "e5m2"), "fwd-only": ("e4m3", None),
            "bwd-only": (None, "e5m2")}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_fp8_linear_forward_and_gradients_match_jax(policy):
    import jax
    fwd, bwd = POLICIES[policy]
    x, w = _operand(3, (20, 260)), _operand(4, (36, 260))
    g = _operand(5, (20, 36))
    jcfg = jq.QuantConfig(fwd=fwd, bwd=bwd, block=128)
    tcfg = tq.QuantConfig(fwd=fwd, bwd=bwd, block=128)
    jout, vjp = jax.vjp(lambda a, b: jq.fp8_linear(a, b, jcfg),
                        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = tq.fp8_linear(xt, wt, tcfg)
    out.backward(torch.from_numpy(g))
    # magnitudes of each product's terms (for the summation-order bound)
    ax, aw, ag = np.abs(x), np.abs(w), np.abs(g)
    for got, want, terms in ((out.detach(), jout, ax @ aw.T),
                             (xt.grad, jdx, ag @ aw),
                             (wt.grad, jdw, ag.T @ ax)):
        _close_f32(got.numpy(), np.asarray(want), 2 * terms, policy)


def test_resolve_quant_env_and_symbol_uses_fp8(monkeypatch):
    from mxnet_tpu import models as jmodels
    from mxnet_tpu_torch import models as tmodels
    for spec in (None, False, True, "fp8",
                 tq.QuantConfig(fwd=None, bwd=None)):
        jspec = (jq.QuantConfig(fwd=None, bwd=None)
                 if isinstance(spec, tq.QuantConfig) else spec)
        want, got = jq.resolve_quant(jspec), tq.resolve_quant(spec)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.describe() == want.describe()
    with pytest.raises(MXNetError, match="unknown quant"):
        tq.resolve_quant("int4")
    with pytest.raises(MXNetError, match="QuantConfig.fwd"):
        tq.QuantConfig(fwd="e3m4")
    monkeypatch.setenv("MXNET_TPU_QUANT", "1")
    monkeypatch.setenv("MXNET_TPU_QUANT_BLOCK", "64")
    assert tq.resolve_quant(None).describe() == jq.resolve_quant(
        None).describe() == "fp8:e4m3:e5m2:b64"
    monkeypatch.setenv("MXNET_TPU_QUANT_BLOCK", "-3")
    with pytest.raises(MXNetError, match="MXNET_TPU_QUANT_BLOCK"):
        tq.default_block_size()
    monkeypatch.delenv("MXNET_TPU_QUANT_BLOCK")
    monkeypatch.setenv("MXNET_TPU_QUANT_EF", "0")
    for c in (None, "bf16", "int8", "fp8"):
        assert (tq.error_feedback_default(c)
                == jq.error_feedback_default(c))
        assert tq.wire_itemsize(c) == jq.wire_itemsize(c)
    assert tq.WIRE_ITEMSIZE == jq.WIRE_ITEMSIZE
    monkeypatch.delenv("MXNET_TPU_QUANT")
    for quant in ("fp8", None):
        kw = dict(vocab_size=61, num_layers=1, d_model=32, heads=2,
                  quant=quant)
        assert (tq.symbol_uses_fp8(tmodels.transformer_lm(**kw))
                == jq.symbol_uses_fp8(jmodels.transformer_lm(**kw))
                == (quant == "fp8"))
    assert not tq.symbol_uses_fp8(object())
