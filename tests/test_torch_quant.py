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
