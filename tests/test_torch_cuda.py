"""The port's CUDA kernels on the card (marker ``cuda``).

These tests import torch and the port only, so they also run where JAX is
not installed.  Run them on a machine with an NVIDIA H100 and nvcc::

    python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere they skip.  Each kernel is held against its plain PyTorch
version on the same CUDA tensors: f32 within atol 2e-5 (summation order),
bf16 within 1e-2 (summation order and one bf16 rounding of the output).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import flash_decode as tfd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with `pytest -m cuda` on the "
                    "card")
    return torch.device("cuda")


def _operands(dev, seed, *, B, H, hd, BS, nblk, lengths, dtype,
              trash_rows=(), npool=96):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32))
    kp = torch.from_numpy(rng.randn(npool, BS, H, hd).astype(np.float32))
    vp = torch.from_numpy(rng.randn(npool, BS, H, hd).astype(np.float32))
    tables = np.zeros((B, nblk), np.int32)
    lens = np.asarray(lengths, np.int32).copy()
    for b in range(B):
        if b in trash_rows:
            lens[b] = 1
            continue
        used = -(-int(lens[b]) // BS)
        tables[b, :used] = rng.choice(np.arange(1, npool), used,
                                      replace=False)
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(tables).to(dev), torch.from_numpy(lens).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [8, 64, 100, 128, 256])
@pytest.mark.parametrize("split_k", [None, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda, hd, split_k, dtype):
    args = _operands(cuda, hd + (split_k or 0), B=5, H=3, hd=hd, BS=16,
                     nblk=20, lengths=[320, 1, 17, 200, 64], dtype=dtype,
                     trash_rows=(3,))
    before = tfd.flash_decode_attention.launches
    out = tfd.flash_decode_attention(*args, split_k=split_k)
    ref = tfd.flash_decode_attention_ref(*args, split_k=split_k)
    torch.cuda.synchronize()
    assert tfd.flash_decode_attention.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_flash_decode_kernel_rejects_wide_heads(cuda):
    args = _operands(cuda, 0, B=2, H=1, hd=512, BS=4, nblk=3,
                     lengths=[5, 9], dtype=torch.float32)
    with pytest.raises(MXNetError, match="head_dim"):
        tfd.flash_decode_attention(*args)
