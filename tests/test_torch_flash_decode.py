"""Flash-decode of the PyTorch port (mxnet_tpu_torch/serve/flash_decode.py)
against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version
(``flash_decode_attention_ref``), the same split-K function the CUDA
kernel computes.  It is held against the JAX kernel run in interpret mode
and against ``kvcache.paged_attention(impl="dense")`` at the serve tests'
size (head_dim 8, 4 heads, block_size 4, 12 table columns), over ragged
lengths, every split count and engine-style trash rows.  Tolerance:
rtol 1e-5, atol 1e-6 (f32, summation order only).  The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.serve import kvcache as jkv
from mxnet_tpu.serve.flash_decode import default_split_k as jax_split_k
from mxnet_tpu.serve.flash_decode import flash_decode_attention as jax_flash
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import flash_decode as tfd

H, HD, BS, NBLK = 4, 8, 4, 12


def _setup(seed, lengths, trash_rows=(), npool=64):
    """Paged operands as numpy arrays: random pools, distinct random blocks
    per row; rows in ``trash_rows`` are padded as the engine pads them
    (table of trash slots, length 1)."""
    rng = np.random.RandomState(seed)
    b = len(lengths)
    q = rng.randn(b, H, HD).astype(np.float32)
    kp = rng.randn(npool, BS, H, HD).astype(np.float32)
    vp = rng.randn(npool, BS, H, HD).astype(np.float32)
    tables = np.zeros((b, NBLK), np.int32)
    lens = np.asarray(lengths, np.int32)
    free = iter(rng.permutation(np.arange(1, npool)))
    for i in range(b):
        if i in trash_rows:
            lens[i] = 1
            continue
        tables[i, :-(-int(lens[i]) // BS)] = [
            next(free) for _ in range(-(-int(lens[i]) // BS))]
    return q, kp, vp, tables, lens


def _jax(args):
    q, kp, vp, tables, lens = args
    return (jnp.asarray(q, jnp.float32), jnp.asarray(kp, jnp.float32),
            jnp.asarray(vp, jnp.float32), jnp.asarray(tables, jnp.int32),
            jnp.asarray(lens, jnp.int32))


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


CASES = {
    "ragged": dict(lengths=[37, 5, 48, 19]),
    "one_position": dict(lengths=[1]),
    "full_tables": dict(lengths=[48, 48]),
    "trash_rows": dict(lengths=[30, 9, 9, 12], trash_rows=(1, 2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("split_k", [None, 1, 2, 3, 8])
def test_plain_version_matches_jax_kernel(case, split_k):
    args = _setup(sum(map(ord, case)), **CASES[case])
    want = np.asarray(jax_flash(*_jax(args), split_k=split_k,
                                interpret=True))
    dense = np.asarray(jkv.paged_attention(*_jax(args), impl="dense"))
    before = tfd.flash_decode_attention.launches
    got = tfd.flash_decode_attention(*_torch(args), split_k=split_k)
    assert tfd.flash_decode_attention.launches == before   # no kernel on CPU
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-6)


def test_split_plan_matches_jax():
    for n in list(range(1, 70)) + [1024]:
        assert tfd.default_split_k(n) == jax_split_k(n)
    assert tfd.split_plan(12) == (2, 6)
    assert tfd.split_plan(20, 3) == (3, 7)        # trash-padded tail
    assert tfd.split_plan(4, 8) == (4, 1)         # capped at the columns
    with pytest.raises(MXNetError):
        tfd.split_plan(12, 0)


def test_wrapper_rejects_bad_inputs():
    q, kp, vp, tables, lens = _torch(_setup(3, [9, 4]))
    with pytest.raises(MXNetError, match="int32"):
        tfd.flash_decode_attention(q, kp, vp, tables.long(), lens)
    with pytest.raises(MXNetError, match="int32"):
        tfd.flash_decode_attention(q, kp, vp, tables, lens.long())
    with pytest.raises(MXNetError, match="lengths"):
        tfd.flash_decode_attention(q, kp, vp, tables, lens[:1])
    with pytest.raises(MXNetError, match="tables"):
        tfd.flash_decode_attention(q, kp, vp, tables[:1], lens)
    with pytest.raises(MXNetError, match="heads"):
        tfd.flash_decode_attention(q[:, :2], kp, vp, tables, lens)
    with pytest.raises(MXNetError, match="dtype"):
        tfd.flash_decode_attention(q, kp, vp.bfloat16(), tables, lens)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        tfd.flash_decode_attention(q.double(), kp, vp, tables, lens)


def test_bf16_pool_plain_version_tracks_f32():
    """bf16 pools read through the plain version stay near the f32 answer
    (bf16 rounding of K/V and of the output only)."""
    q, kp, vp, tables, lens = _torch(_setup(5, [37, 5, 48, 19]))
    f32 = tfd.flash_decode_attention(q, kp, vp, tables, lens)
    bf = tfd.flash_decode_attention(q.bfloat16(), kp.bfloat16(),
                                    vp.bfloat16(), tables, lens)
    assert bf.dtype == torch.bfloat16
    assert (bf.float() - f32).abs().max().item() < 5e-2
