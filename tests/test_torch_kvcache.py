"""Paged KV cache of the PyTorch port (mxnet_tpu_torch/serve/kvcache.py)
against the JAX package's ``mxnet_tpu/serve/kvcache.py``.

* ``write_prefill`` / ``write_decode`` land the same values in the same
  slots, bitwise (the trash block, where padding collides, is excluded);
* ``BlockAllocator`` follows the same alloc / free / release / reuse /
  defrag sequence;
* ``paged_attention`` (scan, dense, flash) matches the JAX impls within
  rtol 1e-5 / atol 1e-6, and paged equals dense within the port bitwise,
  the invariant the JAX package pins for itself.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.serve import kvcache as jkv
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import kvcache as tkv

NL, NB, BS, H, HD = 2, 16, 4, 4, 8


def _pools():
    return (jnp.zeros((NL, NB, BS, H, HD), jnp.float32),
            tkv.make_pools(NL, NB, BS, H, HD, device="cpu")[0])


@pytest.mark.parametrize("length,start", [(10, 0), (3, 0), (16, 0), (7, 8)])
def test_write_prefill_matches_jax_bitwise(length, start):
    rng = np.random.RandomState(length + start)
    states = rng.randn(16, H, HD).astype(np.float32)
    table = np.asarray([5, 2, 9, 0, 0], np.int32)
    jpool, tpool = _pools()
    for layer in range(NL):
        jpool = jkv.write_prefill(jpool, layer, jnp.asarray(states * (layer + 1)),
                                  jnp.asarray(table), jnp.int32(length),
                                  start=start)
        out = tkv.write_prefill(tpool, layer,
                                torch.from_numpy(states * (layer + 1)),
                                torch.from_numpy(table), length, start=start)
        assert out is tpool                          # written in place
    np.testing.assert_array_equal(tpool[:, 1:].numpy(),
                                  np.asarray(jpool)[:, 1:])


def test_write_decode_matches_jax_bitwise():
    rng = np.random.RandomState(0)
    states = rng.randn(4, H, HD).astype(np.float32)
    slots = np.asarray([3, 7, 7, 11], np.int32)
    offsets = np.asarray([0, 1, 2, 3], np.int32)
    active = np.asarray([True, True, False, True])
    jpool, tpool = _pools()
    jpool = jkv.write_decode(jpool, 1, jnp.asarray(states), jnp.asarray(slots),
                             jnp.asarray(offsets), jnp.asarray(active))
    tkv.write_decode(tpool, 1, torch.from_numpy(states),
                     torch.from_numpy(slots), torch.from_numpy(offsets),
                     torch.from_numpy(active))
    np.testing.assert_array_equal(tpool[:, 1:].numpy(),
                                  np.asarray(jpool)[:, 1:])
    assert not tpool[1, 7, 2].any()                  # inactive row: trash


def _allocator_trace(mod, err):
    """Drive one allocator through a fixed sequence; record every result."""
    al = mod.BlockAllocator(num_blocks=10, block_size=4)
    out = [al.num_free, al.blocks_for_tokens(1), al.blocks_for_tokens(5)]
    a = al.alloc(3, "a")
    b = al.alloc(2, "b")
    out += [a, b, al.num_used]
    al.release(a, "a")
    out += [al.alloc(2, "c"), al.num_free]
    al.addref(b[0], "d")
    out += [al.refcount(b[0])]
    al.release(b, "b")
    out += [al.num_used, al.owned_by("d"), al.can_alloc(8), al.can_alloc(9)]
    out += [sorted(al.defrag().items()), al.owned_by("c"), al.owned_by("d")]
    for bad in (lambda: al.alloc(99, "e"), lambda: al.free([9]),
                lambda: al.release([1], "zz")):
        with pytest.raises(err):
            bad()
    al.free(al.owned_by("c"))
    out += [al.alloc(4, "f"), al.num_free]
    return out


def test_block_allocator_matches_jax():
    assert _allocator_trace(tkv, MXNetError) == \
        _allocator_trace(jkv, JaxMXNetError)


def _paged(seed=7, B=3, NBLK=5, NPOOL=32):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, HD).astype(np.float32)
    kd = rng.randn(B, NBLK * BS, H, HD).astype(np.float32)
    vd = rng.randn(B, NBLK * BS, H, HD).astype(np.float32)
    lengths = np.array([18, 5, 11], np.int32)
    perm = rng.permutation(np.arange(1, NPOOL))[:B * NBLK].reshape(B, NBLK)
    kp = np.zeros((NPOOL, BS, H, HD), np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):
        for j in range(NBLK):
            kp[perm[b, j]] = kd[b, j * BS:(j + 1) * BS]
            vp[perm[b, j]] = vd[b, j * BS:(j + 1) * BS]
    return q, kd, vd, kp, vp, perm.astype(np.int32), lengths


@pytest.mark.parametrize("impl", ["scan", "dense", "flash"])
def test_paged_attention_matches_jax(impl):
    q, kd, vd, kp, vp, tables, lengths = _paged()
    want = np.asarray(jkv.paged_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)),
        impl="dense" if impl == "flash" else impl))
    got = tkv.paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)),
        impl=impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_paged_equals_dense_bitwise():
    q, kd, vd, kp, vp, tables, lengths = _paged()
    t = {k: torch.from_numpy(v) for k, v in dict(
        q=q, kd=kd, vd=vd, kp=kp, vp=vp, tables=tables,
        lengths=lengths).items()}
    paged = tkv.paged_attention(t["q"], t["kp"], t["vp"], t["tables"],
                                t["lengths"])
    dense = tkv.dense_attention(t["q"], t["kd"], t["vd"], t["lengths"],
                                block_size=BS)
    assert torch.equal(paged, dense)                 # paging is a gather
    want = np.asarray(jkv.dense_attention(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
        jnp.asarray(lengths), block_size=BS))
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-5, atol=1e-6)


def test_pool_helpers_and_unported_quant():
    k, v = tkv.make_pools(NL, NB, BS, H, HD, dtype=torch.bfloat16,
                          device="cpu")
    assert k.shape == (NL, NB, BS, H, HD) and k.dtype == torch.bfloat16
    assert k.data_ptr() != v.data_ptr() and not k.any()
    assert tkv.layer_view(k, 1).shape == (NB, BS, H, HD)
    assert tkv.kv_bytes_per_token(6, 8, 64) == \
        jkv.kv_bytes_per_token(6, 8, 64)
    assert tkv.kv_bytes_per_token(6, 8, 64, dtype=torch.bfloat16) == \
        jkv.kv_bytes_per_token(6, 8, 64, dtype=jnp.bfloat16)
    for bad in (lambda: tkv.make_pools(1, 4, 4, 1, 8, quant="fp8",
                                       device="cpu"),
                lambda: tkv.kv_bytes_per_token(6, 8, 64, quant="fp8"),
                lambda: tkv.QuantPool(None, None),
                lambda: tkv.paged_attention(
                    torch.zeros(1, 1, 8), k[0, :, :, :1], v[0, :, :, :1],
                    torch.zeros(1, 2, dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32), impl="bogus")):
        with pytest.raises(MXNetError):
            bad()
    k[:, 3] = float("nan")
    tkv.scrub_blocks(k, [3])
    assert not k.isnan().any()
