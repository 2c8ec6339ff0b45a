"""Paged KV cache of the PyTorch port (mxnet_tpu_torch/serve/kvcache.py)
against the JAX package's ``mxnet_tpu/serve/kvcache.py``.

* ``write_prefill`` / ``write_decode`` land the same values in the same
  slots, bitwise (the trash block, where padding collides, is excluded);
* ``BlockAllocator`` follows the same alloc / free / release / reuse /
  defrag sequence;
* ``paged_attention`` (scan, dense, flash) matches the JAX impls within
  rtol 1e-5 / atol 1e-6, and paged equals dense within the port bitwise,
  the invariant the JAX package pins for itself;
* fp8 pools (``QuantPool``): writes give the JAX package's payload bytes
  and scales bitwise; ``paged_attention`` and ``paged_prefill_attention``
  on f32 and fp8 pools match JAX within rtol 1e-5 / atol 1e-6 (f32
  summation order; the dequantized values are equal); ``pool_nbytes``,
  ``kv_bytes_per_token``, ``scrub_blocks`` and ``compact_pool`` act on
  both leaves as JAX's do;
* ``PrefixIndex`` chain hashes are the JAX package's bytes, and match /
  publish / drop / remap / invalidate follow the same sequence.
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
    """Pool shapes and helpers; fp8 pools are ported now, and a format
    other than fp8 (or an unknown impl) still raises."""
    k, v = tkv.make_pools(NL, NB, BS, H, HD, dtype=torch.bfloat16,
                          device="cpu")
    assert k.shape == (NL, NB, BS, H, HD) and k.dtype == torch.bfloat16
    assert k.data_ptr() != v.data_ptr() and not k.any()
    assert tkv.layer_view(k, 1).shape == (NB, BS, H, HD)
    assert tkv.kv_bytes_per_token(6, 8, 64) == \
        jkv.kv_bytes_per_token(6, 8, 64)
    assert tkv.kv_bytes_per_token(6, 8, 64, dtype=torch.bfloat16) == \
        jkv.kv_bytes_per_token(6, 8, 64, dtype=jnp.bfloat16)
    kq, vq = tkv.make_pools(NL, NB, BS, H, HD, quant="fp8", device="cpu")
    assert tkv.is_quantized(kq) and kq.payload.dtype == torch.float8_e4m3fn
    assert kq.scale.shape == (NL, NB, BS) and kq.scale.dtype == torch.float32
    assert kq.payload.data_ptr() != vq.payload.data_ptr()
    view = tkv.layer_view(kq, 1)
    assert view.payload.shape == (NB, BS, H, HD) and view.scale.shape == \
        (NB, BS)
    for bad in (lambda: tkv.make_pools(1, 4, 4, 1, 8, quant="int4",
                                       device="cpu"),
                lambda: tkv.kv_bytes_per_token(6, 8, 64, quant="int4"),
                lambda: tkv.paged_attention(
                    torch.zeros(1, 1, 8), k[0, :, :, :1], v[0, :, :, :1],
                    torch.zeros(1, 2, dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32), impl="bogus")):
        with pytest.raises(MXNetError):
            bad()
    k[:, 3] = float("nan")
    tkv.scrub_blocks(k, [3])
    assert not k.isnan().any()


# ---------------------------------------------------------------------------
# fp8 pools
# ---------------------------------------------------------------------------

def _qpools():
    return (jkv.make_pools(NL, NB, BS, H, HD, quant="fp8")[0],
            tkv.make_pools(NL, NB, BS, H, HD, quant="fp8", device="cpu")[0])


def _assert_qpool_equal(tpool, jpool, skip_trash=True):
    lo = 1 if skip_trash else 0
    np.testing.assert_array_equal(
        tpool.payload.view(torch.uint8)[:, lo:].numpy(),
        np.asarray(jpool.payload).view(np.uint8)[:, lo:])
    np.testing.assert_array_equal(
        tpool.scale[:, lo:].numpy().view(np.uint32),
        np.asarray(jpool.scale).view(np.uint32)[:, lo:])


@pytest.mark.parametrize("length,start", [(10, 0), (3, 0), (16, 0), (7, 8),
                                          (13, 4)])
def test_fp8_write_prefill_matches_jax_bitwise(length, start):
    """Each position row quantized to e4m3 with its own f32 scale: payload
    bytes and scales equal JAX's (the trash block, where padding collides,
    is excluded)."""
    rng = np.random.RandomState(length + start)
    states = (rng.randn(16, H, HD) * rng.choice([0.1, 3.0], (16, 1, 1))
              ).astype(np.float32)
    table = np.asarray([5, 2, 9, 0, 0], np.int32)
    jpool, tpool = _qpools()
    for layer in range(NL):
        jpool = jkv.write_prefill(jpool, layer,
                                  jnp.asarray(states * (layer + 1)),
                                  jnp.asarray(table), jnp.int32(length),
                                  start=start)
        out = tkv.write_prefill(tpool, layer,
                                torch.from_numpy(states * (layer + 1)),
                                torch.from_numpy(table), length, start=start)
        assert out is tpool                          # written in place
    _assert_qpool_equal(tpool, jpool)
    assert (tpool.scale[:, 1:].count_nonzero() > 0) == (length > start)


def test_fp8_write_decode_matches_jax_bitwise():
    rng = np.random.RandomState(0)
    states = rng.randn(4, H, HD).astype(np.float32)
    slots = np.asarray([3, 7, 7, 11], np.int32)
    offsets = np.asarray([0, 1, 2, 3], np.int32)
    active = np.asarray([True, True, False, True])
    jpool, tpool = _qpools()
    jpool = jkv.write_decode(jpool, 1, jnp.asarray(states), jnp.asarray(slots),
                             jnp.asarray(offsets), jnp.asarray(active))
    tkv.write_decode(tpool, 1, torch.from_numpy(states),
                     torch.from_numpy(slots), torch.from_numpy(offsets),
                     torch.from_numpy(active))
    _assert_qpool_equal(tpool, jpool)
    assert tpool.scale[1, 7, 2] == 0                 # inactive row: trash


def _quantize(mod, pool, arr):
    """A one-layer QuantPool of a [NB, BS, H, hd] numpy pool, quantized by
    ``mod``'s ``rowwise_quantize`` (JAX's or the port's)."""
    nb, bs = pool.shape[:2]
    if mod is jkv:
        from mxnet_tpu.quant import rowwise_quantize
    else:
        from mxnet_tpu_torch.quant import rowwise_quantize
    pay, sc = rowwise_quantize(arr(pool.reshape(nb * bs, H, HD)), "e4m3")
    return mod.QuantPool(pay.reshape(pool.shape), sc.reshape(nb, bs))


@pytest.mark.parametrize("impl", ["scan", "dense", "flash"])
def test_fp8_paged_attention_matches_jax(impl):
    q, kd, vd, kp, vp, tables, lengths = _paged()
    jk, jv = (_quantize(jkv, p, jnp.asarray) for p in (kp, vp))
    tk, tv = (_quantize(tkv, p, torch.from_numpy) for p in (kp, vp))
    want = np.asarray(jkv.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lengths),
        impl="dense" if impl == "flash" else impl))
    got = tkv.paged_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(tables),
                              torch.from_numpy(lengths), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    f32 = tkv.paged_attention(*(torch.from_numpy(a) for a in
                                (q, kp, vp, tables, lengths)), impl=impl)
    err = (got - f32).abs().max().item()
    assert 0 < err < 0.05                            # the fp8 read's bound


@pytest.mark.parametrize("quant", [None, "fp8"])
@pytest.mark.parametrize("start,length,c", [(0, 3, 4), (4, 11, 8),
                                            (8, 18, 4), (12, 20, 8)])
def test_paged_prefill_attention_matches_jax(quant, start, length, c):
    """One chunk of ``c`` queries from ``start`` over a 5-block table:
    ``start > 0`` and chunks whose tail passes ``length``."""
    q, kd, vd, kp, vp, tables, _ = _paged(seed=start + c)
    qc = np.random.RandomState(length).randn(c, H, HD).astype(np.float32)
    row = tables[0]
    if quant:
        jk, jv = (_quantize(jkv, p, jnp.asarray) for p in (kp, vp))
        tk, tv = (_quantize(tkv, p, torch.from_numpy) for p in (kp, vp))
    else:
        jk, jv = jnp.asarray(kp), jnp.asarray(vp)
        tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
    want = np.asarray(jkv.paged_prefill_attention(
        jnp.asarray(qc), jk, jv, jnp.asarray(row), jnp.int32(start),
        jnp.int32(length)))
    got = tkv.paged_prefill_attention(torch.from_numpy(qc), tk, tv,
                                      torch.from_numpy(row), start, length)
    assert got.shape == (c, H, HD)
    valid = start + np.arange(c) < length            # padded rows: garbage
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=1e-5,
                               atol=1e-6)


def test_pool_nbytes_and_bytes_per_token_match_jax():
    hd = 64
    for quant in (None, "fp8"):
        jp = jkv.make_pools(6, 9, 16, 8, hd, quant=quant)
        tp = tkv.make_pools(6, 9, 16, 8, hd, quant=quant, device="cpu")
        assert tkv.pool_nbytes(*tp) == jkv.pool_nbytes(*jp)
        assert tkv.kv_bytes_per_token(6, 8, hd, quant) == \
            jkv.kv_bytes_per_token(6, 8, hd, quant)
    # fp8: a quarter of f32's payload plus one scale per position
    assert tkv.kv_bytes_per_token(6, 8, hd, "fp8") == 2 * 6 * (8 * hd + 4)
    assert 3 * tkv.kv_bytes_per_token(6, 8, hd, "fp8") < \
        tkv.kv_bytes_per_token(6, 8, hd)


@pytest.mark.parametrize("quant", [None, "fp8"])
def test_scrub_and_compact_act_on_both_leaves(quant):
    rng = np.random.RandomState(4)
    states = rng.randn(16, H, HD).astype(np.float32)
    table = np.asarray([5, 2, 9, 12], np.int32)
    if quant:
        jpool, tpool = _qpools()
    else:
        jpool, tpool = _pools()
    for layer in range(NL):
        jpool = jkv.write_prefill(jpool, layer, jnp.asarray(states),
                                  jnp.asarray(table), jnp.int32(16))
        tkv.write_prefill(tpool, layer, torch.from_numpy(states),
                          torch.from_numpy(table), 16)
    mapping = {9: 1, 12: 3, 2: 12}                   # a cycle through 12
    jpool = jkv.compact_pool(jkv.scrub_blocks(jpool, [5]), mapping)
    assert tkv.compact_pool(tkv.scrub_blocks(tpool, [5]), mapping) is tpool
    if quant:
        _assert_qpool_equal(tpool, jpool, skip_trash=False)
        assert not tpool.scale[:, 5].any()
        assert not tpool.payload.view(torch.uint8)[:, 5].any()
    else:
        np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))


# ---------------------------------------------------------------------------
# PrefixIndex
# ---------------------------------------------------------------------------

def test_prefix_index_hashes_are_jax_bytes():
    rng = np.random.RandomState(5)
    toks = rng.randint(0, 32000, 23).tolist()
    for bs in (1, 4, 16):
        j, t = jkv.PrefixIndex(bs), tkv.PrefixIndex(bs)
        assert t.chain_hashes(toks) == j.chain_hashes(toks)
        j.version = t.version = 3
        assert t.chain_hashes(toks) == j.chain_hashes(toks)
    assert tkv.PrefixIndex(4).chain_hashes([2 ** 40, -1, 0, 7]) == \
        jkv.PrefixIndex(4).chain_hashes([2 ** 40, -1, 0, 7])
    with pytest.raises(MXNetError):
        tkv.PrefixIndex(0)


def _prefix_trace(mod):
    """Drive one index through match / publish / drop / remap /
    invalidate; record every result."""
    idx = mod.PrefixIndex(block_size=4)
    toks = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]
    h = idx.chain_hashes(toks)
    out = [len(h), idx.chain_hashes(toks[:7]) == h[:1], idx.match(toks)]
    out += [idx.publish(h[0], 5), idx.publish(h[1], 9), idx.match(toks),
            idx.match(toks[:6]), idx.match([2] + toks[1:])]
    out += [idx.publish(h[2], 11)]
    idx.drop_block(9)
    out += [idx.match(toks)]
    idx.drop_block(9)
    out += [idx.publish(h[0], 7), idx.publish(h[1], 5),
            idx.contains_block(5), idx.contains_block(9), len(idx)]
    idx.remap({5: 2, 11: 3})
    out += [idx.match(toks[:4]), idx.invalidate(), len(idx), idx.version,
            idx.match(toks), idx.chain_hashes(toks) != h]
    return out


def test_prefix_index_matches_jax():
    assert _prefix_trace(tkv) == _prefix_trace(jkv)


def test_allocator_cache_side_matches_jax():
    """The allocator's LRU side-cache (cache_filter, on_evict, cache_cap,
    uncache, defrag of cached slots), driven alike in both packages."""
    def trace(mod):
        al = mod.BlockAllocator(num_blocks=10, block_size=4, cache_cap=3)
        ev = []
        al.cache_filter = lambda b: b % 2 == 1
        al.on_evict = ev.append
        a = al.alloc(6, "a")
        al.release(a, "a")
        out = [al.num_cached, al.num_free, al.num_available, list(ev)]
        got = al.alloc(8, "b")
        out += [got, list(ev), al.num_cached]
        al.release(got[:4], "b")
        al.uncache([got[0]])
        out += [al.num_cached, sorted(al.defrag().items()),
                al.owned_by("b"), al.num_free]
        return out

    assert trace(tkv) == trace(jkv)
