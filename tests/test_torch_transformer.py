"""Transformer-LM twins of the PyTorch port
(mxnet_tpu_torch/models/transformer.py) against the JAX package's.

Same numpy parameters and tokens on both sides, f32 and int32 pinned
(importing mxnet_tpu enables x64).  Prefill logits and K/V states, and
stepwise decode logits, agree within atol 1e-5 (f32 summation order).
``init_params`` is the dict the JAX serve tests build from the symbol:
same names, shapes, order and values.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.compile_cache import BucketPolicy as JaxBucketPolicy
from mxnet_tpu.compile_cache import bucket_for as jax_bucket_for
from mxnet_tpu.models.transformer import (transformer_lm,
                                          transformer_lm_decode_dense,
                                          transformer_lm_prefill)
from mxnet_tpu.parallel.ring_attention import \
    local_attention as jax_local_attention
from mxnet_tpu_torch import compile_cache as tcc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu, gpu, resolve_device
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.parallel.ring_attention import local_attention

V, NL, D, H = 61, 2, 32, 4


def _symbol_params(seed=0):
    """The JAX serve tests' recipe (tests/test_serve.py:_make_params)."""
    rng = np.random.RandomState(seed)
    sym = transformer_lm(vocab_size=V, num_layers=NL, d_model=D, heads=H,
                         batch_size=1, seq_len=8)
    shapes, _, _ = sym.infer_shape(data=(1, 8), softmax_label=(1, 8))
    return {n: (rng.randn(*s) * 0.05).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def test_init_params_is_the_symbols_dict():
    want = _symbol_params(seed=3)
    got = tt.init_params(V, NL, D, seed=3)
    assert list(got) == list(want)                   # names, in order
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])
    assert tt.lm_config_from_params(got) == (V, NL, D)


def test_params_from_numpy_and_devices():
    p = tt.params_from_numpy(tt.init_params(V, NL, D), device="cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in p.values())
    bf = tt.params_from_numpy(p, device=cpu(), dtype=torch.bfloat16)
    assert bf["embed_weight"].dtype == torch.bfloat16
    assert resolve_device("cpu") == torch.device("cpu")
    assert gpu(1).torch_device == torch.device("cuda", 1)
    with pytest.raises(MXNetError):
        resolve_device("mps")
    with pytest.raises(MXNetError):
        tt.lm_config_from_params({"embed_weight": p["embed_weight"]})


def test_resolve_device_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for dev in (None, "cuda", gpu(0)):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            resolve_device(dev)


def test_prefill_matches_jax():
    params = _symbol_params()
    toks = np.random.RandomState(1).randint(0, V, size=(2, 9)).astype(
        np.int32)
    jl, jks, jvs = transformer_lm_prefill(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(toks),
        heads=H)
    with torch.no_grad():
        tl, tks, tvs = tt.transformer_lm_prefill(
            tt.params_from_numpy(params, "cpu"), torch.from_numpy(toks),
            heads=H)
    assert tl.shape == (2, 9, V) and tks[0].shape == (2, 9, H, D // H)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for a, b in zip(tks + tvs, list(jks) + list(jvs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_decode_dense_matches_jax_and_prefill():
    """Stepwise decode over a dense cache: the port against JAX's
    ``transformer_lm_decode_dense`` and against its own full prefill."""
    params = _symbol_params()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = tt.params_from_numpy(params, "cpu")
    toks = np.array([[7, 3, 11, 2, 9, 1, 30, 12]], np.int32)
    hd = D // H
    jkc = jnp.zeros((NL, 1, 8, H, hd), jnp.float32)
    jvc = jnp.zeros((NL, 1, 8, H, hd), jnp.float32)
    tkc = torch.zeros((NL, 1, 8, H, hd))
    tvc = torch.zeros((NL, 1, 8, H, hd))
    with torch.no_grad():
        full, _, _ = tt.transformer_lm_prefill(tp, torch.from_numpy(toks),
                                               heads=H)
        for t in range(8):
            jlog, jkc, jvc = transformer_lm_decode_dense(
                jp, jnp.asarray(toks[:, t]), jnp.asarray([t], jnp.int32),
                jkc, jvc, heads=H)
            tlog, tkc, tvc = tt.transformer_lm_decode_dense(
                tp, torch.from_numpy(toks[:, t]),
                torch.tensor([t], dtype=torch.int32), tkc, tvc, heads=H)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       atol=1e-5)
            np.testing.assert_allclose(tlog[0].numpy(), full[0, t].numpy(),
                                       rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), atol=1e-5)


def test_local_attention_matches_jax():
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 3, 7, 8).astype(np.float32) for _ in range(3))
    for causal in (False, True):
        want = np.asarray(jax_local_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal))
        got = local_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # block_size=0 at a length with no flash block: the dense path too
    want = np.asarray(jax_local_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, block_size=0))
    got = local_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, block_size=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_bucket_policy_matches_jax():
    for kw in (dict(min_bucket=8, factor=2.0, round_to=8),
               dict(min_bucket=16, factor=2.0, round_to=16),
               dict(min_bucket=5, factor=1.5, round_to=4)):
        mine, ref = tcc.BucketPolicy(**kw), JaxBucketPolicy(**kw)
        for upto in (1, 48, 1024):
            assert mine._ladder(upto) == ref._ladder(upto)
    assert tcc.BucketPolicy.fixed(24).buckets == \
        JaxBucketPolicy.fixed(24).buckets
    assert tcc.bucket_for(5, (1, 4, 8)) == jax_bucket_for(5, (1, 4, 8)) == 8
    with pytest.raises(MXNetError):
        tcc.bucket_for(9, (1, 4, 8))


def _chunked_prefill(mods, params, toks, chunk, quant=None):
    """Prefill ``toks`` [1, L] chunk by chunk over a paged cache of block
    size 4 with ``mods`` = (transformer module, kvcache module, array
    maker); returns the logits of every position [L, V] as numpy."""
    tm, kv, arr = mods
    L = toks.shape[1]
    table = arr(np.arange(1, 5, dtype=np.int32))
    pools = list(kv.make_pools(NL, 8, 4, H, D // H, quant=quant,
                               **({"device": "cpu"} if arr is torch.tensor
                                  else {})))
    rows = []
    for start in range(0, L, chunk):
        part = np.zeros((1, chunk), np.int32)
        part[0, :min(chunk, L - start)] = toks[0, start:start + chunk]

        def attend(i, q, k, v):
            pools[0] = kv.write_prefill(pools[0], i, k[0], table, L,
                                        start=start)
            pools[1] = kv.write_prefill(pools[1], i, v[0], table, L,
                                        start=start)
            out = kv.paged_prefill_attention(
                q[0], kv.layer_view(pools[0], i), kv.layer_view(pools[1], i),
                table, start, L)
            return out[None]

        logits = tm.transformer_lm_prefill_chunk(params, arr(part), heads=H,
                                                 attend=attend)
        rows.append(np.asarray(logits[0])[:min(chunk, L - start)])
    return np.concatenate(rows)


@pytest.mark.parametrize("chunk", [3, 4, 10])
@pytest.mark.parametrize("quant", [None, "fp8"])
def test_prefill_chunk_matches_whole_prefill_and_jax(chunk, quant):
    """Chunk by chunk (a mid-chunk tail for chunks 3 and 4) over a paged
    cache: the port equals the JAX package's chunked prefill (atol 1e-5,
    f32 summation order) and, on f32 pools, its own whole prefill (atol
    2e-5: the paged softmax sums over other lengths)."""
    from mxnet_tpu.models import transformer as jt
    from mxnet_tpu.serve import kvcache as jkv
    from mxnet_tpu_torch.serve import kvcache as tkv
    params = _symbol_params()
    toks = np.array([[7, 3, 11, 2, 9, 1, 30, 12, 5, 44]], np.int32)
    with torch.no_grad():
        got = _chunked_prefill((tt, tkv, torch.tensor),
                               tt.params_from_numpy(params, "cpu"), toks,
                               chunk, quant)
        whole, _, _ = tt.transformer_lm_prefill(
            tt.params_from_numpy(params, "cpu"), torch.from_numpy(toks),
            heads=H)
    want = _chunked_prefill(
        (jt, jkv, lambda a: jnp.asarray(a, jnp.int32)),
        {k: jnp.asarray(v) for k, v in params.items()}, toks, chunk, quant)
    assert got.shape == (10, V)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if quant is None:
        np.testing.assert_allclose(got, whole[0].numpy(), atol=2e-5)
