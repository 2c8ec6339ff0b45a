"""Speculative decoding in the PyTorch port (mxnet_tpu_torch/serve/
speculate.py, the engine's verify step, kvcache's verify window), with the
engine pieces a router's failover needs (``Engine.adopt``,
``Engine.request``, ``EngineConfig.from_env``).

Against the JAX package, in this process, on the same numpy inputs
(f32/int32 on both sides):

* the n-gram drafter proposes the same tokens; ``draft_window_logits``
  agrees within atol 1e-5 (f32 summation order); ``make_drafter`` and the
  engine's speculation settings raise where the JAX package's do;
* ``transformer_lm_verify`` through ``write_spec`` and
  ``paged_verify_attention`` agrees within atol 1e-5 on f32 and fp8 pools;
  ``write_spec`` and ``scrub_positions`` leave the pools bitwise equal;
* greedy acceptance gives the JAX rule's integers for every live count;
* greedy streams equal the JAX non-speculative and speculative engines',
  and the drafted and accepted counts equal the JAX speculative engine's,
  with the n-gram and the model drafter, whole-prompt and chunked
  prefill, f32 and fp8 pools and the prefix cache;
* ``EngineConfig.from_env`` reads the variables as the JAX package does.

Within the port (its sampler is not JAX's PRNG): the temperature rule's
marginal is the sampling distribution, a row with no live draft is plain
decode, streams are the same alone and batched, under staggered
admission and preemption, the rejected tail is zeroed, freed blocks carry
nothing stale, a compatible draft swap leaves streams unchanged, and an
adopted request continues the uninterrupted stream.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import telemetry
from mxnet_tpu.models import transformer as jtr
from mxnet_tpu.serve import Engine as JaxEngine
from mxnet_tpu.serve import EngineConfig as JaxEngineConfig
from mxnet_tpu.serve import kvcache as jkv
from mxnet_tpu.serve import speculate as jspec
from mxnet_tpu.serve.engine import _spec_accept_row as jax_accept_row
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttr
from mxnet_tpu_torch.online.compat import check_compat, signature_of_params
from mxnet_tpu_torch.serve import (Engine, EngineConfig, NGramDrafter,
                                   make_drafter)
from mxnet_tpu_torch.serve import kvcache as tkv
from mxnet_tpu_torch.serve import speculate as tspec
from mxnet_tpu_torch.serve.engine import (_spec_accept, _spec_accept_row,
                                          _spec_accept_row_greedy)
from mxnet_tpu_torch.serve.scheduler import Request
from test_torch_serve import CFG, PARAMS, V, NL, D, H

# the JAX suite's flat 0.05-scale weights (tests/test_speculate.py): their
# greedy streams cycle, so n-gram drafts get accepted
FLAT = ttr.init_params(V, NL, D, seed=0)
DRAFT = ttr.init_params(V, NL, D, seed=7)

# greedy streams of varied weights (test_torch_serve.PARAMS) vary token to
# token; the repetitive prompts give the n-gram drafter something to match
G_PROMPTS = [[1, 2, 3], [10, 11, 12, 13, 14, 15], [20, 21], [30, 31, 32, 33],
             [9, 9, 9], [5, 6, 7, 5, 6, 7, 5]]
G_NEW = [10, 8, 12, 6, 12, 9]
# the JAX suite's mixed workload: two greedy rows, two sampled
M_PROMPTS = [[1, 2, 3], [10, 11, 12, 13, 14, 15], [20, 21], [30, 31, 32, 33]]
M_KW = [dict(max_new_tokens=10, seed=101),
        dict(max_new_tokens=8, temperature=0.9, top_k=7, seed=202),
        dict(max_new_tokens=12, seed=303),
        dict(max_new_tokens=6, temperature=1.3, seed=404)]


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


def _engine(params=PARAMS, speculate=True, draft_params=None, **over):
    cfg = dict(CFG, spec_k=4)
    cfg.update(over)
    kw = {} if draft_params is None else dict(draft_params=draft_params,
                                              draft_heads=H)
    return Engine(params, EngineConfig(speculate=speculate, **cfg),
                  device="cpu", **kw)


def _serve(eng, prompts, kws):
    ids = [eng.submit(p, **kw) for p, kw in zip(prompts, kws)]
    return [eng.result(i) for i in ids]


def _alone(speculate, prompts=M_PROMPTS, kws=M_KW, **over):
    outs = []
    for p, kw in zip(prompts, kws):
        e = _engine(speculate=speculate, **over)
        outs.append(e.result(e.submit(p, **kw)))
    return outs


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------

def test_ngram_drafter_suffix_match():
    d = NGramDrafter(max_n=3)
    assert d._draft_one([1, 5, 6, 7, 8, 9, 2, 5, 6, 7], 2) == [8, 9]
    assert d._draft_one([3, 4, 3, 4], 3) == [3, 4, 3]
    assert d._draft_one([3, 4, 9, 3, 4, 7, 3, 4], 1) == [7]
    assert d._draft_one([1, 2, 3], 2) == [3, 3]
    assert d._draft_one([4], 3) == [4, 4, 4]
    assert d._draft_one([9, 9, 9], 2) == [9, 9]
    out = d.propose([[1, 2, 1, 2], [7]], 3)
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert list(out[0]) == [1, 2, 1]


@pytest.mark.parametrize("max_n", [1, 3])
def test_ngram_drafter_matches_jax(max_n):
    rng = np.random.RandomState(max_n)
    ctxs = [rng.randint(0, rng.randint(2, 8), rng.randint(1, 30)).tolist()
            for _ in range(200)]
    for k in (1, 4):
        want = jspec.NGramDrafter(max_n=max_n).propose(ctxs, k)
        got = NGramDrafter(max_n=max_n).propose(ctxs, k)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [5, 12])
def test_draft_window_logits_matches_jax(window):
    rng = np.random.RandomState(window)
    b = 4
    ctx = np.array([1, window, 3, window - 1], np.int32)
    toks = rng.randint(0, V, (b, window)).astype(np.int32)
    toks[np.arange(window)[None, :] < (window - ctx)[:, None]] = 0
    want = np.asarray(jspec.draft_window_logits(
        {k: jnp.asarray(v) for k, v in DRAFT.items()}, jnp.asarray(toks),
        jnp.asarray(ctx), heads=H))
    got = tspec.draft_window_logits(
        ttr.params_from_numpy(DRAFT, "cpu"), torch.from_numpy(toks),
        torch.from_numpy(ctx), heads=H)
    assert got.shape == (b, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _raises(fn):
    try:
        fn()
    except Exception as exc:     # noqa: BLE001 — compared across packages
        return type(exc).__name__
    return None


def test_make_drafter_validation_matches_jax():
    # the port's model drafter holds tensors on a device: the CPU here
    cases = [
        lambda m, dev: m.make_drafter("beam"),
        lambda m, dev: m.make_drafter("model", **dev),
        lambda m, dev: m.make_drafter("model", draft_params=DRAFT, **dev),
        lambda m, dev: m.make_drafter("ngram").swap(DRAFT),
        lambda m, dev: m.NGramDrafter(max_n=0),
        lambda m, dev: m.ModelDrafter(DRAFT, heads=H, window=0, **dev),
        lambda m, dev: m.ModelDrafter(DRAFT, heads=5, **dev),
    ]
    for case in cases:
        want = _raises(lambda: case(jspec, {}))
        assert want == "MXNetError"
        assert _raises(lambda: case(tspec, dict(device="cpu"))) == want
    assert make_drafter("ngram").kind == "ngram"
    assert make_drafter("").kind == "ngram"
    m = make_drafter("model", draft_params=DRAFT, draft_heads=H,
                     device="cpu")
    assert m.kind == "model" and m.signature() == jspec.make_drafter(
        "model", draft_params=DRAFT, draft_heads=H).signature()
    with pytest.raises(MXNetError, match="no bound draft runner"):
        m.propose([[1, 2]], 2)


def test_spec_config_validation_matches_jax():
    jcfg = dict(CFG, speculate=True)
    cases = [dict(spec_k=0), dict(spec_k=47), dict(spec_k=64),
             dict(spec_draft="model"), dict(spec_draft="beam"), {}]
    for over in cases:
        want = _raises(lambda: JaxEngine(PARAMS, JaxEngineConfig(
            **dict(jcfg, **over))))
        got = _raises(lambda: _engine(**over))
        assert got == want, over
    for eng in (_engine(speculate=False), _engine(spec_k=2)):
        with pytest.raises(MXNetError, match="no model drafter"):
            eng.swap_draft_weights(DRAFT)


def test_compat_report_reads_as_jax():
    from mxnet_tpu.online import compat as jcompat
    bad = dict(DRAFT, extra=np.zeros(3, np.float32))
    bad["embed_weight"] = bad["embed_weight"][:, :16]
    bad["lm_head_bias"] = bad["lm_head_bias"].astype(np.float64)
    del bad["final_ln_beta"]
    for a, b in ((DRAFT, DRAFT), (DRAFT, bad)):
        want = jcompat.check_compat(jcompat.signature_of_params(a),
                                    jcompat.signature_of_params(b))
        got = check_compat(signature_of_params(a), signature_of_params(b))
        assert got.to_dict() == want.to_dict()
        assert got.summary() == want.summary()
    tensors = ttr.params_from_numpy(DRAFT, "cpu")
    assert signature_of_params(tensors) == jcompat.signature_of_params(DRAFT)
    assert signature_of_params({"w": torch.zeros(2, dtype=torch.bfloat16)}) \
        == {"w": ((2,), "bfloat16")}


# ---------------------------------------------------------------------------
# The verify window: writes, attention, rollback
# ---------------------------------------------------------------------------

B_W, C_W, BS_W, NB_W, MB_W = 3, 5, 4, 24, 6
LEN_W = np.array([5, 9, 2], np.int32)
LIVE_W = np.array([4, 2, 0], np.int32)
EMIT_W = np.array([3, 1, 1], np.int32)       # accepted drafts + 1


def _window_geometry():
    tables = np.zeros((B_W, MB_W), np.int32)
    nxt = 1
    for b in range(B_W):
        n = -(-(LEN_W[b] + C_W) // BS_W)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    win = np.arange(C_W)
    pos = LEN_W[:, None] + win
    slot_raw = np.take_along_axis(tables, np.minimum(pos // BS_W, MB_W - 1),
                                  axis=1)
    wmask = win[None, :] <= LIVE_W[:, None]
    return tables, slot_raw, pos % BS_W, wmask


def _prefixed_pools(kv_quant, seed):
    """Both packages' pools with the same cached prefix of every row."""
    rng = np.random.RandomState(seed)
    tables = _window_geometry()[0]
    hd = D // H
    jpools = list(jkv.make_pools(NL, NB_W, BS_W, H, hd, dtype=jnp.float32,
                                 quant=kv_quant))
    tpools = tkv.make_pools(NL, NB_W, BS_W, H, hd, quant=kv_quant,
                            device="cpu")
    for layer in range(NL):
        for b in range(B_W):
            for j in range(2):
                st = rng.randn(LEN_W[b], H, hd).astype(np.float32)
                jpools[j] = jkv.write_prefill(
                    jpools[j], layer, jnp.asarray(st),
                    jnp.asarray(tables[b]), jnp.int32(LEN_W[b]))
                tkv.write_prefill(tpools[j], layer, torch.from_numpy(st),
                                  torch.from_numpy(tables[b]), int(LEN_W[b]))
    return jpools, list(tpools)


def _leaves_np(pool):
    """A pool's leaves as numpy: fp8 payload as bytes, then scales."""
    if isinstance(pool, tkv.QuantPool):
        return [pool.payload.view(torch.uint8).numpy(), pool.scale.numpy()]
    if isinstance(pool, jkv.QuantPool):
        return [np.asarray(pool.payload).view(np.uint8),
                np.asarray(pool.scale)]
    return [np.asarray(pool) if not torch.is_tensor(pool) else pool.numpy()]


def _live_blocks(pool):
    """The pool without its trash block 0."""
    return type(pool)(*(t[:, 1:] for t in pool)) if isinstance(
        pool, tuple) else pool[:, 1:]


def _assert_pools_bitwise(tpools, jpools):
    for tp, jp in zip(tpools, jpools):
        for a, b in zip(_leaves_np(tp), _leaves_np(jp)):
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("kv_quant", [None, "fp8"])
def test_verify_forward_matches_jax(kv_quant):
    """``transformer_lm_verify`` writing through ``write_spec`` and reading
    through ``paged_verify_attention`` agrees with the JAX pair."""
    tables, slot_raw, offs, wmask = _window_geometry()
    slots = np.where(wmask, slot_raw, 0).astype(np.int32)
    jpools, tpools = _prefixed_pools(kv_quant, seed=3)
    tokens = np.random.RandomState(4).randint(0, V, (B_W, C_W)).astype(
        np.int32)
    j_sl, j_of, j_tb, j_ln = (jnp.asarray(a) for a in (slots, offs, tables,
                                                       LEN_W))

    def jattend(i, q, k, v):
        jpools[0] = jkv.write_spec(jpools[0], i, k, j_sl, j_of)
        jpools[1] = jkv.write_spec(jpools[1], i, v, j_sl, j_of)
        return jkv.paged_verify_attention(
            q, jkv.layer_view(jpools[0], i), jkv.layer_view(jpools[1], i),
            j_tb, j_ln)

    want = np.asarray(jtr.transformer_lm_verify(
        {k: jnp.asarray(v) for k, v in FLAT.items()}, jnp.asarray(tokens),
        heads=H, attend=jattend))
    t_sl, t_of, t_tb, t_ln = (torch.from_numpy(a) for a in (slots, offs,
                                                            tables, LEN_W))

    def tattend(i, q, k, v):
        tkv.write_spec(tpools[0], i, k, t_sl, t_of)
        tkv.write_spec(tpools[1], i, v, t_sl, t_of)
        return tkv.paged_verify_attention(
            q, tkv.layer_view(tpools[0], i), tkv.layer_view(tpools[1], i),
            t_tb, t_ln)

    with torch.no_grad():
        got = ttr.transformer_lm_verify(
            ttr.params_from_numpy(FLAT, "cpu"), torch.from_numpy(tokens),
            heads=H, attend=tattend)
    assert got.shape == (B_W, C_W, V)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("kv_quant", [None, "fp8"])
def test_write_spec_and_scrub_bitwise(kv_quant):
    """The same window states written by both packages leave the pools
    bitwise equal (fp8 payload bytes and scales included), each position
    holding what ``write_decode`` writes for it; the scrub of the
    rejected tail leaves them bitwise equal again, zero at exactly the
    rolled-back positions of every layer."""
    tables, slot_raw, offs, wmask = _window_geometry()
    slots = np.where(wmask, slot_raw, 0).astype(np.int32)
    jpools, tpools = _prefixed_pools(kv_quant, seed=5)
    rng = np.random.RandomState(6)
    hd = D // H
    states = [[rng.randn(B_W, C_W, H, hd).astype(np.float32)
               for _ in range(2)] for _ in range(NL)]
    for layer in range(NL):
        for j in range(2):
            jpools[j] = jkv.write_spec(jpools[j], layer,
                                       jnp.asarray(states[layer][j]),
                                       jnp.asarray(slots), jnp.asarray(offs))
            tkv.write_spec(tpools[j], layer,
                           torch.from_numpy(states[layer][j]),
                           torch.from_numpy(slots), torch.from_numpy(offs))
    # (dead entries of different rows may meet in the trash block, where
    # the last write of either package wins)
    _assert_pools_bitwise([_live_blocks(p) for p in tpools],
                          [_live_blocks(p) for p in jpools])
    # each live position holds what a decode step writes for its states
    dec = tkv.make_pools(NL, NB_W, BS_W, H, hd, quant=kv_quant,
                         device="cpu")[0]
    for c in range(C_W):
        tkv.write_decode(dec, 0, torch.from_numpy(states[0][0][:, c]),
                         torch.from_numpy(slot_raw[:, c]),
                         torch.from_numpy(offs[:, c]),
                         torch.from_numpy(wmask[:, c]))
    for b, c in zip(*np.nonzero(wmask)):
        for got, ref in zip(_leaves_np(tpools[0]), _leaves_np(dec)):
            np.testing.assert_array_equal(got[0, slot_raw[b, c], offs[b, c]],
                                          ref[0, slot_raw[b, c], offs[b, c]])
    win = np.arange(C_W)
    scrub = wmask & (win[None, :] > (EMIT_W - 1)[:, None])
    assert scrub.any() and (wmask & ~scrub).any()
    sslots = np.where(scrub, slot_raw, 0).astype(np.int32)
    for j in range(2):
        jpools[j] = jkv.scrub_positions(jpools[j], jnp.asarray(sslots),
                                        jnp.asarray(offs))
        tkv.scrub_positions(tpools[j], torch.from_numpy(sslots),
                            torch.from_numpy(offs))
    _assert_pools_bitwise(tpools, jpools)
    for pool in tpools:
        for leaf in _leaves_np(pool):
            for b, c in zip(*np.nonzero(wmask)):
                entry = leaf[:, slot_raw[b, c], offs[b, c]]
                assert (entry == 0).all() == bool(scrub[b, c])


# ---------------------------------------------------------------------------
# Acceptance
# ---------------------------------------------------------------------------

def test_accept_rule_greedy_matches_jax():
    """For every live count, greedy acceptance gives the JAX rule's
    integers, through the full rule at temperature 0, the greedy rule and
    the batch dispatcher alike."""
    rng = np.random.RandomState(0)
    k = 4
    key = jnp.asarray([0, 3], jnp.uint32)
    jax_row = jax.jit(jax_accept_row)
    for trial in range(12):
        logits = rng.randn(k + 1, V).astype(np.float32)
        am = logits.argmax(-1)
        n_good = trial % (k + 1)
        draft = np.where(np.arange(k) < n_good, am[:k], (am[:k] + 1) % V)
        toks = np.concatenate([[17], draft]).astype(np.int32)
        rows = []
        for live in range(k + 1):
            jo, jn = jax_row(jnp.asarray(logits), jnp.asarray(toks),
                                    jnp.int32(live), key, jnp.float32(0.0),
                                    jnp.int32(0), jnp.int32(9))
            want = (np.asarray(jo).tolist(), int(jn))
            lt, tt = torch.from_numpy(logits), torch.from_numpy(toks)
            for o, n in (_spec_accept_row(lt, tt, live, 5, 0.0, 0, 9),
                         _spec_accept_row_greedy(lt, tt, live)):
                assert (o.tolist(), int(n)) == want
            assert want[1] == min(n_good, live) + 1
            rows.append((logits, toks, live, want))
        lg = torch.from_numpy(np.stack([r[0] for r in rows]))
        tk = torch.from_numpy(np.stack([r[1] for r in rows]))
        lv = torch.tensor([r[2] for r in rows], dtype=torch.int32)
        out, n_emit = _spec_accept(lg, tk, lv, [1] * len(rows),
                                   [0.0] * len(rows), [0] * len(rows),
                                   [9] * len(rows))
        assert [(o.tolist(), int(n)) for o, n in zip(out, n_emit)] == [
            r[3] for r in rows]


@pytest.mark.parametrize("topk", [0, 9])
def test_accept_rule_temperature_marginal_is_sampling_dist(topk):
    """The residual-resampling lemma: for a fixed draft the emitted
    token's marginal at a position is the temperature/top-k sampling
    distribution, over 6000 request keys."""
    rng = np.random.RandomState(1)
    logits = torch.from_numpy((rng.randn(3, V) * 2).astype(np.float32))
    temp = 1.1
    draft = int(logits[0].argmax())            # a high-mass draft
    toks = torch.tensor([5, draft, draft], dtype=torch.int32)
    n = 6000
    firsts = [int(_spec_accept_row(logits, toks, 2, key, temp, topk, 4)[0][0])
              for key in range(n)]
    emp = np.bincount(firsts, minlength=V) / n
    row = logits[0] / temp
    if topk:
        row = row.masked_fill(row < torch.topk(row, topk).values[-1], -1e30)
    ref = torch.softmax(row, -1).numpy()
    tv = 0.5 * np.abs(emp - ref).sum()
    assert tv < 0.08, f"total variation {tv:.3f} against the sampling dist"


def test_live_zero_row_is_plain_decode_even_with_temperature():
    """``max_new_tokens=1`` leaves no live draft: the one token is the
    plain sampler's at its position, temperature and top-k included."""
    for kw in (dict(max_new_tokens=1, seed=11),
               dict(max_new_tokens=1, temperature=1.2, seed=12),
               dict(max_new_tokens=1, temperature=0.7, top_k=5, seed=13)):
        for params in (PARAMS, FLAT):
            ref = _engine(params, speculate=False)
            spec = _engine(params)
            assert (spec.result(spec.submit([4, 8, 15, 16], **kw))
                    == ref.result(ref.submit([4, 8, 15, 16], **kw)))


# ---------------------------------------------------------------------------
# Greedy streams and counts against the JAX engines
# ---------------------------------------------------------------------------

# (drafter, prefill_chunk, kv_quant, prefix_cache)
GRID = [("ngram", 0, None, False), ("ngram", 4, None, False),
        ("ngram", 0, "fp8", False), ("ngram", 4, "fp8", False),
        ("model", 0, None, False), ("model", 4, "fp8", False),
        ("ngram", 4, None, True), ("model", 4, None, True)]


def _grid_cfg(chunk, kv_quant, prefix_cache):
    return dict(CFG, prefill_chunk=chunk, kv_quant=kv_quant,
                prefix_cache=prefix_cache)


def _grid_prompts(prefix_cache):
    if not prefix_cache:
        return G_PROMPTS
    # an 8-token prefix shared by every request, published by the first
    shared = [40, 41, 42, 43, 44, 45, 46, 47]
    return [shared + p for p in G_PROMPTS]


def _grid_spec(drafter):
    # the model drafter: the target's own weights over a window shorter
    # than the contexts, so drafts are right often but not always
    return (dict(spec_k=3, spec_draft="model", spec_window=6)
            if drafter == "model" else dict(spec_k=4))


@functools.lru_cache(maxsize=None)
def _jax_run(speculate, drafter, chunk, kv_quant, prefix_cache):
    """One JAX engine's greedy streams, counts and prefix hits (shared by
    the grid's cases)."""
    cfg = _grid_cfg(chunk, kv_quant, prefix_cache)
    kw = {}
    if speculate:
        cfg.update(speculate=True, **_grid_spec(drafter))
        if drafter == "model":
            kw = dict(draft_params=PARAMS, draft_heads=H)
    eng = JaxEngine(PARAMS, JaxEngineConfig(**cfg), **kw)
    outs = _serve(eng, _grid_prompts(prefix_cache),
                  [dict(max_new_tokens=n) for n in G_NEW])
    st = eng.stats()
    spec = st["speculate"] or {}
    prefix = st["prefix"] or {}
    return outs, spec.get("drafted"), spec.get("accepted"), prefix.get("hits")


@pytest.mark.parametrize("drafter,chunk,kv_quant,prefix_cache", GRID,
                         ids=["-".join(map(str, g)) for g in GRID])
def test_greedy_streams_and_counts_match_jax_engines(drafter, chunk, kv_quant,
                                                     prefix_cache):
    plain = _jax_run(False, "-", chunk, kv_quant, prefix_cache)
    want = _jax_run(True, drafter, chunk, kv_quant, prefix_cache)
    assert want[0] == plain[0]
    assert len({t for s in plain[0] for t in s}) > 10
    cfg = dict(_grid_cfg(chunk, kv_quant, prefix_cache), **_grid_spec(drafter))
    eng = _engine(draft_params=PARAMS if drafter == "model" else None, **cfg)
    got = _serve(eng, _grid_prompts(prefix_cache),
                 [dict(max_new_tokens=n) for n in G_NEW])
    assert got == plain[0]
    st = eng.stats()
    assert (st["speculate"]["drafted"], st["speculate"]["accepted"]) \
        == want[1:3]
    assert want[2] > 0                      # some drafts were accepted
    if prefix_cache:
        assert st["prefix"]["hits"] == want[3] > 0
    assert eng.counters["spec_drafted"] == want[1]
    assert eng.counters["spec_accepted"] == want[2]
    assert eng.counters["decode_steps"] == eng.counters["kernel_launches"] \
        == 0 and eng.counters["verify_steps"] > 0
    assert eng.alloc.num_used == 0


# ---------------------------------------------------------------------------
# Within the port: replay, rollback, scheduling, swaps
# ---------------------------------------------------------------------------

def test_speculative_batch_equals_alone():
    """Greedy rows equal the non-speculative engine's streams; every row,
    sampled included, is the same alone and batched."""
    plain = _alone(False)
    alone = _alone(True)
    for i in (0, 2):
        assert alone[i] == plain[i]
    eng = _engine()
    assert _serve(eng, M_PROMPTS, M_KW) == alone
    st = eng.stats()["speculate"]
    assert st["draft"] == "ngram" and st["k"] == 4 and st["drafted"] > 0
    assert eng.alloc.num_used == 0


def test_speculative_admission_order_invariance():
    alone = _alone(True)
    eng = _engine()
    i0 = eng.submit(M_PROMPTS[0], **M_KW[0])
    for _ in range(3):
        eng.step()
    i1 = eng.submit(M_PROMPTS[1], **M_KW[1])
    for _ in range(2):
        eng.step()
    i2 = eng.submit(M_PROMPTS[2], **M_KW[2])
    i3 = eng.submit(M_PROMPTS[3], **M_KW[3])
    eng.run()
    assert [eng.request(i).tokens for i in (i0, i1, i2, i3)] == alone
    assert eng.alloc.num_used == 0


@pytest.mark.parametrize("kv_quant", [None, "fp8"])
def test_speculative_preemption_replays_exactly(kv_quant):
    """At 10 blocks speculation's headroom degrades to live=0 and growth
    preempts: greedy rows keep the non-speculative stream, and a second
    engine replays every stream, sampled ones included."""
    plain = _alone(False, kv_quant=kv_quant)

    def run():
        e = _engine(num_blocks=10, kv_quant=kv_quant)
        return e, _serve(e, M_PROMPTS, M_KW)

    eng, outs = run()
    for i in (0, 2):
        assert outs[i] == plain[i]
    assert run()[1] == outs
    assert eng.counters["preemptions"] > 0
    assert eng.alloc.num_used == 0


@pytest.mark.parametrize("chunk", [0, 4])
def test_preempted_sampled_request_resumes_exactly(chunk):
    """A preempted request re-ingests all but its last token and verifies
    on from it: sampled streams continue bit for bit."""
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8]]
    kws = [dict(max_new_tokens=14, temperature=0.9, seed=5),
           dict(max_new_tokens=12, temperature=1.2, top_k=9, seed=6)]
    refs = []
    for p, kw in zip(prompts, kws):
        e = _engine(FLAT, prefill_chunk=chunk)
        refs.append(e.result(e.submit(p, **kw)))
    eng = _engine(FLAT, prefill_chunk=chunk)
    ids = [eng.submit(p, **kw) for p, kw in zip(prompts, kws)]
    for _ in range(3):
        eng.step()
    victim = eng.request(ids[0])
    assert 0 < len(victim.tokens) < 14
    eng._preempt(victim)
    eng.run()
    assert [eng.request(i).tokens for i in ids] == refs
    assert eng.counters["preemptions"] == 1 and eng.alloc.num_used == 0


@pytest.mark.parametrize("kv_quant", [None, "fp8"])
def test_spec_rejected_tail_scrubbed_and_tables_clean(kv_quant):
    """A reject-heavy sampled request: after every step the cursor is the
    stream's length less one, the allocator audit passes, and every pool
    entry past the cursor is zero in every layer, payload and scale."""
    eng = _engine(FLAT, kv_quant=kv_quant)
    rid = eng.submit([3, 1, 4, 1, 5], max_new_tokens=14, temperature=1.4,
                     seed=77)
    bsz = eng.alloc.block_size
    while not eng.sched.idle():
        eng.step()
        eng.check_tables()
        req = eng.request(rid)
        if req.done():
            break
        assert req.cached == len(req.seed_tokens) - 1
        for pool in (eng.kpool, eng.vpool):
            for leaf in tkv._leaves(pool):
                for j, blk in enumerate(req.blocks):
                    for off in range(bsz):
                        if j * bsz + off >= req.cached:
                            assert not leaf[:, blk, off].any(), \
                                f"stale K/V past the cursor: {blk}/{off}"
    st = eng.stats()["speculate"]
    assert st["drafted"] > st["accepted"]
    assert eng.alloc.num_used == 0


def test_spec_freed_blocks_carry_no_stale_kv():
    fresh = _engine(FLAT)
    ref = fresh.result(fresh.submit([2, 4, 6, 8], max_new_tokens=10, seed=5))
    eng = _engine(FLAT)
    eng.result(eng.submit([7, 3, 7, 1], max_new_tokens=12, temperature=1.5,
                          seed=9))
    assert eng.result(eng.submit([2, 4, 6, 8], max_new_tokens=10,
                                 seed=5)) == ref


def test_speculative_multi_token_steps():
    """A cycling stream: 12 tokens in fewer steps than tokens, the
    n-gram drafts mostly accepted."""
    eng = _engine(FLAT)
    eng.result(eng.submit([9, 9, 9], max_new_tokens=12, seed=1))
    assert eng.counters["tokens"] == 12
    assert eng.step_idx < 15
    assert eng.step_idx < eng.counters["tokens"]
    st = eng.stats()["speculate"]
    assert st["accept_rate"] > 0.5 and st["tokens_per_step"] > 1.0


def test_engine_decode_backlog_estimate():
    assert _engine(speculate=False)._decode_backlog_ms() == 0.0
    eng = _engine(max_batch=2)
    assert eng._decode_backlog_ms() == 0.0          # no verify step yet
    eng._decode_ms, eng._tps = 2.0, 2.5
    r1 = Request(prompt=[1], max_new_tokens=10)
    r2 = Request(prompt=[2], max_new_tokens=20)
    r1.tokens, r2.tokens = [0] * 5, [0] * 5
    eng.sched.running.append(r1)
    assert eng._decode_backlog_ms() == 0.0          # a slot is free
    eng.sched.running.append(r2)
    # min remaining = 5 tokens / 2.5 tokens a step * 2 ms = 4 ms
    assert eng._decode_backlog_ms() == pytest.approx(4.0)


def test_model_drafter_swap_keeps_streams():
    """A mismatched draft model changes acceptance, never the greedy
    stream; swapping in the target's own weights (compatible) leaves the
    streams as they were and lifts acceptance; an incompatible dict
    raises and changes nothing."""
    plain = _alone(False)
    eng = _engine(spec_k=3, spec_draft="model", draft_params=DRAFT)
    infos = eng.warmup()
    assert [i["kind"] for i in infos][-2:] == ["verify", "draft"]
    outs = _serve(eng, M_PROMPTS, M_KW)
    for i in (0, 2):
        assert outs[i] == plain[i]
    before = eng.stats()["speculate"]["accept_rate"]
    report = eng.swap_draft_weights(PARAMS)
    assert report["compatible"] and eng.counters["draft_swaps"] == 1
    assert eng.stats()["speculate"]["draft_swaps"] == 1
    again = _engine(spec_k=3, spec_draft="model", draft_params=DRAFT)
    eng.counters.clear()
    assert _serve(eng, M_PROMPTS[::2], M_KW[::2]) == [plain[0], plain[2]]
    assert (eng.counters["spec_accepted"] / eng.counters["spec_drafted"]
            > before)
    bad = ttr.init_params(V, NL, 16, seed=3)
    for swap in (bad, dict(PARAMS, extra=np.zeros(2, np.float32)),
                 {k: v.astype(np.float64) for k, v in PARAMS.items()}):
        with pytest.raises(MXNetError, match="incompatible"):
            again.swap_draft_weights(swap)
    assert again.counters["draft_swaps"] == 0
    with pytest.raises(MXNetError, match="neither a checkpoint"):
        again.swap_draft_weights("some/checkpoint")


# ---------------------------------------------------------------------------
# Engine.adopt, Engine.request, EngineConfig.from_env
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("speculate", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_adopt_mid_stream_equals_uninterrupted(speculate, kind):
    """A request stopped mid-stream on one engine and adopted by another
    continues the uninterrupted stream (same engine seed, the request's
    seed)."""
    prompt = [3, 1, 4, 1, 5, 9]
    kw = dict(max_new_tokens=16, seed=77)
    if kind == "sampled":
        kw.update(temperature=0.9, top_k=12)
    whole = _engine(FLAT, speculate=speculate)
    full = whole.result(whole.submit(prompt, **kw))
    first = _engine(FLAT, speculate=speculate)
    rid = first.submit(prompt, **kw)
    while len(first.request(rid).tokens) < 5:
        first.step()
    part = list(first.request(rid).tokens)
    first.cancel(rid)
    first.step()
    assert 5 <= len(part) < 16 and part == full[:len(part)]
    second = _engine(FLAT, speculate=speculate)
    new_id = second.adopt(prompt, part, **kw)
    req = second.request(new_id)
    assert req.first_token_t == req.submit_t
    assert second.result(new_id) == full
    assert second.alloc.num_used == 0 and first.alloc.num_used == 0


def test_adopt_and_request_validation():
    eng = _engine()
    with pytest.raises(MXNetError, match="seed"):
        eng.adopt([1, 2], [3])
    with pytest.raises(MXNetError, match="nothing to adopt"):
        eng.adopt([1, 2], [3, 4], max_new_tokens=2, seed=1)
    with pytest.raises(MXNetError, match="empty prompt"):
        eng.adopt([], [3], seed=1)
    with pytest.raises(MXNetError, match="max_seq_len"):
        eng.adopt([1] * 10, [3], max_new_tokens=40, seed=1)
    with pytest.raises(MXNetError, match="unknown request"):
        eng.request(999)
    rid = eng.adopt([1, 2], [], max_new_tokens=3, seed=4, submit_t=1.5)
    assert eng.request(rid).submit_t == 1.5
    assert eng.request(rid).first_token_t is None


_ENV = {"MXNET_TPU_SERVE_BLOCK_SIZE": "8", "MXNET_TPU_SERVE_BLOCKS": "40",
        "MXNET_TPU_SERVE_MAX_BATCH": "6", "MXNET_TPU_SERVE_MAX_QUEUE": "9",
        "MXNET_TPU_SERVE_MAX_SEQ": "96", "MXNET_TPU_SERVE_SLO_MS": "250.5",
        "MXNET_TPU_SERVE_DEADLINE_MS": "900",
        "MXNET_TPU_SERVE_PREFILL_CHUNK": "16",
        "MXNET_TPU_SERVE_KV_QUANT": " FP8 ", "MXNET_TPU_SERVE_ATTN": "Dense",
        "MXNET_TPU_SERVE_SPECULATE": "1", "MXNET_TPU_SERVE_SPEC_K": "6",
        "MXNET_TPU_SERVE_SPEC_DRAFT": "Model",
        "MXNET_TPU_SERVE_PREFIX_CACHE": "1",
        "MXNET_TPU_SERVE_PREFIX_CAP_FRAC": "0.25",
        "MXNET_TPU_SERVE_PREFIX_MIN_BLOCKS": "2"}


@pytest.mark.parametrize("env", ["unset", "set", "blank"])
def test_engine_config_from_env_matches_jax(monkeypatch, env):
    for name, val in _ENV.items():
        if env == "unset":
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val if env == "set" else "  ")
    for over in ({}, dict(heads=2, spec_k=3, max_batch=5, kv_quant=None)):
        got = EngineConfig.from_env(**over)
        want = JaxEngineConfig.from_env(**over)
        for f in dataclasses.fields(want):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    if env == "set":
        assert EngineConfig.from_env().spec_draft == "model"
