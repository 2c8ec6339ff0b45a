"""Serving's r12 configuration in the PyTorch port: chunked prefill, fp8 KV
pools, the prefix cache and defrag (mxnet_tpu_torch/serve/engine.py).

* On the CPU the port's engine emits the JAX package's ``Engine`` greedy
  streams token for token with ``prefill_chunk=4`` and with
  ``prefill_chunk=4, kv_quant="fp8"``, in a roomy and a preempting pool,
  and counts the same prefill chunks;
* within the port, chunked prefill is a pure scheduling change (greedy
  and seeded streams equal the whole-prompt engine's), a request
  preempted mid-prefill replays, fp8 runs replay, the chunk replaces the
  prompt ladder, and the SLO backlog estimate counts remaining chunks;
* the prefix cache: warm streams equal cache-cold ones, a cohort
  prefills the shared prefix once, hit counts equal the JAX engine's, a
  NaN request spares the blocks it shares, and ``defrag`` every step
  leaves streams bitwise unchanged on f32 and fp8 pools.

Sampled streams replay within the port only (its generator is not JAX's
PRNG); cross-package parity is for greedy streams.
"""
import numpy as np
import pytest

from mxnet_tpu import telemetry
from mxnet_tpu.serve import Engine as JaxEngine
from mxnet_tpu.serve import EngineConfig as JaxEngineConfig
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import Engine, EngineConfig, ServeError
from mxnet_tpu_torch.serve.scheduler import FINISHED, Request
from test_torch_serve import CFG, PARAMS, V

CHUNK = dict(CFG, prefill_chunk=4)
# prompts of 1 to 4 chunks, with mid-chunk tails
PROMPTS = [[1, 2, 3], list(range(10, 24)), [20, 21, 22, 23, 24, 25, 26, 27],
           [30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40]]
NEW = [10, 8, 12, 6]
SAMPLED = [dict(seed=101), dict(temperature=0.9, top_k=7, seed=202),
           dict(seed=303), dict(temperature=1.3, seed=404)]


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


def _engine(params=PARAMS, **over):
    return Engine(params, EngineConfig(**dict(CHUNK, **over)), device="cpu")


def _serve(eng, prompts, kws):
    ids = [eng.submit(p, **kw) for p, kw in zip(prompts, kws)]
    return [eng.result(i) for i in ids]


def _greedy():
    return [dict(max_new_tokens=n) for n in NEW]


def _sampled():
    return [dict(kw, max_new_tokens=n) for kw, n in zip(SAMPLED, NEW)]


@pytest.mark.parametrize("kv_quant", [None, "fp8"])
@pytest.mark.parametrize("over", [{}, dict(num_blocks=10)],
                         ids=["roomy_pool", "preempting_pool"])
def test_greedy_streams_match_jax_engine(kv_quant, over):
    cfg = dict(CHUNK, kv_quant=kv_quant, **over)
    jax_eng = JaxEngine(PARAMS, JaxEngineConfig(**cfg))
    want = _serve(jax_eng, PROMPTS, _greedy())
    assert len({t for s in want for t in s}) > 10     # streams do vary
    eng = _engine(kv_quant=kv_quant, **over)
    assert _serve(eng, PROMPTS, _greedy()) == want
    flat = telemetry.snapshot_flat()
    assert eng.counters["prefill_chunks"] == flat["serve.prefill_chunks"]
    assert eng.counters["prefills"] == flat["serve.prefills"]
    assert (eng.counters["preemptions"] > 0) == bool(over)
    assert eng.kv_bytes_per_token == flat["kv_bytes_per_token"]
    assert eng.alloc.num_used == 0


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
@pytest.mark.parametrize("chunk", [4, 5])
def test_chunked_equals_unchunked(kind, chunk):
    kws = _greedy() if kind == "greedy" else _sampled()
    whole = _serve(_engine(prefill_chunk=0), PROMPTS, kws)
    eng = _engine(prefill_chunk=chunk)
    assert _serve(eng, PROMPTS, kws) == whole
    assert eng.counters["prefill_chunks"] == sum(
        -(-len(p) // chunk) for p in PROMPTS)
    assert eng.counters["prefills"] == len(PROMPTS)
    # preempting pool: chunked re-prefills replay the same streams
    eng = _engine(prefill_chunk=chunk, num_blocks=10)
    assert _serve(eng, PROMPTS, kws) == whole
    assert eng.counters["preemptions"] > 0 and eng.alloc.num_used == 0


def test_mid_prefill_preemption_replays():
    """A request preempted with only part of its prompt ingested resets
    its chunk cursor and, re-admitted, replays its exact stream."""
    prompts = [list(range(1, 15)), list(range(20, 30))]
    kws = [dict(max_new_tokens=8, temperature=0.8, seed=55),
           dict(max_new_tokens=6, seed=66)]
    refs = []
    for p, k in zip(prompts, kws):
        e = _engine()
        refs.append(e.result(e.submit(p, **k)))
    eng = _engine()
    a = eng.submit(prompts[0], **kws[0])
    b = eng.submit(prompts[1], **kws[1])
    eng.step()     # nothing can decode: the pump drains A's prompt
    eng.step()     # A decodes; the pump lands one chunk of B
    req_b = eng.requests[b]
    assert 0 < req_b.prefilled < req_b.prefill_target
    assert req_b.tokens == []                        # off the decode roster
    eng._preempt(req_b)
    assert req_b.prefilled == 0 and req_b.prefill_target == 0
    eng.run()
    assert [eng.requests[a].tokens, eng.requests[b].tokens] == refs


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_fp8_runs_replay(kind):
    kws = _greedy() if kind == "greedy" else _sampled()
    runs = [_serve(_engine(kv_quant="fp8"), PROMPTS, kws) for _ in range(2)]
    assert runs[0] == runs[1]
    alone = []
    for p, kw in zip(PROMPTS, kws):
        e = _engine(kv_quant="fp8")
        alone.append(e.result(e.submit(p, **kw)))
    assert alone == runs[0]


def test_chunk_replaces_the_prompt_ladder():
    eng = _engine(prefill_chunk=8)
    assert eng.prompt_buckets == (8,)
    infos = eng.warmup()
    assert [(i["kind"], i["bucket"]) for i in infos] == [
        ("prefill_chunk", 8), ("decode", 4)]
    assert not eng.counters and eng.alloc.num_used == 0
    assert len(_engine(prefill_chunk=0).prompt_buckets) > 1
    st = eng.stats()
    assert st["prefill_chunk"] == 8 and st["prompt_buckets"] == [8]
    assert st["kv_quant"] is None and st["prefix"] is None


def test_prefill_backlog_estimate():
    """Remaining chunks of mid-prefill requests only, scaled by the EWMA
    chunk latency."""
    eng = _engine()
    assert eng._prefill_backlog_ms() == 0.0          # no history, no work
    eng._chunk_ms = 2.0
    r = Request(prompt=list(range(9)))
    r.prefilled, r.prefill_target = 1, 9             # ceil(8 / 4) = 2 chunks
    eng.sched.running.append(r)
    assert eng._prefill_backlog_ms() == pytest.approx(4.0)
    r.prefilled = 9
    assert eng._prefill_backlog_ms() == 0.0
    assert _engine(prefill_chunk=0)._prefill_backlog_ms() == 0.0


def test_config_validation():
    for over in (dict(kv_quant="int4"), dict(prefill_chunk=-1),
                 dict(prefix_cache=True, prefill_chunk=0),
                 dict(prefix_cache=True, prefix_cap_frac=0.0),
                 dict(prefix_cache=True, prefix_min_blocks=0)):
        with pytest.raises(MXNetError):
            _engine(**over)
    with pytest.raises(MXNetError, match="chunked prefill"):
        _engine(prefix_cache=True, prefill_chunk=0)


# ---------------------------------------------------------------------------
# The prefix cache
# ---------------------------------------------------------------------------

# a 12-token system prompt (3 full blocks) shared by every stream, plus
# distinct suffixes; greedy and seeded rows alternate
PREFIX = [7, 3, 11, 19, 2, 40, 5, 8, 23, 17, 31, 4]
SUFFIXES = [[50, 51], [52, 53, 54], [55], [56, 57], [58, 59, 60]]
PKW = [dict(max_new_tokens=8, temperature=(0.8 if i % 2 else 0.0),
            top_k=(5 if i % 2 else 0), seed=900 + i)
       for i in range(len(SUFFIXES))]


def _cold(**over):
    """Each prompt alone on a fresh cache-off engine: the yardstick."""
    outs = []
    for sfx, kw in zip(SUFFIXES, PKW):
        e = _engine(**over)
        outs.append(e.result(e.submit(PREFIX + sfx, **kw)))
    return outs


@pytest.mark.parametrize("kv_quant", [None, "fp8"])
def test_warm_streams_equal_cold(kv_quant):
    ref = _cold(kv_quant=kv_quant)
    eng = _engine(prefix_cache=True, kv_quant=kv_quant)
    eng.warmup()
    outs = [eng.result(eng.submit(PREFIX + sfx, **kw))
            for sfx, kw in zip(SUFFIXES, PKW)]
    assert outs == ref
    st = eng.stats()["prefix"]
    assert st["hits"] == len(SUFFIXES) - 1 and st["misses"] == 1
    assert st["hit_tokens"] == (len(SUFFIXES) - 1) * 12
    assert eng.prefix_probe(PREFIX + [1]) == 12
    assert eng.alloc.num_used == 0 and eng.alloc.num_cached > 0
    eng.check_tables()


def _cohort(make):
    eng = make()
    ids = [eng.submit(PREFIX + sfx, **dict(kw, temperature=0.0))
           for sfx, kw in zip(SUFFIXES, PKW)]
    eng.run()
    return eng, [eng.requests[i].tokens for i in ids]


def test_cohort_prefills_the_prefix_once_and_matches_jax_hits():
    """Requests admitted in one step: the re-probe before each first
    chunk maps what the first request just published.  Hits, misses, hit
    tokens and prefill chunks equal the JAX engine's, and greedy streams
    equal it too."""
    cfg = dict(CHUNK, prefix_cache=True, max_batch=8)
    jeng, want = _cohort(lambda: JaxEngine(PARAMS, JaxEngineConfig(**cfg)))
    eng, got = _cohort(lambda: _engine(prefix_cache=True, max_batch=8))
    assert got == want
    keys = ("hits", "misses", "hit_tokens", "entries", "cached_blocks")
    assert {k: eng.stats()["prefix"][k] for k in keys} == \
        {k: jeng.stats()["prefix"][k] for k in keys}
    assert eng.stats()["prefix"]["hits"] == len(SUFFIXES) - 1
    # the miss runs prefix + suffix (4 chunks), every hit one suffix chunk
    assert eng.counters["prefill_chunks"] == 3 + len(SUFFIXES) == \
        telemetry.snapshot_flat()["serve.prefill_chunks"]
    cold, _ = _cohort(lambda: _engine(max_batch=8))
    assert cold.counters["prefill_chunks"] == 4 * len(SUFFIXES)


def test_exact_resubmit_and_min_blocks():
    eng = _engine(prefix_cache=True)
    e0 = _engine()
    want = e0.result(e0.submit(PREFIX, max_new_tokens=6))
    eng.result(eng.submit(PREFIX, max_new_tokens=6))
    rid = eng.submit(PREFIX, max_new_tokens=6)
    assert eng.result(rid) == want
    # 3 blocks resident, hit = floor(min(12, 11) / 4) = 2 blocks
    assert eng.requests[rid].prefix_hit == 8
    eng = _engine(prefix_cache=True, prefix_min_blocks=2)
    eng.result(eng.submit([5, 6, 7, 8, 9], max_new_tokens=4))
    rid = eng.submit([5, 6, 7, 8, 9, 1], max_new_tokens=4)
    eng.result(rid)
    assert eng.requests[rid].prefix_hit == 0


def test_nan_request_spares_shared_blocks():
    """B maps A's published prefix, then hits a NaN embedding in its
    suffix: B fails, its private blocks are scrubbed, the shared ones are
    not.  A's stream and a later request over the cached prefix equal a
    clean engine's."""
    bad_tok = V - 1
    params = dict(PARAMS)
    params["embed_weight"] = PARAMS["embed_weight"].copy()
    params["embed_weight"][bad_tok] = np.nan
    kw = dict(max_new_tokens=8)
    e = _engine()
    clean_a = e.result(e.submit(PREFIX + SUFFIXES[0], **kw))
    e = _engine()
    clean_c = e.result(e.submit(PREFIX + SUFFIXES[2], **kw))
    assert bad_tok not in clean_a + clean_c
    eng = _engine(params, prefix_cache=True)
    a = eng.submit(PREFIX + SUFFIXES[0], **kw)
    for _ in range(3):
        eng.step()                                   # A prefilled, decoding
    b = eng.submit(PREFIX + [bad_tok, 1], **kw)
    with pytest.raises(ServeError) as err:
        eng.result(b)
    assert err.value.reason == "error"
    assert eng.requests[b].prefix_hit == 12          # B shared A's blocks
    assert eng.counters["nan_logits"] == 1
    assert eng.result(a) == clean_a
    c = eng.submit(PREFIX + SUFFIXES[2], **kw)
    assert eng.result(c) == clean_c
    assert eng.requests[c].prefix_hit == 12
    assert eng.alloc.num_used == 0
    eng.check_tables()


@pytest.mark.parametrize("kv_quant", [None, "fp8"])
def test_defrag_every_step_is_bitwise_stable(kv_quant):
    ref = _cold(kv_quant=kv_quant)
    eng = _engine(prefix_cache=True, max_batch=8, kv_quant=kv_quant)
    eng.warmup()
    # a finished request's private blocks free up holes below the rest
    eng.result(eng.submit([9] * 13, max_new_tokens=4))
    ids = [eng.submit(PREFIX + sfx, **kw) for sfx, kw in zip(SUFFIXES, PKW)]
    moved = 0
    for _ in range(200):
        if eng.sched.idle():
            break
        eng.step()
        moved += eng.defrag()
        eng.check_tables()
    assert [eng.requests[i].tokens for i in ids] == ref
    assert moved > 0
    # cached blocks moved with their index entries: a follow-up still hits
    rid = eng.submit(PREFIX + [42], max_new_tokens=4)
    eng.result(rid)
    assert eng.requests[rid].prefix_hit == 12


def test_lru_eviction_under_tight_cap():
    eng = _engine(prefix_cache=True, prefix_cap_frac=0.08)   # 5 of 63
    rng = np.random.RandomState(11)
    for _ in range(6):
        p = list(map(int, rng.randint(1, V - 1, 12)))
        eng.result(eng.submit(p + [int(rng.randint(1, V - 1))],
                              max_new_tokens=4))
    assert eng.alloc.num_cached <= 5
    assert eng.stats()["prefix"]["evictions"] > 0
    assert eng.alloc.num_used == 0
    assert all(r.state == FINISHED for r in eng.requests.values())
    eng.check_tables()
