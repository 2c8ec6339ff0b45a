"""Serving engine of the PyTorch port (mxnet_tpu_torch/serve/engine.py).

* On the CPU the port's engine emits the same greedy token streams as the
  JAX package's ``Engine`` on the same parameters and prompts, with and
  without pool-pressure preemption;
* within the port, a request decodes the same tokens alone as inside a
  continuously batched engine, greedy and seeded sampling alike, through
  mid-flight admission and preemption, and every block comes home;
* greedy tokens are the argmax of a cache-free forward over the same
  tokens;
* options of later slices raise instead of being ignored.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import telemetry
from mxnet_tpu.serve import Engine as JaxEngine
from mxnet_tpu.serve import EngineConfig as JaxEngineConfig
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.transformer import (init_params,
                                                transformer_lm_prefill)
from mxnet_tpu_torch.serve import Engine, EngineConfig, ServeError
from mxnet_tpu_torch.serve.flash_decode import flash_decode_attention
from mxnet_tpu_torch.serve.scheduler import CANCELLED, FINISHED

V, NL, D, H = 61, 2, 32, 4
CFG = dict(heads=H, block_size=4, num_blocks=64, max_batch=4,
           max_prompt_len=16, max_seq_len=48, prompt_bucket_min=8)
PROMPTS = [[1, 2, 3], [10, 11, 12, 13, 14, 15], [20, 21], [30, 31, 32, 33]]
NEW = [10, 8, 12, 6]
SAMPLED = [dict(seed=101), dict(temperature=0.9, top_k=7, seed=202),
           dict(seed=303), dict(temperature=1.3, seed=404)]


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


def _varied_params():
    """Weights whose greedy streams vary from token to token and depend on
    the cached context: identity layer norms, an lm head that maps each
    token's embedding to a permuted successor, and layer weights large
    enough for attention to redirect some steps."""
    p = init_params(V, NL, D, seed=0)
    rng = np.random.RandomState(1)
    perm = rng.permutation(V)
    p = {k: (v * 2.6 if v.ndim == 2 else v) for k, v in p.items()}
    for k in p:
        if k.endswith("_gamma"):
            p[k][:] = 1
        elif k.endswith("_beta"):
            p[k][:] = 0
    p["embed_weight"] = rng.randn(V, D).astype(np.float32)
    p["lm_head_weight"] = p["embed_weight"][np.argsort(perm)].copy()
    return p


PARAMS = _varied_params()


def _engine(**over):
    return Engine(PARAMS, EngineConfig(**dict(CFG, **over)), device="cpu")


def _serve(eng, prompts, kws):
    ids = [eng.submit(p, **kw) for p, kw in zip(prompts, kws)]
    return [eng.result(i) for i in ids]


def _greedy_kws():
    return [dict(max_new_tokens=n) for n in NEW]


def _sampled_kws():
    return [dict(kw, max_new_tokens=n) for kw, n in zip(SAMPLED, NEW)]


@pytest.mark.parametrize("over", [{}, dict(num_blocks=10)],
                         ids=["roomy_pool", "preempting_pool"])
def test_greedy_streams_match_jax_engine(over):
    jax_eng = JaxEngine(PARAMS, JaxEngineConfig(**dict(CFG, **over)))
    want = _serve(jax_eng, PROMPTS, _greedy_kws())
    assert len({t for s in want for t in s}) > 10     # streams do vary
    eng = _engine(**over)
    assert eng.attn_impl == "dense"
    assert _serve(eng, PROMPTS, _greedy_kws()) == want
    assert (eng.counters["preemptions"] > 0) == bool(over)
    assert eng.alloc.num_used == 0


@pytest.mark.parametrize("impl", ["scan", "flash"])
def test_attention_impls_agree(impl):
    """``flash`` on CPU tensors runs the kernel's plain version, which
    launches nothing; ``scan`` is the block-scan reference."""
    want = _serve(_engine(), PROMPTS, _greedy_kws())
    launches = flash_decode_attention.launches
    eng = _engine(attn_impl=impl)
    assert _serve(eng, PROMPTS, _greedy_kws()) == want
    assert flash_decode_attention.launches == launches
    assert eng.counters["kernel_launches"] == 0


def _alone(kws):
    out = []
    for p, kw in zip(PROMPTS, kws):
        e = _engine()
        out.append(e.result(e.submit(p, **kw)))
    return out


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_batched_equals_alone(kind):
    kws = _greedy_kws() if kind == "greedy" else _sampled_kws()
    alone = _alone(kws)
    eng = _engine()
    assert _serve(eng, PROMPTS, kws) == alone
    # mid-flight admission: the batch changes while request 0 decodes
    eng = _engine()
    i0 = eng.submit(PROMPTS[0], **kws[0])
    for _ in range(3):
        eng.step()
    rest = [eng.submit(p, **kw) for p, kw in zip(PROMPTS[1:], kws[1:])]
    eng.run()
    assert [eng.requests[i].tokens for i in [i0] + rest] == alone
    assert all(eng.requests[i].state == FINISHED for i in [i0] + rest)
    assert eng.alloc.num_used == 0
    # pool pressure: preempted requests restart and replay exactly
    eng = _engine(num_blocks=10)
    assert _serve(eng, PROMPTS, kws) == alone
    assert eng.counters["preemptions"] > 0
    assert eng.alloc.num_used == 0


def test_sampling_is_seeded_and_distinct():
    """The draw is keyed by (engine seed, request seed, position): equal
    keys replay, other keys draw otherwise (near-flat logits of the
    0.05-scale weights make distinct draws all but certain)."""
    flat = init_params(V, NL, D, seed=0)

    def eng(seed=0):
        return Engine(flat, EngineConfig(**dict(CFG, seed=seed)),
                      device="cpu")

    kw = dict(max_new_tokens=12, temperature=1.0)
    a = _serve(eng(), [PROMPTS[1]] * 2, [dict(kw, seed=5)] * 2)
    b = _serve(eng(seed=9), [PROMPTS[1]], [dict(kw, seed=5)])
    c = _serve(eng(), [PROMPTS[1]], [dict(kw, seed=6)])
    assert a[0] == a[1]
    assert b[0] != a[0] and c[0] != a[0]


def test_greedy_tokens_are_teacher_forced_argmax():
    eng = _engine()
    outs = _serve(eng, PROMPTS, _greedy_kws())
    for prompt, toks in zip(PROMPTS, outs):
        seq = torch.tensor([prompt + toks[:-1]], dtype=torch.int32)
        with torch.no_grad():
            logits, _, _ = transformer_lm_prefill(eng._params, seq, heads=H)
        rows = logits[0, len(prompt) - 1:]
        assert rows.argmax(dim=-1).tolist() == toks


def test_counters_warmup_and_stream():
    eng = _engine()
    infos = eng.warmup()
    assert [i["bucket"] for i in infos] == [8, 16, 32, 64, 4]
    assert not eng.counters and eng.alloc.num_used == 0
    rid = eng.submit(PROMPTS[0], max_new_tokens=5)
    assert list(eng.stream(rid)) == eng.requests[rid].tokens
    assert eng.counters["prefills"] == 1
    assert eng.counters["decode_steps"] == 4
    assert eng.counters["tokens"] == 5
    assert eng.alloc.num_used == 0


def test_cancel_frees_blocks():
    eng = _engine()
    rid = eng.submit([1, 2, 3, 4], max_new_tokens=30)
    for _ in range(4):
        eng.step()
    produced = len(eng.requests[rid].tokens)
    assert 0 < produced < 30
    eng.cancel(rid)
    eng.step()
    req = eng.requests[rid]
    assert req.state == CANCELLED and len(req.tokens) == produced
    assert req.blocks == [] and eng.alloc.num_used == 0


def test_nan_logits_fail_the_request_and_scrub():
    bad = dict(PARAMS)
    bad["lm_head_bias"] = np.full_like(bad["lm_head_bias"], np.nan)
    eng = Engine(bad, EngineConfig(**CFG), device="cpu")
    rid = eng.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(ServeError) as err:
        eng.result(rid)
    assert err.value.reason == "error"
    assert eng.counters["nan_logits"] == 1 and eng.alloc.num_used == 0


@pytest.mark.parametrize("over", [
    dict(prefill_chunk=8), dict(kv_quant="fp8"), dict(speculate=True),
    dict(prefix_cache=True)])
def test_unported_options_raise(over):
    with pytest.raises(MXNetError, match="not ported yet"):
        _engine(**over)


def test_unported_entry_points_and_bad_config_raise():
    eng = _engine()
    for call in (lambda: eng.swap_weights(PARAMS), eng.defrag,
                 lambda: eng.adopt([1], [2], seed=1),
                 lambda: Engine.from_checkpoint("x", EngineConfig()),
                 lambda: Engine(PARAMS, EngineConfig(**CFG), device="cpu",
                                chaos={"serve_crash": {3}})):
        with pytest.raises(MXNetError, match="not ported yet"):
            call()
    with pytest.raises(MXNetError, match="attn_impl"):
        _engine(attn_impl="flash_interpret")
    with pytest.raises(MXNetError):
        eng.submit([1] * 17)                       # > max_prompt_len
    with pytest.raises(MXNetError):
        EngineConfig(max_batch=8,
                     decode_buckets=(1, 2)).resolved_decode_buckets()


def test_engine_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        Engine(PARAMS, EngineConfig(**CFG))
