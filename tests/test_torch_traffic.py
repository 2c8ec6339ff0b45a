"""Traffic simulation of the PyTorch port (mxnet_tpu_torch/serve/
traffic.py) against the JAX package's, on the CPU.

* ``generate_trace(cfg).to_jsonl()`` is byte-equal to the JAX package's
  over several seeds and configurations (bursts, amplitude 0, a tight
  context budget, no bursts, the canonical 10-minute trace and the
  gameday's trace at vocab 32,000), and so are ``arrival_schedule``,
  ``stats``, ``request_seed`` and the power-law draws;
* ``VirtualClock`` and ``TraceConfig.from_env`` behave the same;
* ``LoadGen`` on a port fleet gives the JAX ``LoadGen``'s submit order,
  shed set, finish reasons and greedy ``stream_keys`` on a JAX fleet
  (tests/test_traffic.py's replay size), and the same deterministic
  telemetry;
* within the port, a sampled trace replays byte for byte, and a replica
  crash mid-trace leaves every stream the clean run's.
"""
import numpy as np
import pytest

from mxnet_tpu import telemetry as jtel
from mxnet_tpu.serve import EngineConfig as JaxEngineConfig
from mxnet_tpu.serve import Router as JaxRouter
from mxnet_tpu.serve import RouterConfig as JaxRouterConfig
from mxnet_tpu.serve import traffic as jtr
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.chaos import ChaosSpec
from mxnet_tpu_torch.models.transformer import init_params
from mxnet_tpu_torch.serve import EngineConfig, Router, RouterConfig
from mxnet_tpu_torch.serve import traffic as ttr

V, NL, D, H = 61, 2, 32, 4
PARAMS = init_params(V, NL, D, seed=0)

# tests/test_traffic.py's busy minute
TCFG = dict(duration_s=60.0, base_rate=1.0, diurnal_period_s=60.0,
            burst_hazard_per_s=1.0 / 30.0, burst_duration_s=8.0,
            burst_multiplier=2.0, vocab=V, sys_prompt_min=6,
            sys_prompt_max=10, max_turns=3, prompt_min=4, prompt_max=16,
            output_min=4, output_max=10, context_budget=48,
            think_min_s=1.0, think_max_s=5.0)
# bench.py's gameday trace (bench.py:934-939) at the served vocab
GAMEDAY = dict(duration_s=600.0, base_rate=0.3, diurnal_period_s=600.0,
               burst_hazard_per_s=1.0 / 240.0, burst_duration_s=45.0,
               burst_multiplier=2.0, vocab=32000, sys_prompt_min=12,
               sys_prompt_max=20, max_turns=3, prompt_min=4,
               prompt_max=24, output_min=6, output_max=16,
               context_budget=60, think_min_s=2.0, think_max_s=20.0)
CONFIGS = {
    "busy_minute": TCFG,
    "bursty": dict(TCFG, burst_hazard_per_s=1.0 / 10.0,
                   burst_multiplier=4.0),
    "flat": dict(TCFG, diurnal_amplitude=0.0, burst_hazard_per_s=0.0),
    "tight_budget": dict(TCFG, context_budget=20, max_turns=4,
                         turn_continue_p=0.9),
    "canonical": {},
    "gameday": GAMEDAY,
}
REPLAY_CFG = dict(duration_s=30.0, base_rate=0.8, diurnal_period_s=30.0,
                  burst_hazard_per_s=0.0, vocab=V, sys_prompt_min=4,
                  sys_prompt_max=6, max_turns=3, turn_continue_p=0.3,
                  prompt_min=4, prompt_max=8, output_min=4, output_max=8,
                  context_budget=40, think_min_s=1.0, think_max_s=3.0)
ECFG = dict(heads=H, block_size=4, num_blocks=64, max_batch=4,
            max_queue=32, max_prompt_len=32, max_seq_len=64,
            prompt_bucket_min=8, prefill_chunk=8)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    jtel.reset_for_tests()
    ttel.reset_for_tests()
    yield
    jtel.reset_for_tests()
    ttel.reset_for_tests()


# ----------------------------------------------------------------------
# Generation: byte-equal to the JAX package's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trace_bytes_equal_jax(name, seed):
    over = CONFIGS[name]
    got = ttr.generate_trace(ttr.TraceConfig(seed=seed, **over))
    want = jtr.generate_trace(jtr.TraceConfig(seed=seed, **over))
    assert got.to_jsonl() == want.to_jsonl()
    assert got.arrival_schedule() == want.arrival_schedule()
    assert got.stats() == want.stats()
    assert got.n_requests == want.n_requests > 0
    # the keyword form builds the same trace
    assert ttr.generate_trace(seed=seed, **over).to_jsonl() == \
        got.to_jsonl()


def test_request_seed_and_power_law_equal_jax():
    for s, sid, turn in [(0, 0, 0), (0, 5, 1), (1, 5, 1), (99, 1234, 3),
                         (2 ** 31, 7, 2)]:
        assert ttr.request_seed(s, sid, turn) == jtr.request_seed(
            s, sid, turn)
    ra, rb = np.random.RandomState(4), np.random.RandomState(4)
    for alpha, lo, hi in [(1.5, 4, 64), (1.8, 1, 3), (0.9, 10, 10)]:
        got = [ttr._power_law(ra, alpha, lo, hi) for _ in range(500)]
        assert got == [jtr._power_law(rb, alpha, lo, hi)
                       for _ in range(500)]


def test_amplitude_validated_like_jax():
    for mod, err in ((ttr, MXNetError), (jtr, Exception)):
        with pytest.raises(err):
            mod.generate_trace(mod.TraceConfig(diurnal_amplitude=1.5,
                                               vocab=V))


@pytest.mark.parametrize("mod", [jtr, ttr], ids=["jax", "torch"])
def test_virtual_clock_and_env_seed(mod, monkeypatch):
    c = mod.VirtualClock(10.0)
    assert c() == 10.0 and c.now() == 10.0
    assert c.advance(2.5) == 12.5
    assert c.advance_to(20.0) == 20.0
    assert c.advance_to(5.0) == 20.0          # never rewinds
    with pytest.raises(Exception):
        c.advance(-1.0)
    monkeypatch.setenv("MXNET_TPU_SERVE_TRACE_SEED", "42")
    assert mod.TraceConfig.from_env().seed == 42
    assert mod.TraceConfig.from_env(seed=5).seed == 5


def test_virtual_clock_rejects_negative_with_mxnet_error():
    with pytest.raises(MXNetError):
        ttr.VirtualClock().advance(-0.5)


# ----------------------------------------------------------------------
# Replay: LoadGen on a port fleet against LoadGen on a JAX fleet
# ----------------------------------------------------------------------

def _replay(side, seed=11, rcfg=None, chaos=None, **tover):
    tr_mod, Router_, RouterConfig_, EngineConfig_, kw = {
        "jax": (jtr, JaxRouter, JaxRouterConfig, JaxEngineConfig, {}),
        "torch": (ttr, Router, RouterConfig, EngineConfig,
                  {"device": "cpu"})}[side]
    trace = tr_mod.generate_trace(tr_mod.TraceConfig(
        seed=seed, **dict(REPLAY_CFG, **tover)))
    clock = tr_mod.VirtualClock()
    router = Router_(PARAMS, EngineConfig_(**ECFG),
                     RouterConfig_(**dict(dict(
                         replicas=1, heartbeat_timeout_ms=60_000.0),
                         **(rcfg or {}))),
                     clock=clock, chaos=chaos or {}, **kw)
    router.warmup()
    res = tr_mod.LoadGen(router, trace, clock, step_virtual_s=0.25).run()
    return trace, router, res


def _same(res_t, res_j):
    keys = ("requests", "completed", "shed", "failed", "shed_rate",
            "failovers", "tokens_total", "router_steps", "virtual_s",
            "stream_keys")
    assert {k: res_t[k] for k in keys} == {k: res_j[k] for k in keys}
    fields = ("sid", "turn", "rid", "t_submit", "finish_reason", "tokens",
              "failovers")
    assert ([{k: r[k] for k in fields} for r in res_t["records"]]
            == [{k: r[k] for k in fields} for r in res_j["records"]])


def _deterministic(flat):
    return {k: v for k, v in flat.items()
            if not k.startswith("compile") and k != "serve.itl_p99_ewma_ms"
            and not k.endswith((".sum", ".min", ".max"))}


@pytest.mark.parametrize("case", ["one_replica", "shedding"])
def test_loadgen_replay_equals_jax(case):
    rcfg = {} if case == "one_replica" else {"shed_queue_depth": 2}
    tover = {} if case == "one_replica" else {"base_rate": 3.0}
    _, _, want = _replay("jax", rcfg=rcfg, **tover)
    trace, router, got = _replay("torch", rcfg=rcfg, **tover)
    _same(got, want)
    assert (_deterministic(ttel.snapshot_flat())
            == _deterministic(jtel.snapshot_flat()))
    assert got["requests"] == sum(1 for r in got["records"])
    assert router.replicas[0].engine.alloc.num_used == 0
    assert got["p99_ttft_ms"] is not None and got["p99_ttft_ms"] > 0.0
    if case == "one_replica":
        assert got["completed"] == trace.n_requests and got["shed"] == 0
        assert any(r["turn"] >= 1 for r in got["records"])
    else:
        assert got["shed"] > 0
        flat = ttel.snapshot_flat()
        assert flat["loadgen.shed"] == got["shed"]
        assert flat["loadgen.submitted"] == got["requests"]


def test_followup_prompt_extends_context():
    trace, _, res = _replay("torch")
    by_key = {(r["sid"], r["turn"]): r for r in res["records"]}
    chained = [s for s in trace.sessions if len(s.turns) >= 2
               and (s.sid, 1) in by_key]
    assert chained, "replay produced no multi-turn session"
    sess = chained[0]
    t0, t1 = by_key[(sess.sid, 0)], by_key[(sess.sid, 1)]
    assert t1["t_submit"] >= t0["t_submit"] + sess.turns[1].think_s


def test_sampled_trace_replays_and_survives_a_crash():
    """Within the port: a sampled trace replays byte for byte, and with
    two replicas and a crash mid-trace every stream is the clean run's."""
    over = dict(temperature=0.8, top_k=7)
    _, _, a = _replay("torch", **over)
    ttel.reset_for_tests()
    _, _, b = _replay("torch", **over)
    assert a["stream_keys"] == b["stream_keys"]
    assert len(a["stream_keys"]) == a["completed"] > 0
    ttel.reset_for_tests()
    _, _, clean = _replay("torch", rcfg={"replicas": 2}, **over)
    ttel.reset_for_tests()
    _, router, crash = _replay(
        "torch", rcfg={"replicas": 2},
        chaos={0: ChaosSpec({"serve_crash": {12}})}, **over)
    assert router.replicas[0].death_cause == "crash"
    assert crash["failovers"] >= 1 and crash["failed"] == 0
    assert crash["stream_keys"] == clean["stream_keys"]
