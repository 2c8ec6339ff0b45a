"""The serving control plane of the PyTorch port (mxnet_tpu_torch/serve/
router.py, the engine's chaos hooks and ``swap_weights``, ``chaos``,
``resilience.Heartbeat``), against the JAX package on the CPU.

The cases mirror tests/test_serve_router.py, tests/test_online.py's
rolling-swap cases, tests/test_prefix_cache.py's router cases and
tests/test_speculate.py's router cases, at their size (V 61, 2 layers,
d 32, 4 heads; the same engine geometry).  Each fleet runs in both
packages on the same numpy weights and prompts:

* greedy streams, the replica each request is placed on, failover
  counts, death causes, shed sets and failed sets equal the JAX fleet's,
  and so do the deterministic telemetry series (counters, gauges that
  are not wall-clock, histogram counts);
* sampled streams cannot match JAX's PRNG bits, so within the port a
  fleet under crash, hang, drain or a swap reproduces the clean port
  fleet's sampled streams byte for byte (a plain engine draws again at
  re-prefill, keyed by the same (seed, position), and that draw equals
  the dead replica's);
* ``slo`` shedding (a wall-clock estimate) and the threaded
  stream/drain/step case run within the port only.

Each package has its own telemetry registry; both are reset around every
test and each is read only for its own fleet.
"""
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import resilience as jres
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.serve import Engine as JaxEngine
from mxnet_tpu.serve import EngineConfig as JaxEngineConfig
from mxnet_tpu.serve import Router as JaxRouter
from mxnet_tpu.serve import RouterConfig as JaxRouterConfig
from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.transformer import init_params
from mxnet_tpu_torch.serve import (Engine, EngineConfig, Router,
                                   RouterConfig, ServeError)
from mxnet_tpu_torch.serve.router import DEAD, DRAINED, DRAINING, HEALTHY

V, NL, D, H = 61, 2, 32, 4
# tests/test_serve_router.py's weights: RandomState(0) * 0.05 in the JAX
# symbol's argument order
PARAMS = init_params(V, NL, D, seed=0)
ECFG = dict(heads=H, block_size=4, num_blocks=64, max_batch=4,
            max_prompt_len=16, max_seq_len=48, prompt_bucket_min=8)

_RS = np.random.RandomState(7)
PROMPTS = [list(map(int, _RS.randint(1, V, _RS.randint(3, 10))))
           for _ in range(6)]
# mixed greedy / seeded-sampling workload: failover must replay both
KW = [dict(max_new_tokens=10, temperature=(0.8 if i % 2 else 0.0),
           top_k=(5 if i % 2 else 0), seed=100 + i)
      for i in range(len(PROMPTS))]
GREEDY = [i for i, kw in enumerate(KW) if kw["temperature"] == 0.0]

JAX = SimpleNamespace(name="jax", Router=JaxRouter,
                      RouterConfig=JaxRouterConfig, Engine=JaxEngine,
                      EngineConfig=JaxEngineConfig,
                      ChaosSpec=jchaos.ChaosSpec, chaos=jchaos,
                      Heartbeat=jres.Heartbeat, telemetry=jtel, dev={})
TORCH = SimpleNamespace(name="torch", Router=Router,
                        RouterConfig=RouterConfig, Engine=Engine,
                        EngineConfig=EngineConfig,
                        ChaosSpec=tchaos.ChaosSpec, chaos=tchaos,
                        Heartbeat=tres.Heartbeat, telemetry=ttel,
                        dev={"device": "cpu"})
PKGS = [JAX, TORCH]
_IDS = ["jax", "torch"]

# wall-clock series: their values cannot compare across packages
_WALL_GAUGES = ("serve.itl_p99_ewma_ms",)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    jtel.reset_for_tests()
    ttel.reset_for_tests()
    yield
    jtel.reset_for_tests()
    ttel.reset_for_tests()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _chaos(pkg, chaos):
    return {i: pkg.ChaosSpec(points) for i, points in chaos.items()}


def _engine(pkg, chaos=None, params=PARAMS, **over):
    cfg = dict(ECFG, **over)
    return pkg.Engine(params, pkg.EngineConfig(**cfg),
                      chaos=pkg.ChaosSpec(chaos or {}), **pkg.dev)


def _router(pkg, rcfg=None, chaos=None, clock=None, params=PARAMS,
            router_kw=None, **over):
    kw = dict(router_kw or {})
    if clock is not None:
        kw["clock"] = clock
    rcfg = rcfg or {"replicas": 2}
    return pkg.Router(params, pkg.EngineConfig(**dict(ECFG, **over)),
                      pkg.RouterConfig(**rcfg),
                      chaos=_chaos(pkg, chaos or {}), **kw, **pkg.dev)


def _fleet(pkg, prompts=PROMPTS, kws=KW, **kw):
    """Warm a fleet, submit every request (recording where each was
    placed), run it to the end."""
    router = _router(pkg, **kw)
    router.warmup()
    ids = [router.submit(p, **k) for p, k in zip(prompts, kws)]
    placed = [None if router.request(i).replica is None
              else router.request(i).replica.idx for i in ids]
    router.run()
    return router, ids, placed


def _tokens(router, ids):
    return [list(router.request(i).tokens) for i in ids]


def _outcome(router, ids, placed):
    """What must equal across packages, sampled rows included."""
    reqs = [router.request(i) for i in ids]
    return {"placed": placed,
            "states": [r.state for r in reqs],
            "reasons": [r.finish_reason for r in reqs],
            "failovers": [r.failovers for r in reqs],
            "replicas": [(rep.state, rep.death_cause)
                         for rep in router.replicas]}


def _deterministic(flat):
    """A flat snapshot less what depends on the wall clock (histogram
    sums and extremes, the ITL gauge) and the JAX package's compile-cache
    series."""
    return {k: v for k, v in flat.items()
            if not k.startswith("compile") and k not in _WALL_GAUGES
            and not k.endswith((".sum", ".min", ".max"))}


def _both(fn, same_telemetry=True):
    """Run ``fn(pkg)`` for the JAX package then the port, each right
    after a reset of its own registry, and hold the two registries'
    deterministic series equal (``same_telemetry=False`` where sampled
    rows steer what is counted, as speculation's acceptance does);
    returns ``(jax_result, torch_result)`` with both registries left
    holding their run."""
    out = []
    for pkg in PKGS:
        pkg.telemetry.reset_for_tests()
        out.append(fn(pkg))
    if same_telemetry:
        assert (_deterministic(ttel.snapshot_flat())
                == _deterministic(jtel.snapshot_flat()))
    return out


def _clean_port():
    """The no-failure port fleet every chaos scenario must reproduce,
    sampled rows included."""
    router, ids, _ = _fleet(TORCH)
    return _tokens(router, ids)


def _greedy(rows):
    return [rows[i] for i in GREEDY]


# ---------------------------------------------------------------------------
# Heartbeat and the chaos spec, in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS, ids=_IDS)
def test_heartbeat_progress_based(pkg):
    clk = _Clock()
    hb = pkg.Heartbeat(timeout_ms=100, clock=clk)
    assert hb.beat("a", progress=0)           # first observation
    clk.t = 0.05
    assert not hb.beat("a", progress=0)       # no progress -> no beat
    assert hb.age_ms("a") == pytest.approx(50)
    assert hb.beat("a", progress=1)
    assert hb.age_ms("a") == 0
    clk.t = 0.2
    assert not hb.beat("a", progress=1)
    assert hb.stale() == ["a"]
    hb.beat("b")                              # progress-less: always beats
    clk.t = 0.25
    assert hb.beat("b")
    assert hb.stale() == ["a"]
    assert hb.age_ms("a", now=0.3) == pytest.approx(250)
    hb.forget("a")
    assert hb.stale() == []
    assert hb.age_ms("never-seen") == 0       # unknown is not dead


@pytest.mark.parametrize("pkg", PKGS, ids=_IDS)
def test_chaos_kinds_parse_and_filter(pkg, monkeypatch):
    c = pkg.chaos
    assert (c.KINDS, c.SERVE_KINDS, c.ELASTIC_KINDS) == (
        tchaos.KINDS, tchaos.SERVE_KINDS, tchaos.ELASTIC_KINDS)
    spec = c.ChaosSpec.parse("serve_crash:4|nan:2|serve_hang:7,9|"
                             "worker_kill:3")
    assert spec.at("serve_crash", 4) and spec.at("serve_hang", 9)
    assert spec.points == {"serve_crash": {4}, "nan": {2},
                           "serve_hang": {7, 9}, "worker_kill": {3}}
    assert not c.ChaosSpec({"serve_crash": set()})   # empty points drop
    with pytest.raises(ValueError):
        c.ChaosSpec.parse("serve_typo:1")
    with pytest.raises(ValueError):
        c.ChaosSpec.parse("serve_crash")
    monkeypatch.setenv("MXNET_TPU_CHAOS",
                       "nan:3|serve_poison_logits:5|partition:8")
    assert c.from_env().points == {"nan": {3}, "serve_poison_logits": {5},
                                   "partition": {8}}
    sub = c.serve_from_env()
    assert sub.points == {"serve_poison_logits": {5}}
    assert c.elastic_from_env().points == {"partition": {8}}
    monkeypatch.setenv("MXNET_TPU_CHAOS", "nan:3")
    assert c.serve_from_env() is None and c.elastic_from_env() is None
    monkeypatch.setenv("MXNET_TPU_CHAOS", "  ")
    assert c.from_env() is None
    monkeypatch.setenv("MXNET_TPU_CHAOS_REPLICA", "2")
    monkeypatch.setenv("MXNET_TPU_CHAOS_WORKER", "3")
    assert (c.chaos_replica(), c.chaos_worker()) == (2, 3)
    monkeypatch.delenv("MXNET_TPU_CHAOS_REPLICA")
    monkeypatch.delenv("MXNET_TPU_CHAOS_WORKER")
    assert (c.chaos_replica(), c.chaos_worker()) == (0, 1)


def test_engine_and_router_read_chaos_from_env(monkeypatch):
    """``chaos=None`` reads ``MXNET_TPU_CHAOS``'s serve kinds (the router
    aims them at ``MXNET_TPU_CHAOS_REPLICA``); an empty spec forces chaos
    off."""
    monkeypatch.setenv("MXNET_TPU_CHAOS", "nan:1|serve_crash:3")
    monkeypatch.setenv("MXNET_TPU_CHAOS_REPLICA", "1")
    eng = Engine(PARAMS, EngineConfig(**ECFG), device="cpu")
    assert eng.chaos.points == {"serve_crash": {3}}
    off = Engine(PARAMS, EngineConfig(**ECFG), device="cpu",
                 chaos=tchaos.ChaosSpec({}))
    assert off.chaos is None and not off.stats()["chaos"]
    router = Router(PARAMS, EngineConfig(**ECFG), RouterConfig(replicas=2),
                    device="cpu")
    assert [rep.engine.chaos is None for rep in router.replicas] == [
        True, False]
    bare = Router(PARAMS, EngineConfig(**ECFG), RouterConfig(replicas=2),
                  chaos=tchaos.ChaosSpec({"serve_hang": {2}}),
                  device="cpu")
    assert bare.replicas[1].engine.chaos.at("serve_hang", 2)


# ---------------------------------------------------------------------------
# Router basics
# ---------------------------------------------------------------------------

def test_router_matches_single_engine_and_jax_fleet():
    eng = _engine(TORCH)
    eng.warmup()
    alone = [eng.result(eng.submit(p, **k))
             for p, k in zip(PROMPTS[:3], KW[:3])]
    (jr, jids, jplaced), (tr, tids, tplaced) = _both(
        lambda pkg: _fleet(pkg, PROMPTS[:3], KW[:3]))
    got = _tokens(tr, tids)
    assert got == alone
    # placement is deterministic least-loaded: both replicas used
    assert tplaced == jplaced and set(tplaced) == {0, 1}
    assert got[0] == list(jr.request(jids[0]).tokens)
    assert got[2] == list(jr.request(jids[2]).tokens)


def test_router_rejects_bad_submit_without_ghost_entry():
    router = _router(TORCH)
    with pytest.raises(MXNetError):
        router.submit([])
    with pytest.raises(MXNetError):
        router.submit([1] * 99)
    assert router.stats()["requests"] == 0
    with pytest.raises(MXNetError):
        router.request(12345)
    with pytest.raises(MXNetError):
        Router(PARAMS, EngineConfig(**ECFG), RouterConfig(replicas=0),
               device="cpu")


# ---------------------------------------------------------------------------
# Mid-stream replica death: crash and hang
# ---------------------------------------------------------------------------

def test_failover_crash_mid_stream_byte_identical():
    ref = _clean_port()
    (jr, jids, jplaced), (tr, tids, tplaced) = _both(
        lambda pkg: _fleet(pkg, chaos={0: {"serve_crash": {4}}}))
    got = _tokens(tr, tids)
    # every request completed despite the death, the merged streams are
    # the clean fleet's byte for byte (sampled rows too)...
    assert got == ref
    # ...greedy rows, placement, failovers and the death equal JAX's
    assert _greedy(got) == _greedy(_tokens(jr, jids))
    assert _outcome(tr, tids, tplaced) == _outcome(jr, jids, jplaced)
    assert [tr.request(i).state for i in tids] == ["finished"] * len(tids)
    dead, surv = tr.replicas
    assert dead.state == DEAD and dead.death_cause == "crash"
    assert dead.death_error == "ChaosError"
    assert surv.state == HEALTHY and surv.engine.alloc.num_used == 0
    assert surv.death_error is None
    assert tr.stats()["failovers"] == jr.stats()["failovers"] >= 1
    assert len(tr.recoveries_ms) == len(jr.recoveries_ms) >= 1
    flat = ttel.snapshot_flat()
    assert flat.get("serve.router.deaths{cause=crash}") == 1
    assert flat.get("serve.chaos_injected{kind=crash}") == 1
    assert flat.get("flight.dumps{reason=serve-replica-death}") == 1
    assert flat.get("serve.router.failovers", 0) >= 1


def test_failover_stream_is_seamless_to_the_client():
    ref = _clean_port()
    router = _router(TORCH, chaos={1: {"serve_crash": {4}}})
    router.warmup()
    ids = [router.submit(p, **k) for p, k in zip(PROMPTS, KW)]
    # drive through stream() of a sampled request on the dying replica:
    # the client sees tokens, never the failure
    victim = next(i for i in ids if router.request(i).replica.idx == 1
                  and KW[ids.index(i)]["temperature"] > 0)
    assert list(router.stream(victim)) == ref[ids.index(victim)]
    assert router.request(victim).failovers == 1
    router.run()
    assert _tokens(router, ids) == ref


def test_contained_fault_is_told_from_an_injected_crash(monkeypatch):
    """A step that raises for a reason other than chaos is contained as a
    crash too, but its death records the real exception's type and no
    chaos counter moves, so a check can tell it from an injected one."""
    ref = _clean_port()
    router = _router(TORCH)
    router.warmup()
    ids = [router.submit(p, **k) for p, k in zip(PROMPTS, KW)]
    eng = router.replicas[0].engine

    def broken():
        raise RuntimeError("a fault on the device")

    monkeypatch.setattr(eng, "step", broken)
    router.run()
    assert _tokens(router, ids) == ref
    dead = router.replicas[0]
    assert (dead.state, dead.death_cause, dead.death_error) == (
        DEAD, "crash", "RuntimeError")
    assert router.stats()["replicas"][0]["death_error"] == "RuntimeError"
    flat = ttel.snapshot_flat()
    assert flat.get("serve.router.deaths{cause=crash}") == 1
    assert not any(k.startswith("serve.chaos_injected") for k in flat)


def test_hang_heartbeat_timeout_failover():
    ref = _clean_port()

    def run(pkg):
        clk = _Clock()
        router = _router(pkg, {"replicas": 2, "heartbeat_timeout_ms": 500},
                         chaos={0: {"serve_hang": {3}}}, clock=clk)
        router.warmup()
        ids = [router.submit(p, **k) for p, k in zip(PROMPTS, KW)]
        placed = [router.request(i).replica.idx for i in ids]
        for _ in range(5):
            router.step()
        # wedged: step() returns but beat stopped, and the clock has not
        # moved, so the replica is not dead yet...
        hung = router.replicas[0]
        assert hung.engine._hung and hung.state == HEALTHY
        beat = hung.engine.beat
        router.step()
        assert hung.engine.beat == beat
        # ...until the timeout elapses
        clk.t = 1.0
        router.step()
        assert hung.state == DEAD and hung.death_cause == "heartbeat"
        router.run()
        return router, ids, placed

    (jr, jids, jplaced), (tr, tids, tplaced) = _both(run)
    assert _tokens(tr, tids) == ref
    assert _greedy(_tokens(tr, tids)) == _greedy(_tokens(jr, jids))
    assert _outcome(tr, tids, tplaced) == _outcome(jr, jids, jplaced)
    assert tr.replicas[0].engine.stats()["hung"]
    assert tr.recoveries_ms == jr.recoveries_ms       # the virtual clock
    assert ttel.snapshot_flat().get("serve.router.deaths{cause=heartbeat}") \
        == 1


def test_all_replicas_dead_sheds_unavailable():
    def run(pkg):
        router = _router(pkg, {"replicas": 1},
                         chaos={0: {"serve_crash": {2}}})
        router.warmup()
        rid = router.submit(PROMPTS[0], max_new_tokens=8, seed=1)
        router.run()            # death, failover finds no survivor
        late = router.submit(PROMPTS[1], max_new_tokens=4, seed=2)
        return router, [rid, late], [0, None]

    (jr, jids, jplaced), (tr, tids, tplaced) = _both(run)
    assert _outcome(tr, tids, tplaced) == _outcome(jr, jids, jplaced)
    rid, late = tids
    assert tr.request(rid).state == "failed"
    with pytest.raises(ServeError) as exc:
        tr.result(rid)
    assert exc.value.reason == "error"
    assert tr.request(late).finish_reason == "shed"
    assert ttel.snapshot_flat().get("serve.shed{reason=unavailable}") == 1


def test_max_failovers_fails_the_request():
    """A request that outlives ``max_failovers`` deaths fails ``error``
    instead of hopping on (both packages)."""
    def run(pkg):
        router = _router(pkg, {"replicas": 3, "max_failovers": 1},
                         chaos={0: {"serve_crash": {3}},
                                1: {"serve_crash": {2}}})
        router.warmup()
        rid = router.submit(PROMPTS[0], max_new_tokens=12, seed=5)
        router.run()
        return router, [rid], [0]

    (jr, jids, jplaced), (tr, tids, tplaced) = _both(run)
    assert _outcome(tr, tids, tplaced) == _outcome(jr, jids, jplaced)
    assert tr.request(tids[0]).finish_reason == "error"
    assert tr.request(tids[0]).failovers == 2


# ---------------------------------------------------------------------------
# NaN logits (serve_poison_logits): failed set and scrub
# ---------------------------------------------------------------------------

def test_poison_logits_finishes_error_and_scrubs():
    clean = _engine(TORCH)
    clean.warmup()
    ref = clean.result(clean.submit(PROMPTS[2], **KW[2]))

    def run(pkg):
        eng = _engine(pkg, chaos={"serve_poison_logits": {3}})
        eng.warmup()
        ids = [eng.submit(PROMPTS[0], **KW[0]),
               eng.submit(PROMPTS[1], **KW[1])]
        reasons = []
        for rid in ids:
            with pytest.raises(ServeError if pkg is TORCH
                               else Exception) as exc:
                eng.result(rid)
            assert exc.value.reason == "error"
            assert exc.value.request_id == rid
            reasons.append((eng.request(rid).state,
                            eng.request(rid).finish_reason,
                            eng.request(rid).blocks))
        assert eng.alloc.num_used == 0
        return eng, reasons

    (jeng, jreasons), (teng, treasons) = _both(run)
    assert treasons == jreasons == [("failed", "error", [])] * 2
    flat = ttel.snapshot_flat()
    assert flat.get("serve.nan_logits") == 2
    assert flat.get("serve.chaos_injected{kind=poison}") == 1
    assert flat.get("serve.evictions{reason=error}") == 2
    # the contaminated blocks were scrubbed: the next request reusing
    # them decodes exactly as on a clean engine, and the poison cache
    # holds NaN copies of the floating-point weights
    assert teng.result(teng.submit(PROMPTS[2], **KW[2])) == ref
    assert all(bool(v.isnan().all()) for v in teng._poison_params.values()
               if v.is_floating_point())


@pytest.mark.parametrize("poison_step", [1, 2])
def test_poison_logits_under_chunked_prefill(poison_step):
    """A poisoned chunk (step 1) or decode step (step 2) under chunked
    prefill with the prefix cache: the same failed set as JAX, nothing
    poisoned is published, and a later request sharing the prompt decodes
    as on a clean engine."""
    over = dict(prefill_chunk=8, prefix_cache=True)
    clean = _engine(TORCH, **over)
    ref = clean.result(clean.submit(PROMPTS[0], **KW[0]))

    def run(pkg):
        eng = _engine(pkg, chaos={"serve_poison_logits": {poison_step}},
                      **over)
        eng.warmup()
        rid = eng.submit(PROMPTS[0], **KW[0])
        with pytest.raises(Exception) as exc:
            eng.result(rid)
        assert exc.value.reason == "error"
        assert eng.alloc.num_used == 0
        return eng, eng.request(rid).tokens

    (jeng, jtoks), (teng, ttoks) = _both(run)
    assert ttoks == jtoks
    assert len(teng.prefix) == len(jeng.prefix)
    assert teng.result(teng.submit(PROMPTS[0], **KW[0])) == ref


# ---------------------------------------------------------------------------
# Deadlines and typed errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["active", "queued", "config_default"])
def test_deadlines_expire(case):
    def run(pkg):
        if case == "active":
            eng = _engine(pkg)
            eng.warmup()
            rid = eng.submit(PROMPTS[0], max_new_tokens=10, deadline_ms=0.0)
            others = []
        elif case == "queued":
            eng = _engine(pkg, max_batch=2)
            eng.warmup()
            others = [eng.submit(PROMPTS[i], max_new_tokens=20, seed=i)
                      for i in range(2)]
            rid = eng.submit(PROMPTS[2], max_new_tokens=4, deadline_ms=0.0)
            eng.step()
            assert eng.request(rid) not in eng.sched.queue
        else:
            eng = _engine(pkg, deadline_ms=0.0)
            eng.warmup()
            rid = eng.submit(PROMPTS[0], max_new_tokens=4)
            others = []
        with pytest.raises(Exception) as exc:
            eng.result(rid)
        assert exc.value.reason == "timeout"
        eng.run()
        req = eng.request(rid)
        return (req.state, req.finish_reason, req.blocks,
                [(eng.request(o).state, eng.request(o).tokens)
                 for o in others], eng.alloc.num_used)

    jres_, tres_ = _both(run)
    assert tres_ == jres_
    assert tres_[:3] == ("failed", "timeout", []) and tres_[4] == 0
    assert ttel.snapshot_flat().get("serve.timeouts") == 1


def test_serve_error_is_typed_and_stream_yields_partial_first():
    eng = _engine(TORCH, chaos={"serve_poison_logits": {4}})
    eng.warmup()
    rid = eng.submit(PROMPTS[0], max_new_tokens=10, seed=1)
    got = []
    with pytest.raises(ServeError) as exc:
        for tok in eng.stream(rid):
            got.append(tok)
    assert got == eng.request(rid).tokens and len(got) >= 1
    assert isinstance(exc.value, MXNetError)
    assert exc.value.reason == "error" and exc.value.request_id == rid


def test_engine_step_exception_dumps_flight(tmp_path):
    """A crashing step writes a ``serve-error`` flight dump (when a dump
    directory is set) before the exception propagates."""
    ttel.configure(flightrec_dir=str(tmp_path))
    eng = _engine(TORCH, chaos={"serve_crash": {2}})
    eng.submit(PROMPTS[0], max_new_tokens=6, seed=1)
    eng.step()
    with pytest.raises(tchaos.ChaosError):
        eng.step()
    dumps = list(tmp_path.glob("flightrec-serve-error-*.json"))
    assert len(dumps) == 1
    assert ttel.snapshot_flat()["flight.dumps{reason=serve-error}"] == 1
    assert eng.beat == 1 and eng.stats()["beat"] == 1


# ---------------------------------------------------------------------------
# Drain, undrain and shedding
# ---------------------------------------------------------------------------

def test_drain_migrates_queued_and_finishes_active():
    ref = _clean_port()

    def run(pkg):
        router = _router(pkg, max_batch=2)   # small slots: some requests
        router.warmup()                      # queue
        ids = [router.submit(p, **k) for p, k in zip(PROMPTS, KW)]
        placed = [router.request(i).replica.idx for i in ids]
        router.step()
        router.drain(0)
        assert router.replicas[0].state == DRAINING
        with pytest.raises(Exception):
            router.drain(0)                  # only a healthy one drains
        extra = router.submit(PROMPTS[0], max_new_tokens=4, seed=999)
        assert router.request(extra).replica.idx == 1
        moved = [router.request(i).replica.idx for i in ids]
        router.run()
        assert router.replicas[0].state == DRAINED
        assert router.replicas[0].engine.alloc.num_used == 0
        return router, ids, placed, moved

    (jr, jids, jplaced, jmoved), (tr, tids, tplaced, tmoved) = _both(run)
    assert _tokens(tr, tids) == ref
    assert _greedy(_tokens(tr, tids)) == _greedy(_tokens(jr, jids))
    assert tmoved == jmoved and tmoved != tplaced
    assert _outcome(tr, tids, tplaced) == _outcome(jr, jids, jplaced)
    assert ttel.snapshot_flat().get("serve.router.drains") == 1


def _shed_set(router, ids):
    return [i for i, rid in enumerate(ids)
            if router.request(rid).finish_reason == "shed"]


def test_shed_on_queue_depth():
    def run(pkg):
        router = _router(pkg, {"replicas": 1, "shed_queue_depth": 2})
        router.warmup()
        ids = [router.submit(p, max_new_tokens=4, seed=i)
               for i, p in enumerate(PROMPTS * 2)]
        shed = _shed_set(router, ids)
        router.run()
        return router, ids, shed

    (jr, jids, jshed), (tr, tids, tshed) = _both(run)
    assert tshed == jshed and tshed and len(tshed) < len(tids)
    kept = [rid for i, rid in enumerate(tids) if i not in tshed]
    assert all(tr.request(i).state == "finished" for i in kept)
    assert _tokens(tr, tids) == _tokens(jr, jids)     # greedy, all rows
    with pytest.raises(ServeError) as exc:
        tr.result(tids[tshed[0]])
    assert exc.value.reason == "shed"
    assert ttel.snapshot_flat().get("serve.shed{reason=queue}") == len(tshed)


def test_shed_on_kv_pressure():
    def run(pkg):
        router = _router(pkg, {"replicas": 1, "shed_kv_frac": 0.01})
        router.warmup()
        first = router.submit(PROMPTS[0], max_new_tokens=6, seed=1)
        router.step()           # blocks now held -> kv_frac over threshold
        second = router.submit(PROMPTS[1], max_new_tokens=4, seed=2)
        router.run()
        return router, [first, second], [0, None]

    (jr, jids, jplaced), (tr, tids, tplaced) = _both(run)
    assert _outcome(tr, tids, tplaced) == _outcome(jr, jids, jplaced)
    assert _shed_set(tr, tids) == [1]
    assert ttel.snapshot_flat().get("serve.shed{reason=kv}") == 1


def test_shed_on_slo_estimate():
    """Within the port: the SLO estimate divides by the router's
    wall-clock step EWMA, so it does not compare across packages."""
    router = _router(TORCH, {"replicas": 1}, max_batch=1)
    router.warmup()
    a = router.submit(PROMPTS[0], max_new_tokens=12, seed=1)
    b = router.submit(PROMPTS[1], max_new_tokens=12, seed=2)  # queues
    for _ in range(3):
        router.step()           # establishes the step-latency EWMA
    assert router.stats()["step_ms_ewma"] > 0.0
    hopeless = router.submit(PROMPTS[2], max_new_tokens=4, seed=3,
                             slo_ms=1e-6)
    assert router.request(hopeless).finish_reason == "shed"
    roomy = router.submit(PROMPTS[3], max_new_tokens=4, seed=4,
                          slo_ms=1e9)
    assert router.request(roomy).finish_reason is None
    router.run()
    assert all(router.request(i).state == "finished" for i in (a, b, roomy))
    assert ttel.snapshot_flat().get("serve.shed{reason=slo}") == 1


def test_cancel_through_the_router():
    def run(pkg):
        router = _router(pkg)
        router.warmup()
        ids = [router.submit(p, **k) for p, k in zip(PROMPTS[:4], KW[:4])]
        router.step()
        router.cancel(ids[1])
        router.run()
        router.cancel(ids[1])                 # done: a no-op
        return router, ids, [0, 1, 0, 1]

    (jr, jids, jplaced), (tr, tids, tplaced) = _both(run)
    assert _outcome(tr, tids, tplaced) == _outcome(jr, jids, jplaced)
    assert tr.request(tids[1]).state == "cancelled"
    assert ttel.snapshot_flat().get("serve.cancelled") == 1


# ---------------------------------------------------------------------------
# Adoption and configuration
# ---------------------------------------------------------------------------

def test_adopt_replays_exact_continuation():
    eng_a = _engine(TORCH)
    full = eng_a.result(eng_a.submit(PROMPTS[1], **KW[1]))
    eng_b = _engine(TORCH)
    rid = eng_b.adopt(PROMPTS[1], full[:4], **KW[1])
    assert eng_b.result(rid) == full
    assert ttel.snapshot_flat().get("serve.adopted") == 1
    with pytest.raises(MXNetError):
        eng_b.adopt(PROMPTS[0], [1, 2], max_new_tokens=8)   # no seed
    with pytest.raises(MXNetError):
        eng_b.adopt(PROMPTS[0], [1, 2], max_new_tokens=2, seed=1)


@pytest.mark.parametrize("pkg", PKGS, ids=_IDS)
def test_router_config_from_env(pkg, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SERVE_REPLICAS", "3")
    monkeypatch.setenv("MXNET_TPU_SERVE_HEARTBEAT_MS", "750")
    monkeypatch.setenv("MXNET_TPU_SERVE_SHED_QUEUE", "9")
    monkeypatch.setenv("MXNET_TPU_SERVE_SHED_KV_FRAC", "0.85")
    cfg = pkg.RouterConfig.from_env()
    assert (cfg.replicas, cfg.heartbeat_timeout_ms, cfg.shed_queue_depth,
            cfg.shed_kv_frac, cfg.max_failovers) == (3, 750, 9, 0.85, 3)
    assert pkg.RouterConfig.from_env(replicas=1).replicas == 1
    monkeypatch.setenv("MXNET_TPU_SERVE_SHED_QUEUE", "0")
    assert pkg.RouterConfig.from_env().shed_queue_depth is None


@pytest.mark.parametrize("pkg", PKGS, ids=_IDS)
def test_engine_deadline_from_env(pkg, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SERVE_DEADLINE_MS", "1234")
    assert pkg.EngineConfig.from_env(heads=H).deadline_ms == 1234


# ---------------------------------------------------------------------------
# Rolling swaps: hot, rebuild, forbidden (tests/test_online.py's cases)
# ---------------------------------------------------------------------------

A = PARAMS
B = init_params(V, NL, D, seed=1)
BIG = init_params(V + 4, NL, D, seed=3)        # vocab grew: incompatible
S_PROMPTS = [[3, 1, 4], [1, 5, 9, 2], [6, 5], [3, 5, 8, 9, 7]]
S_KW = [dict(max_new_tokens=12, temperature=0.0, seed=100),
        dict(max_new_tokens=10, temperature=0.8, seed=101),
        dict(max_new_tokens=12, temperature=0.0, seed=102),
        dict(max_new_tokens=8, temperature=1.1, top_k=7, seed=103)]


def _swap_ref(params=A):
    router, ids, _ = _fleet(TORCH, S_PROMPTS, S_KW, params=params)
    return _tokens(router, ids)


def _fresh(pkg, params, prompt, **kw):
    eng = _engine(pkg, params=params)
    return eng.result(eng.submit(prompt, **kw))


def test_rolling_swap_mid_stream_keeps_streams_hot():
    """A swap landing mid-stream takes effect at the next request
    boundary: every in-flight stream (greedy and sampled) finishes as in
    a no-swap run; requests after it run on the new weights."""
    want = _swap_ref()

    def run(pkg):
        router = _router(pkg, params=A)
        router.warmup()
        ids = [router.submit(p, **k) for p, k in zip(S_PROMPTS, S_KW)]
        for _ in range(3):
            router.step()           # streams genuinely mid-flight
        assert any(not router.request(i).done() for i in ids)
        summary = router.rolling_swap({k: np.array(v, copy=True)
                                       for k, v in B.items()})
        router.run()
        post = router.result(router.submit([9, 8, 7], max_new_tokens=6,
                                           seed=55))
        return router, ids, summary, post

    (jr, jids, jsum, jpost), (tr, tids, tsum, tpost) = _both(run)
    assert tsum["mode"] == jsum["mode"] == "hot"
    assert tsum["replicas"] == jsum["replicas"] == [0, 1]
    assert len(tsum["swap_ms"]) == 2 and tsum["report"] == jsum["report"]
    assert _tokens(tr, tids) == want
    assert [_tokens(tr, tids)[i] for i in (0, 2)] == [
        _tokens(jr, jids)[i] for i in (0, 2)]
    for rep in tr.replicas:
        assert rep.state == HEALTHY and rep.engine.swap_count == 1
        assert rep.engine.alloc.num_used == 0
    assert tpost == jpost == _fresh(TORCH, B, [9, 8, 7], max_new_tokens=6,
                                    seed=55)
    flat = ttel.snapshot_flat()
    assert flat.get("online.swaps") == 2
    assert flat.get("online.swap_ms.count") == 2
    assert flat.get("online.rebuilds") is None


def test_streams_completed_before_swap_identical():
    want = _swap_ref()
    router, ids, _ = _fleet(TORCH, S_PROMPTS, S_KW)
    router.rolling_swap(B)
    assert _tokens(router, ids) == want


def test_rolling_swap_incompatible_rebuilds():
    def run(pkg):
        router, ids, _ = _fleet(pkg, S_PROMPTS, S_KW)
        engines = [rep.engine for rep in router.replicas]
        summary = router.rolling_swap(BIG)
        for rep, old in zip(router.replicas, engines):
            assert rep.engine is not old and rep.state == HEALTHY
            assert rep.engine.vocab == V + 4
        assert all(router.request(i).state == "finished" for i in ids)
        post = router.result(router.submit([7, 7, 7], max_new_tokens=5))
        return summary, post

    (jsum, jpost), (tsum, tpost) = _both(run)
    assert tsum["mode"] == jsum["mode"] == "rebuild"
    assert tsum["report"] == jsum["report"]
    assert not tsum["report"]["compatible"]
    assert tpost == jpost == _fresh(TORCH, BIG, [7, 7, 7], max_new_tokens=5)
    assert ttel.snapshot_flat().get("online.rebuilds") == 2


def test_rolling_swap_rebuild_forbidden_fleet_untouched():
    want = _swap_ref()
    router = _router(TORCH)
    router.warmup()
    engines = [rep.engine for rep in router.replicas]
    with pytest.raises(MXNetError, match="rebuild is disabled"):
        router.rolling_swap(BIG, allow_rebuild=False)
    for rep, eng in zip(router.replicas, engines):
        assert rep.state == HEALTHY and rep.engine is eng
        assert eng.swap_count == 0
    ids = [router.submit(p, **k) for p, k in zip(S_PROMPTS, S_KW)]
    router.run()
    assert _tokens(router, ids) == want
    # an engine refuses an incompatible dict without touching anything,
    # and a checkpoint path goes through predictor.load_weights (which
    # names what it could not find)
    with pytest.raises(MXNetError, match="incompatible"):
        engines[0].swap_weights(BIG)
    assert engines[0].swap_count == 0
    for call in (lambda: engines[0].swap_weights("ckpt-prefix"),
                 lambda: router.rolling_swap("ckpt-prefix")):
        with pytest.raises(MXNetError, match="ckpt-prefix-0000.params"):
            call()
    with pytest.raises(MXNetError, match="target"):
        router.rolling_swap(A, target="bogus")


def test_rolling_swap_env_rebuild_knob(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_ONLINE_REBUILD", "0")
    router = _router(TORCH)
    router.warmup()
    with pytest.raises(MXNetError, match="rebuild is disabled"):
        router.rolling_swap(BIG)
    # the explicit argument wins over the environment
    assert router.rolling_swap(BIG, allow_rebuild=True)["mode"] == "rebuild"


def test_swap_drops_poison_cache_and_prefix_index():
    """A swap invalidates what the old weights made: the NaN-poison cache
    and the prefix index (its blocks return to the free list)."""
    eng = _engine(TORCH, chaos={"serve_poison_logits": {1}},
                  prefill_chunk=4, prefix_cache=True)
    rid = eng.submit(PROMPTS[0], **KW[0])
    with pytest.raises(ServeError):
        eng.result(rid)
    assert eng._poison_params is not None
    eng.result(eng.submit(list(range(1, 13)), max_new_tokens=2))
    assert len(eng.prefix) > 0 and eng.alloc.num_cached > 0
    version = eng.prefix.version
    eng.swap_weights(B)
    assert eng._poison_params is None and len(eng.prefix) == 0
    assert eng.prefix.version == version + 1 and eng.alloc.num_cached == 0
    assert eng.stats()["weight_swaps"] == 1


# ---------------------------------------------------------------------------
# Prefix-affinity placement (tests/test_prefix_cache.py's router cases)
# ---------------------------------------------------------------------------

PREFIX = [7, 3, 11, 19, 2, 40, 5, 8, 23, 17, 31, 4]
SUFFIXES = [[50, 51], [52, 53, 54], [55], [56, 57], [58, 59, 60]]
P_KW = [dict(max_new_tokens=8, temperature=(0.8 if i % 2 else 0.0),
             top_k=(5 if i % 2 else 0), seed=900 + i)
        for i in range(len(SUFFIXES))]
P_CFG = dict(prefill_chunk=4, prefix_cache=True)


def test_router_prefix_affinity_dispatch():
    def run(pkg):
        router = _router(pkg, **P_CFG)
        router.warmup()
        r0 = router.submit(PREFIX + SUFFIXES[0], **P_KW[0])
        router.run()
        first = router.request(r0).replica.idx
        placed = [first]
        # the warm replica wins dispatch for prefix-sharing prompts, even
        # though least-loaded alone would alternate
        for sfx, kw in zip(SUFFIXES[1:3], P_KW[1:3]):
            rid = router.submit(PREFIX + sfx, **kw)
            placed.append(router.request(rid).replica.idx)
            router.run()
        rid = router.submit([44, 45, 46], max_new_tokens=4)
        placed.append(router.request(rid).replica.idx)
        router.run()
        return placed, router.replicas[first].engine.stats()["prefix"]

    (jplaced, jpref), (tplaced, tpref) = _both(run)
    assert tplaced == jplaced
    assert tplaced[1:3] == [tplaced[0]] * 2
    assert tpref["hits"] == jpref["hits"] == 2


def test_failover_with_warm_destination_byte_identical():
    prompts = [PREFIX + s for s in SUFFIXES[:4]]
    kws = P_KW[:4]
    refs = []
    for p, k in zip(prompts, kws):
        e = _engine(TORCH, prefill_chunk=4)
        refs.append(e.result(e.submit(p, **k)))

    def run(pkg):
        router = _router(pkg, chaos={0: {"serve_crash": {5}}}, **P_CFG)
        router.warmup()
        # pre-warm both caches: affinity ties on the prefix and load
        # spreads the streams, so the crash kills live streams whose
        # failover destination is already warm
        for rep in router.replicas:
            rep.engine.result(rep.engine.submit(PREFIX + [49],
                                                max_new_tokens=2))
        ids = [router.submit(p, **k) for p, k in zip(prompts, kws)]
        placed = [router.request(i).replica.idx for i in ids]
        router.run()
        surv = router.replicas[1].engine
        surv.check_tables()
        assert surv.alloc.num_used == 0
        return router, ids, placed

    (jr, jids, jplaced), (tr, tids, tplaced) = _both(run)
    assert _tokens(tr, tids) == refs
    assert [_tokens(tr, tids)[i] for i in (0, 2)] == [
        _tokens(jr, jids)[i] for i in (0, 2)]
    assert _outcome(tr, tids, tplaced) == _outcome(jr, jids, jplaced)
    assert tr.replicas[1].engine.stats()["prefix"]["hits"] >= 1
    assert ttel.snapshot_flat().get("serve.router.failovers", 0) >= 1


# ---------------------------------------------------------------------------
# Speculation under the router (tests/test_speculate.py's router cases)
# ---------------------------------------------------------------------------

DRAFT = init_params(V, NL, D, seed=7)
X_PROMPTS = [[1, 2, 3], [10, 11, 12, 13, 14, 15], [20, 21], [30, 31, 32, 33]]
X_KW = [dict(max_new_tokens=10, seed=101),
        dict(max_new_tokens=8, temperature=0.9, top_k=7, seed=202),
        dict(max_new_tokens=12, seed=303),
        dict(max_new_tokens=6, temperature=1.3, seed=404)]
X_GREEDY = (0, 2)


def _spec_router(pkg, chaos=None, model=False, replicas=2):
    over = dict(speculate=True, spec_k=(3 if model else 4))
    kw = {}
    if model:
        over["spec_draft"] = "model"
        kw = dict(draft_params=DRAFT, draft_heads=H)
    return _router(pkg, {"replicas": replicas}, chaos=chaos,
                   router_kw=kw, **over)


def _x_plain():
    router, ids, _ = _fleet(TORCH, X_PROMPTS, X_KW)
    return _tokens(router, ids)


def test_router_rolling_swap_draft_target():
    """``rolling_swap(target="draft")`` deploys draft weights fleet-wide
    with no drain.  Mid-stream with a copy of the held draft weights, no
    stream moves (sampled rows included, within the port); then with the
    target's own weights, greedy rows stay the plain argmax stream in
    both packages."""
    plain = _x_plain()
    clean = _spec_router(TORCH, model=True)
    cids = [clean.submit(p, **k) for p, k in zip(X_PROMPTS, X_KW)]
    clean.run()

    def run(pkg):
        router = _spec_router(pkg, model=True)
        router.warmup()
        ids = [router.submit(p, **k) for p, k in zip(X_PROMPTS, X_KW)]
        router.step()
        same = router.rolling_swap({k: np.array(v, copy=True)
                                    for k, v in DRAFT.items()},
                                   target="draft")
        router.run()
        res = router.rolling_swap(PARAMS, target="draft")
        after = [router.submit(p, **k) for p, k in zip(X_PROMPTS, X_KW)]
        router.run()
        return router, ids, after, same, res

    (jr, jids, jafter, jsame, jres_), (tr, tids, tafter, tsame, tres_) = \
        _both(run, same_telemetry=False)
    for got, want in ((tsame, jsame), (tres_, jres_)):
        assert got["mode"] == want["mode"] == "draft"
        assert got["replicas"] == want["replicas"] == [0, 1]
        assert got["report"] == want["report"]
        assert got["report"]["compatible"] and len(got["swap_ms"]) == 2
    assert [rep.engine.counters["draft_swaps"] for rep in tr.replicas] \
        == [2, 2]
    assert all(rep.state == HEALTHY for rep in tr.replicas)
    assert _tokens(tr, tids) == _tokens(clean, cids)
    for rows in (_tokens(tr, tids), _tokens(tr, tafter),
                 _tokens(jr, jids), _tokens(jr, jafter)):
        assert [rows[j] for j in X_GREEDY] == [plain[j] for j in X_GREEDY]
    assert ttel.snapshot_flat().get("serve.spec.draft_swaps") == 4
    with pytest.raises(MXNetError, match="target"):
        tr.rolling_swap(PARAMS, target="bogus")


def test_router_swap_draft_requires_model_drafter():
    router = _spec_router(TORCH, replicas=1)
    with pytest.raises(MXNetError, match="model drafter"):
        router.rolling_swap(PARAMS, target="draft")
    model = _spec_router(TORCH, model=True, replicas=1)
    with pytest.raises(MXNetError, match="incompatible"):
        model.rolling_swap(BIG, target="draft")
    assert model.replicas[0].engine.counters["draft_swaps"] == 0


def test_spec_failover_crash_mid_stream_byte_identical():
    """A speculating replica dies mid-stream: the merged streams equal
    the clean speculating port fleet's (sampled rows too: the adopter
    resumes from the last token), greedy rows equal the non-speculative
    fleet's and the JAX speculating fleet's."""
    plain = _x_plain()
    clean = _spec_router(TORCH)
    cids = [clean.submit(p, **k) for p, k in zip(X_PROMPTS, X_KW)]
    clean.run()
    ref = _tokens(clean, cids)

    def run(pkg):
        # speculation compresses the step count: crash early so the
        # replica still holds live streams when it dies
        router = _spec_router(pkg, chaos={0: {"serve_crash": {2}}})
        router.warmup()
        ids = [router.submit(p, **k) for p, k in zip(X_PROMPTS, X_KW)]
        placed = [router.request(i).replica.idx for i in ids]
        router.run()
        return router, ids, placed

    (jr, jids, jplaced), (tr, tids, tplaced) = _both(
        run, same_telemetry=False)
    got = _tokens(tr, tids)
    assert got == ref
    assert [got[j] for j in X_GREEDY] == [plain[j] for j in X_GREEDY] == [
        _tokens(jr, jids)[j] for j in X_GREEDY]
    assert _outcome(tr, tids, tplaced) == _outcome(jr, jids, jplaced)
    dead, surv = tr.replicas
    assert dead.state == DEAD and surv.state == HEALTHY
    assert surv.engine.alloc.num_used == 0
    assert sum(r.failovers for r in map(tr.request, tids)) >= 1


# ---------------------------------------------------------------------------
# Threads: a client streams while an operator drains and the loop steps
# ---------------------------------------------------------------------------

def test_stream_drain_and_step_from_three_threads():
    """One thread streams a request of replica 0, another drains replica
    0, the main thread steps the fleet: the stream is a clean prefix of
    (and ends equal to) the final tokens, which equal the clean fleet's."""
    ref = _clean_port()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        router = _router(TORCH, max_batch=2)
        router.warmup()
        ids = [router.submit(p, **k) for p, k in zip(PROMPTS, KW)]
        victim = ids[0]
        seen, errors = [], []
        drained = threading.Event()

        def client():
            try:
                for tok in router.stream(victim):
                    seen.append(tok)
                    assert seen == router.request(victim).tokens[:len(seen)]
            except Exception as exc:   # noqa: BLE001 — reported below
                errors.append(exc)

        def operator():
            try:
                router.drain(0)
            except Exception as exc:   # noqa: BLE001
                errors.append(exc)
            drained.set()

        threads = [threading.Thread(target=client),
                   threading.Thread(target=operator)]
        for t in threads:
            t.start()
        for _ in range(1000):
            if drained.is_set() and all(router.request(i).done()
                                        for i in ids):
                break
            router.step()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert seen == list(router.request(victim).tokens)
    assert _tokens(router, ids) == ref
    assert router.replicas[0].state in (DRAINING, DRAINED)
