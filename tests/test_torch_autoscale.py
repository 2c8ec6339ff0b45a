"""Closed-loop autoscaling of the PyTorch port (mxnet_tpu_torch/serve/
autoscale.py) and the router's fleet-sizing surface (``scale_to``,
``undrain``), against the JAX package on the CPU.

* The policy cases of tests/test_autoscale.py run against each package's
  ``Autoscaler`` over a fake router and a fake clock, with gauges set in
  that package's own telemetry registry: every poll gives the same
  decision (direction, target, signals, time) in both.
* On real fleets (V 61, 2 layers, d 32): ``scale_to`` spawns a warm
  replica, drains the least-loaded one and parks it, reactivates parked
  replicas before spawning; the fleet gauges stay fresh under shedding;
  each outcome equals the JAX fleet's.
* A small closed-loop ``LoadGen`` run with the autoscaler gives the JAX
  run's scale schedule, shed set and greedy streams.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from mxnet_tpu import telemetry as jtel
from mxnet_tpu.serve import AutoscaleConfig as JaxAutoscaleConfig
from mxnet_tpu.serve import Autoscaler as JaxAutoscaler
from mxnet_tpu.serve import EngineConfig as JaxEngineConfig
from mxnet_tpu.serve import Router as JaxRouter
from mxnet_tpu.serve import RouterConfig as JaxRouterConfig
from mxnet_tpu.serve import autoscale as jasc
from mxnet_tpu.serve import traffic as jtr
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.transformer import init_params
from mxnet_tpu_torch.serve import (AutoscaleConfig, Autoscaler,
                                   EngineConfig, Router, RouterConfig)
from mxnet_tpu_torch.serve import autoscale as tasc
from mxnet_tpu_torch.serve import traffic as ttr
from mxnet_tpu_torch.serve.router import DRAINED, DRAINING, HEALTHY

V, NL, D, H = 61, 2, 32, 4
PARAMS = init_params(V, NL, D, seed=0)
ECFG = dict(heads=H, block_size=4, num_blocks=64, max_batch=4,
            max_prompt_len=16, max_seq_len=48, prompt_bucket_min=8)

JAX = SimpleNamespace(name="jax", Autoscaler=JaxAutoscaler,
                      AutoscaleConfig=JaxAutoscaleConfig, mod=jasc,
                      Router=JaxRouter, RouterConfig=JaxRouterConfig,
                      EngineConfig=JaxEngineConfig, traffic=jtr,
                      telemetry=jtel, dev={})
TORCH = SimpleNamespace(name="torch", Autoscaler=Autoscaler,
                        AutoscaleConfig=AutoscaleConfig, mod=tasc,
                        Router=Router, RouterConfig=RouterConfig,
                        EngineConfig=EngineConfig, traffic=ttr,
                        telemetry=ttel, dev={"device": "cpu"})
PKGS = [JAX, TORCH]


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    jtel.reset_for_tests()
    ttel.reset_for_tests()
    yield
    jtel.reset_for_tests()
    ttel.reset_for_tests()


def _deterministic(flat):
    return {k: v for k, v in flat.items()
            if not k.startswith("compile") and k != "serve.itl_p99_ewma_ms"
            and not k.endswith((".sum", ".min", ".max"))}


def _both(fn):
    """``fn(pkg)`` for each package after a reset of its registry; holds
    the deterministic telemetry equal; returns (jax, torch) results."""
    out = []
    for pkg in PKGS:
        pkg.telemetry.reset_for_tests()
        out.append(fn(pkg))
    assert (_deterministic(ttel.snapshot_flat())
            == _deterministic(jtel.snapshot_flat()))
    return out


# ----------------------------------------------------------------------
# Policy units: fake router, fake clock, hand-set gauges
# ----------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeRouter:
    """Just the surface the autoscaler reads and actuates."""

    def __init__(self, healthy=1):
        self.healthy = healthy
        self.calls = []

    def healthy_count(self):
        return self.healthy

    def scale_to(self, n, **kw):
        self.calls.append(n)
        self.healthy = n
        return {"target": n}


PCFG = dict(min_replicas=1, max_replicas=4, interval_s=1.0,
            high_queue=8.0, low_queue=1.0, high_kv_frac=0.85,
            low_kv_frac=0.5, breach_polls=2, cooldown_up_s=5.0,
            cooldown_down_s=10.0)


class Policy:
    """One package's autoscaler over a fake router; ``tick`` advances the
    clock and polls, logging every result."""

    def __init__(self, pkg, **over):
        self.pkg = pkg
        self.clock = FakeClock()
        self.router = FakeRouter()
        self.asc = pkg.Autoscaler(self.router,
                                  pkg.AutoscaleConfig(**dict(PCFG, **over)),
                                  clock=self.clock)
        self.log = []

    def gauges(self, queue=0.0, kv=0.0, itl=0.0):
        g = self.pkg.telemetry.gauge
        g("serve.queue_depth").set(queue)
        g("serve.kv_frac").set(kv)
        g("serve.itl_p99_ewma_ms").set(itl)

    def tick(self, dt=1.0):
        self.clock.t += dt
        ev = self.asc.poll()
        self.log.append(ev)
        return ev


def _single_spike(p):
    p.gauges(queue=100.0)
    assert p.tick() is None                 # streak 1 of 2
    p.gauges(queue=0.0)
    assert p.tick() is None                 # spike gone, streak reset
    p.gauges(queue=100.0)
    assert p.tick() is None
    assert p.router.calls == []


def _sustained_breach(p):
    p.gauges(queue=100.0)
    p.tick()
    ev = p.tick()
    assert ev["direction"] == "up" and ev["target"] == 2
    assert p.router.calls == [2]


def _kv_pressure(p):
    p.gauges(queue=0.0, kv=0.95)
    p.tick()
    assert p.tick()["direction"] == "up"


def _latency_off_by_default(p):
    p.gauges(itl=10_000.0)
    for _ in range(4):
        assert p.tick() is None


def _latency_on(p):
    p.gauges(itl=10_000.0)
    p.tick()
    assert p.tick()["direction"] == "up"


def _dead_band(p):
    p.router.healthy = 2
    for q in (4.0, 7.0, 2.0, 5.0, 7.9, 1.1) * 3:
        p.gauges(queue=q * p.router.healthy)
        assert p.tick() is None
    assert p.router.calls == []


def _cooldown(p):
    p.gauges(queue=100.0)
    p.tick()
    assert p.tick()["target"] == 2
    assert p.tick() is None and p.tick() is None
    p.tick()
    p.tick()
    ev = p.tick()                           # t = +5 since the scale
    assert ev is not None and ev["target"] == 3
    assert p.router.calls == [2, 3]


def _down_needs_all_slack(p):
    p.router.healthy = 3
    p.gauges(queue=0.0, kv=0.7)             # queue slack, KV not
    for _ in range(4):
        assert p.tick() is None
    p.gauges(queue=0.0, kv=0.1)
    p.tick()
    ev = p.tick()
    assert ev["direction"] == "down" and ev["target"] == 2


def _clamp_ceiling(p):
    p.router.healthy = 2
    p.gauges(queue=100.0)
    for _ in range(4):
        assert p.tick() is None


def _clamp_floor(p):
    p.gauges(queue=0.0)
    for _ in range(4):
        assert p.tick() is None
    assert p.router.calls == []


def _floor_repair(p):
    p.router.healthy = 2
    p.gauges(queue=3.0)
    p.tick()
    p.router.healthy = 0                    # deaths
    ev = p.tick()                           # immediate, no streak
    assert ev["direction"] == "floor" and ev["target"] == 2
    p.router.healthy = 1                    # cooldown blocks no repair
    ev = p.tick()
    assert ev["direction"] == "floor" and ev["target"] == 2


def _interval(p):
    p.gauges(queue=100.0)
    p.tick()
    for _ in range(10):
        assert p.tick(dt=0.0) is None       # same instant: no-op
    assert int(p.pkg.telemetry.snapshot_flat()[
        "serve.autoscale.polls"]) == 1


def _summary(p):
    p.gauges(queue=100.0)
    p.tick()
    p.tick()
    p.gauges(queue=0.0)
    p.clock.t += 20.0
    p.tick()
    p.tick()
    s = p.asc.summary()
    assert s["scale_ups"] == 1 and s["scale_downs"] == 1
    flat = p.pkg.telemetry.snapshot_flat()
    assert flat["serve.autoscale.scale_ups"] == 1
    assert flat["serve.autoscale.scale_downs"] == 1
    assert "serve.autoscale.replicas" in flat


POLICY = {
    "single_spike_never_scales": (_single_spike, {}),
    "sustained_breach_scales_up": (_sustained_breach, {}),
    "kv_pressure_alone_scales_up": (_kv_pressure, {}),
    "latency_watermark_off_by_default": (_latency_off_by_default, {}),
    "latency_watermark_on": (_latency_on, {"high_itl_ms": 500.0}),
    "dead_band_no_flapping": (_dead_band, {}),
    "cooldown_blocks_back_to_back_ups": (_cooldown, {}),
    "scale_down_needs_slack_on_all_signals": (_down_needs_all_slack, {}),
    "clamp_at_ceiling": (_clamp_ceiling, {"max_replicas": 2}),
    "clamp_at_floor": (_clamp_floor, {}),
    "floor_repair_bypasses_hysteresis": (_floor_repair,
                                         {"min_replicas": 2}),
    "interval_gates_polls": (_interval, {}),
    "summary_and_telemetry": (_summary, {}),
}


@pytest.mark.parametrize("case", sorted(POLICY))
def test_policy_decisions_equal_jax(case):
    fn, over = POLICY[case]

    def run(pkg):
        p = Policy(pkg, **over)
        fn(p)
        return p.log, p.router.calls, p.asc.summary()

    want, got = _both(run)
    assert got == want


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_config_validation_and_env(pkg, monkeypatch):
    for bad in (dict(min_replicas=3, max_replicas=2),
                dict(min_replicas=0), dict(high_queue=2.0, low_queue=2.0),
                dict(high_kv_frac=0.5, low_kv_frac=0.6)):
        with pytest.raises(Exception):
            pkg.AutoscaleConfig(**bad)
    router = FakeRouter()
    monkeypatch.delenv("MXNET_TPU_SERVE_AUTOSCALE", raising=False)
    assert pkg.mod.autoscaler_from_env(router) is None
    monkeypatch.setenv("MXNET_TPU_SERVE_AUTOSCALE", "1")
    monkeypatch.setenv("MXNET_TPU_SERVE_AUTOSCALE_MAX", "7")
    monkeypatch.setenv("MXNET_TPU_SERVE_AUTOSCALE_HIGH_QUEUE", "5.5")
    monkeypatch.setenv("MXNET_TPU_SERVE_AUTOSCALE_COOLDOWN_DOWN_S", "9")
    asc = pkg.mod.autoscaler_from_env(router)
    assert (asc.config.max_replicas, asc.config.high_queue,
            asc.config.cooldown_down_s) == (7, 5.5, 9.0)


def test_config_errors_are_mxnet_errors():
    with pytest.raises(MXNetError):
        AutoscaleConfig(min_replicas=0)


# ----------------------------------------------------------------------
# Real fleets: scale_to, drain-then-park, reactivation, gauges
# ----------------------------------------------------------------------

def _fleet(pkg, replicas=1, **rover):
    rcfg = dict(replicas=replicas, heartbeat_timeout_ms=60_000.0)
    rcfg.update(rover)
    router = pkg.Router(PARAMS, pkg.EngineConfig(**ECFG),
                        pkg.RouterConfig(**rcfg), chaos={}, **pkg.dev)
    router.warmup()
    return router


def _run_all(router, n=6, tokens=8, seed=3):
    rng = np.random.RandomState(seed)
    rids = [router.submit(list(map(int, rng.randint(1, V, 5))),
                          max_new_tokens=tokens, temperature=0.0)
            for _ in range(n)]
    for _ in range(200):
        if all(router.request(r).done() for r in rids):
            break
        router.step()
    assert all(router.request(r).done() for r in rids)
    return [list(router.request(r).tokens) for r in rids]


def test_scale_up_spawns_warm_replica():
    def run(pkg):
        router = _fleet(pkg, 1)
        res = router.scale_to(2)
        assert router.healthy_count() == 2
        assert router.replicas[1].engine.stats()["steps"] == 0
        return res, _run_all(router)

    (jres, jtoks), (tres, ttoks) = _both(run)
    assert tres == jres == {"target": 2, "healthy_before": 1,
                            "reactivated": [], "spawned": [1],
                            "draining": []}
    assert ttoks == jtoks
    assert ttel.snapshot_flat()["serve.router.spawns"] == 1


def test_scale_down_drains_then_parks_and_reactivates():
    def run(pkg):
        router = _fleet(pkg, 2)
        down = router.scale_to(1)
        assert router.replicas[1].state in (DRAINING, DRAINED)
        for _ in range(3):
            router.step()           # nothing in flight: retire now
        assert router.replicas[1].state == DRAINED
        assert router.healthy_count() == 1
        served = _run_all(router)   # the survivor still serves
        engine = router.replicas[1].engine
        up = router.scale_to(2)
        # a parked replica comes back through undrain: no spawn, the
        # same (warm) engine
        assert router.replicas[1].engine is engine
        assert router.replicas[1].state == HEALTHY
        return down, up, served, _run_all(router, seed=4)

    want, got = _both(run)
    assert got == want
    down, up = got[:2]
    assert down["draining"] == [1] and down["spawned"] == []
    assert up["reactivated"] == [1] and up["spawned"] == []
    flat = ttel.snapshot_flat()
    assert flat["serve.router.undrains"] == 1
    assert "serve.router.spawns" not in flat


def test_scale_down_picks_least_loaded():
    def run(pkg):
        router = _fleet(pkg, 2)
        router.replicas[0].engine.submit([3, 4, 5, 6, 7], max_new_tokens=4)
        res = router.scale_to(1)
        return res, [rep.state for rep in router.replicas]

    (jres, jstates), (tres, tstates) = _both(run)
    assert tres == jres and tres["draining"] == [1]
    assert tstates == jstates and tstates[0] == HEALTHY


def test_undrain_and_scale_to_validation():
    router = _fleet(TORCH, 2)
    with pytest.raises(MXNetError):
        router.undrain(0)           # healthy: nothing to undo
    with pytest.raises(MXNetError):
        router.undrain(99)
    res = router.scale_to(2)
    assert res["spawned"] == [] and res["draining"] == []
    with pytest.raises(MXNetError):
        router.scale_to(0)


def test_closed_loop_on_real_fleet():
    def run(pkg):
        router = _fleet(pkg, 1, shed_queue_depth=50)
        clock = FakeClock()
        asc = pkg.Autoscaler(router, pkg.AutoscaleConfig(
            min_replicas=1, max_replicas=2, interval_s=1.0,
            high_queue=2.0, low_queue=0.5, breach_polls=2,
            cooldown_up_s=3.0, cooldown_down_s=3.0), clock=clock)
        rng = np.random.RandomState(9)
        rids = [router.submit(list(map(int, rng.randint(1, V, 5))),
                              max_new_tokens=6, temperature=0.0)
                for _ in range(10)]
        router.step()               # publishes queue_depth > 2
        clock.t += 1.0
        asc.poll()
        clock.t += 1.0
        ev = asc.poll()
        assert ev is not None and ev["direction"] == "up"
        assert router.healthy_count() == 2
        for _ in range(200):
            if all(router.request(r).done() for r in rids):
                break
            router.step()
        assert all(router.request(r).state == "finished" for r in rids)
        return ev, [list(router.request(r).tokens) for r in rids]

    want, got = _both(run)
    assert got == want


def test_router_step_refreshes_load_gauges_under_shedding():
    """The fleet gauges track every router step, even when the engines
    stop stepping: fill the queue, shed a wave, drain, and the gauges
    land at zero though the shed requests never reached an engine."""
    def run(pkg):
        router = _fleet(pkg, 1, shed_queue_depth=4)
        rng = np.random.RandomState(6)
        rids = [router.submit(list(map(int, rng.randint(1, V, 5))),
                              max_new_tokens=4, temperature=0.0)
                for _ in range(12)]
        shed = [i for i, r in enumerate(rids)
                if router.request(r).finish_reason == "shed"]
        assert shed
        router.step()
        busy = dict(pkg.telemetry.snapshot_flat())
        assert busy["serve.active_slots"] > 0
        assert busy["serve.kv_blocks_used"] > 0
        for _ in range(200):
            if all(router.request(r).done() for r in rids):
                break
            router.step()
        router.step()               # idle fleet: one more step
        flat = pkg.telemetry.snapshot_flat()
        assert flat["serve.queue_depth"] == 0
        assert flat["serve.kv_blocks_used"] == 0
        assert flat["serve.kv_frac"] == 0
        return shed, {k: busy[k] for k in ("serve.queue_depth",
                                           "serve.active_slots",
                                           "serve.kv_blocks_used",
                                           "serve.kv_frac")}

    want, got = _both(run)
    assert got == want


def test_itl_ewma_gauge_publishes():
    router = _fleet(TORCH, 1)
    _run_all(router, n=3, tokens=6)
    assert ttel.snapshot_flat().get("serve.itl_p99_ewma_ms", 0.0) > 0.0
    assert router.stats()["itl_p99_ewma_ms"] > 0.0


# ----------------------------------------------------------------------
# A closed-loop LoadGen run: the scale schedule equals JAX's
# ----------------------------------------------------------------------

# a one-minute ramp that one replica cannot keep up with at 0.5 virtual
# s a step: the queue watermark trips, the autoscaler adds replicas and,
# once the ramp is over, parks them again
LOOP_TRACE = dict(duration_s=60.0, base_rate=1.5, diurnal_period_s=60.0,
                  burst_hazard_per_s=0.0, vocab=V, sys_prompt_min=4,
                  sys_prompt_max=6, max_turns=2, prompt_min=4,
                  prompt_max=8, output_min=6, output_max=12,
                  context_budget=40, think_min_s=1.0, think_max_s=3.0)
LOOP_POLICY = dict(min_replicas=1, max_replicas=3, interval_s=2.0,
                   high_queue=2.0, low_queue=0.5, breach_polls=2,
                   cooldown_up_s=4.0, cooldown_down_s=10.0)


def test_loadgen_closed_loop_schedule_equals_jax():
    def run(pkg):
        trace = pkg.traffic.generate_trace(
            pkg.traffic.TraceConfig(seed=5, **LOOP_TRACE))
        clock = pkg.traffic.VirtualClock()
        router = pkg.Router(
            PARAMS, pkg.EngineConfig(**dict(ECFG, max_queue=64,
                                            max_prompt_len=32,
                                            max_seq_len=64,
                                            prefill_chunk=8)),
            pkg.RouterConfig(replicas=1, heartbeat_timeout_ms=60_000.0,
                             shed_queue_depth=12),
            clock=clock, chaos={}, **pkg.dev)
        router.warmup()
        asc = pkg.Autoscaler(router, pkg.AutoscaleConfig(**LOOP_POLICY),
                             clock=clock)
        res = pkg.traffic.LoadGen(router, trace, clock,
                                  step_virtual_s=0.5, autoscaler=asc).run()
        for _ in range(3):
            router.step()
        sched = [(e["direction"], round(e["t"], 3), e["target"])
                 for e in asc.events]
        shed = sorted((r["sid"], r["turn"]) for r in res["records"]
                      if r["finish_reason"] == "shed")
        leak = sum(rep.engine.alloc.num_used for rep in router.replicas)
        return (sched, shed, res["stream_keys"], res["completed"],
                res["requests"], [rep.state for rep in router.replicas],
                leak)

    want, got = _both(run)
    assert got == want
    sched = got[0]
    assert any(d == "up" for d, _, _ in sched)
    assert any(d == "down" for d, _, _ in sched)
    assert got[-1] == 0
