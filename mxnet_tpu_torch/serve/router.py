"""Fault-tolerant serving control plane: N Engine replicas behind one
front door.

Counterpart of ``mxnet_tpu/serve/router.py`` (host code over the port's
engines, which run on the card; ``Router(..., device="cpu")`` puts every
replica on the CPU).  The router owns a fleet of
:class:`~mxnet_tpu_torch.serve.engine.Engine` replicas, in-process
handles whose surface (submit / adopt / step / beat) is what a
process-backed replica would expose over a pipe.  Per step it:

1. steps every live replica, catching a crashed step (the replica is
   declared **dead**, cause ``crash``),
2. registers a heartbeat per replica — *progress-based*
   (:class:`~mxnet_tpu_torch.resilience.Heartbeat`): a replica whose
   ``beat`` counter stopped advancing is wedged even though ``step()``
   returns, and past ``heartbeat_timeout_ms`` it is declared dead (cause
   ``heartbeat``),
3. syncs every in-flight request's tokens into the router's own
   buffer — the only state failover may rely on; a dead replica's
   memory is gone —
4. and retires replicas whose drain completed.

**Mid-stream failover**: when a replica dies, each of its live
requests is re-submitted to a survivor via ``Engine.adopt(prompt,
tokens_so_far)``.  The survivor re-ingests ``prompt + tokens_so_far``
and, because sampling draws are keyed by (engine seed, request seed,
position), continues the *exact* token stream the dead replica would
have produced — the client-visible sequence is byte-identical to a run
with no failure, greedy and sampled alike.  The router therefore always
assigns the per-request sampling seed itself: engine-implicit seeds
(request ids) could never match across replicas.

**Load shedding** is decided at the front door, per submit, against
the least-loaded healthy replica: hard queue-depth / KV-pressure
thresholds (``shed_queue_depth``, ``shed_kv_frac``) plus an SLO-aware
estimate (queued work x recent step latency already over the request's
``slo_ms``).  A shed request fails fast with reason ``"shed"`` —
``result()``/``stream()`` raise :class:`ServeError` — instead of
queueing toward a deadline it cannot meet.

Every death, failover, shed, and timeout lands in the telemetry
registry (``serve.router.*``, ``serve.shed``, ``serve.timeouts``) and
the flight recorder (``serve-replica-death`` dumps).  Failure
injection comes from :mod:`mxnet_tpu_torch.chaos` serve points
(``serve_crash`` / ``serve_hang`` / ``serve_poison_logits``),
targeted at one replica via ``MXNET_TPU_CHAOS_REPLICA``.

**Threading model**: the router is driven concurrently — a client
thread pulling ``stream()``/``result()``, an ops thread calling
``drain``/``rolling_swap``, the main loop calling ``step()``.  All
mutation of control-plane state (the replica table, the request map,
heartbeats, drain/swap transitions) happens under one reentrant
``_lock``; ``step``, ``submit``, ``cancel``, ``drain``, ``stats`` and
the install phase of ``rolling_swap`` serialize on it.  ``stream()``
deliberately reads a request's ``tokens`` outside the lock: tokens are
append-only and synced by the (locked) step, so a reader sees a clean
prefix.  Every replica launches on the same device from the thread that
steps it, so the lock also keeps two threads from interleaving one
engine's kernels.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from .. import chaos as chaos_mod
from .. import telemetry
from ..base import MXNetError
from ..context import DeviceLike, resolve_device
from ..online.compat import check_compat, signature_of_params
from ..resilience import Heartbeat
from .engine import Engine, EngineConfig, _env_float, _env_int
from .scheduler import ACTIVE, CANCELLED, FAILED, FINISHED, QUEUED, ServeError

__all__ = ["RouterConfig", "Router", "Replica", "RouterRequest",
           "HEALTHY", "DRAINING", "DRAINED", "DEAD"]

HEALTHY = "healthy"
DRAINING = "draining"    # no new work; in-flight requests finish here
DRAINED = "drained"      # drain completed, replica retired
DEAD = "dead"            # crashed or heartbeat-timed-out


@dataclass(frozen=True)
class RouterConfig:
    """Control-plane policy.  Engine geometry lives in
    :class:`EngineConfig`; this is purely routing/health/shedding."""
    replicas: int = 2
    heartbeat_timeout_ms: float = 5000.0
    shed_queue_depth: Optional[int] = None  # None/0 = off
    shed_kv_frac: float = 1.0               # >= this used-fraction sheds
    max_failovers: int = 3                  # per request, then "error"

    @classmethod
    def from_env(cls, **overrides) -> "RouterConfig":
        """Defaults from the JAX package's ``MXNET_TPU_SERVE_*``
        environment variables; explicit keyword arguments win."""
        env = dict(
            replicas=_env_int("MXNET_TPU_SERVE_REPLICAS", 2),
            heartbeat_timeout_ms=_env_float(
                "MXNET_TPU_SERVE_HEARTBEAT_MS", 5000.0),
            shed_queue_depth=(
                _env_int("MXNET_TPU_SERVE_SHED_QUEUE", 0) or None),
            shed_kv_frac=_env_float("MXNET_TPU_SERVE_SHED_KV_FRAC", 1.0),
        )
        env.update(overrides)
        return cls(**env)


@dataclass
class Replica:
    """One engine and its control-plane state."""
    idx: int
    engine: Engine
    state: str = HEALTHY
    death_cause: Optional[str] = None
    # the type of the exception a crashed step raised (ChaosError for an
    # injected crash); None for any other death
    death_error: Optional[str] = None

    @property
    def load(self) -> int:
        return self.engine.sched.active + self.engine.sched.queue_depth

    def kv_frac(self) -> float:
        # cached (refcount-0 prefix) blocks count as available: the
        # allocator evicts them on demand, so they are capacity, not
        # occupancy — a cache-full replica must not shed
        used = self.engine.alloc.num_used
        total = used + self.engine.alloc.num_available
        return used / max(1, total)


@dataclass
class RouterRequest:
    """The router's own view of a request — everything failover needs
    survives here, never only inside a (mortal) replica."""
    rid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float
    top_k: int
    slo_ms: Optional[float]
    eos_id: Optional[int]
    deadline_ms: Optional[float]
    seed: int
    submit_t: float
    state: str = ACTIVE
    finish_reason: Optional[str] = None
    tokens: List[int] = field(default_factory=list)  # synced each step
    # wall-clock latency observation (always time.monotonic, even when
    # the router runs on a virtual clock: queueing and compute are
    # real; only *decisions* are simulated)
    submit_wall: float = 0.0
    token_walls: List[float] = field(default_factory=list)
    replica: Optional[Replica] = None
    engine_rid: Optional[int] = None
    failovers: int = 0
    # set when this request's replica died; cleared (and the recovery
    # latency recorded) when the adopting replica produces a token
    recovering_since: Optional[float] = None

    def done(self) -> bool:
        return self.state in (FINISHED, CANCELLED, FAILED)


class Router:
    """See the module docstring.  ``chaos`` maps replica index ->
    :class:`~mxnet_tpu_torch.chaos.ChaosSpec` (or a bare spec, applied to
    ``MXNET_TPU_CHAOS_REPLICA``); ``None`` reads the environment, an
    empty dict forces chaos off.  ``clock`` is injectable so heartbeat
    tests advance time without sleeping.  ``device=None`` builds every
    replica on the card, as :class:`Engine` does; ``scale_to`` and
    rebuilds use the same device."""

    def __init__(self, params: Dict[str, Any],
                 engine_config: Optional[EngineConfig] = None,
                 config: Optional[RouterConfig] = None, *,
                 chaos: Optional[Any] = None,
                 clock=time.monotonic,
                 draft_params: Optional[Dict[str, Any]] = None,
                 draft_heads: Optional[int] = None,
                 device: DeviceLike = None):
        self.config = config or RouterConfig.from_env()
        self.device = resolve_device(device)
        self._clock = clock
        n = int(self.config.replicas)
        if n < 1:
            raise MXNetError(f"replicas must be >= 1, got {n}")
        engine_config = engine_config or EngineConfig.from_env()
        if chaos is None:
            spec = chaos_mod.serve_from_env()
            chaos = {chaos_mod.chaos_replica(): spec} if spec else {}
        if isinstance(chaos, chaos_mod.ChaosSpec):
            chaos = {chaos_mod.chaos_replica(): chaos}
        off = chaos_mod.ChaosSpec({})
        # each replica gets its OWN drafter (draft weights are
        # per-replica operands — rolling_swap(target="draft") deploys
        # them replica-by-replica, independently of the target model)
        self._draft_params = draft_params
        self._draft_heads = draft_heads
        # the spawn recipe: scale_to() builds new replicas from the
        # same ingredients as construction (chaos looked up by the NEW
        # replica's index, so a gameday spec targeting replica 0 never
        # leaks into autoscaled replicas)
        self._params = params
        self._engine_config = engine_config
        self._chaos = dict(chaos)
        self._chaos_off = off
        self.replicas = [Replica(idx=i, engine=self._engine(
            params, engine_config, chaos.get(i, off))) for i in range(n)]
        self._hb = Heartbeat(self.config.heartbeat_timeout_ms, clock=clock)
        now = self._clock()
        for rep in self.replicas:
            self._hb.beat(rep.idx, now=now)
        # one reentrant lock serializes all control-plane mutation; see
        # the module docstring's threading model
        self._lock = threading.RLock()
        self._requests: Dict[int, RouterRequest] = {}  # shared: guarded_by=_lock
        self._seq = itertools.count()
        self._step_ms = 0.0           # EWMA router step wall (shed est.)
        self.recoveries_ms: List[float] = []
        # rolling window of wall inter-token gaps -> p99 EWMA gauge
        # (the autoscaler's optional latency signal)
        self._itl_window: deque = deque(maxlen=256)
        self._itl_p99_ewma = 0.0

    def _engine(self, params: Dict[str, Any], engine_config: EngineConfig,
                chaos: chaos_mod.ChaosSpec) -> Engine:
        return Engine(params, engine_config, device=self.device,
                      chaos=chaos, draft_params=self._draft_params,
                      draft_heads=self._draft_heads)

    # -- warmup ------------------------------------------------------------

    def warmup(self) -> List[List[Dict[str, Any]]]:
        """Resolve every replica's programs (:meth:`Engine.warmup`: one
        captured graph per bucket on the card; the kernel library is built
        once, by the first replica).  Returns each replica's infos, with
        their ``source``.  A hot swap copies weights into the captured
        storage, and failover or drain moves requests between engines
        that already hold their programs: none of them captures again."""
        return [rep.engine.warmup() for rep in self.replicas]

    # -- front door --------------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               slo_ms: Optional[float] = None,
               eos_id: Optional[int] = None,
               seed: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> int:
        """Place a request on the least-loaded healthy replica, or shed
        it (the request fails fast with reason ``"shed"``; ``result()``
        raises :class:`ServeError`).  Without an explicit ``seed`` the
        router id seeds the sampling stream — the router, not the
        engine, must own seeds or failover could not replay them."""
        with self._lock:
            rid = next(self._seq)
            rr = RouterRequest(
                rid=rid, prompt=[int(t) for t in prompt],
                max_new_tokens=int(max_new_tokens),
                temperature=float(temperature), top_k=int(top_k),
                slo_ms=slo_ms, eos_id=eos_id, deadline_ms=deadline_ms,
                seed=(int(seed) if seed is not None else rid),
                submit_t=self._clock(), submit_wall=time.monotonic())
            target = self._pick(rr.prompt)
            reason = self._shed_reason(rr, target)
            if reason is not None:
                rr.state = FAILED
                rr.finish_reason = "shed"
                self._requests[rid] = rr
                telemetry.counter("serve.shed").inc(reason=reason)
                telemetry.flight_recorder().record({
                    "kind": "serve.shed", "req": rid, "reason": reason,
                    "replica": None if target is None else target.idx})
                return rid
            # engine-side validation (empty/oversized prompt) propagates
            # before the request is registered — a rejected submit
            # leaves no ghost entry
            rr.engine_rid = target.engine.submit(
                rr.prompt, max_new_tokens=rr.max_new_tokens,
                temperature=rr.temperature, top_k=rr.top_k,
                slo_ms=rr.slo_ms, eos_id=rr.eos_id, seed=rr.seed,
                deadline_ms=rr.deadline_ms)
            rr.replica = target
            self._requests[rid] = rr
            return rid

    def cancel(self, rid: int) -> None:
        with self._lock:
            rr = self._rr(rid)
            if rr.done():
                return
            if (rr.replica is not None and rr.replica.state != DEAD
                    and rr.engine_rid is not None):
                rr.replica.engine.cancel(rr.engine_rid)
            else:
                rr.state = CANCELLED
                rr.finish_reason = "cancelled"

    def request(self, rid: int) -> RouterRequest:
        return self._rr(rid)

    def _rr(self, rid: int) -> RouterRequest:
        try:
            return self._requests[rid]
        except KeyError:
            raise MXNetError(f"unknown request id {rid}")

    # -- results -----------------------------------------------------------

    def result(self, rid: int) -> List[int]:
        """Drive the fleet until the request completes; raises
        :class:`ServeError` (with the finish reason) on failure."""
        rr = self._rr(rid)
        guard = 0
        limit = 10 * self.replicas[0].engine.config.max_seq_len + 100
        while not rr.done():
            self.step()
            guard += 1
            if guard > limit:
                raise MXNetError(f"request {rid} failed to converge")
        if rr.state == FAILED:
            raise ServeError(rr.finish_reason or "error", rid)
        return list(rr.tokens)

    def stream(self, rid: int):
        """Token generator; failover is invisible here except as
        latency.  A failed request raises :class:`ServeError` after any
        tokens already produced."""
        rr = self._rr(rid)
        cursor = 0
        while True:
            while cursor < len(rr.tokens):
                yield rr.tokens[cursor]
                cursor += 1
            if rr.done():
                if rr.state == FAILED:
                    raise ServeError(rr.finish_reason or "error", rid)
                return
            self.step()

    def run(self, max_steps: int = 100000) -> None:
        """Drive the fleet until every submitted request completes."""
        for _ in range(max_steps):
            if all(rr.done() for rr in self._requests.values()):
                return
            self.step()
        raise MXNetError(f"router still busy after {max_steps} steps")

    # -- the control loop --------------------------------------------------

    def step(self) -> None:
        """One control-plane iteration: step live replicas (containing
        crashes), check heartbeats, sync observed tokens, retire
        finished drains, publish gauges."""
        with self._lock:
            now = self._clock()
            t0 = time.perf_counter()
            for rep in self.replicas:
                if rep.state not in (HEALTHY, DRAINING):
                    continue
                eng = rep.engine
                if eng.sched.idle():
                    # legitimately idle: the call itself proves liveness
                    self._hb.beat(rep.idx, now=now)
                    continue
                try:
                    eng.step()
                except Exception as exc:  # noqa: BLE001 — contain death
                    self._declare_dead(rep, "crash", now, error=exc)
                    continue
                # progress-based: a hung step returns fine but never
                # advances `beat`, so this beat does not register
                self._hb.beat(rep.idx, progress=eng.beat, now=now)
            for rep in self.replicas:
                if (rep.state in (HEALTHY, DRAINING)
                        and self._hb.age_ms(rep.idx, now=now)
                        > self.config.heartbeat_timeout_ms):
                    self._declare_dead(rep, "heartbeat", now)
            self._sync(now)
            for rep in self.replicas:
                if rep.state == DRAINING and rep.engine.sched.idle():
                    rep.state = DRAINED
                    self._hb.forget(rep.idx)
            self._publish_gauges()
            ms = (time.perf_counter() - t0) * 1e3
            self._step_ms = (ms if self._step_ms == 0.0
                             else 0.8 * self._step_ms + 0.2 * ms)

    def _publish_gauges(self) -> None:
        """Fleet-level load gauges, refreshed EVERY router step — even
        when every engine is idle, shedding, dead, or parked.  Engines
        only publish their own (last-writer-wins) gauges when they
        step, so without this a saturated fleet that stopped admitting
        work would keep advertising its pre-shed load to the
        autoscaler."""
        live = [r for r in self.replicas
                if r.state in (HEALTHY, DRAINING)]
        telemetry.gauge("serve.queue_depth").set(
            sum(r.engine.sched.queue_depth for r in live))
        telemetry.gauge("serve.active_slots").set(
            sum(r.engine.sched.active for r in live))
        telemetry.gauge("serve.kv_blocks_used").set(
            sum(r.engine.alloc.num_used for r in live))
        telemetry.gauge("serve.kv_frac").set(
            max((r.kv_frac() for r in live), default=0.0))
        if self._itl_window:
            srt = sorted(self._itl_window)
            p99 = srt[min(len(srt) - 1, int(0.99 * len(srt)))]
            self._itl_p99_ewma = (
                p99 if self._itl_p99_ewma == 0.0
                else 0.9 * self._itl_p99_ewma + 0.1 * p99)
        telemetry.gauge("serve.itl_p99_ewma_ms").set(self._itl_p99_ewma)
        telemetry.gauge("serve.router.replicas_healthy").set(
            sum(1 for r in self.replicas if r.state == HEALTHY))

    def _sync(self, now: float) -> None:
        """Pull every in-flight request's tokens into the router's own
        buffer.  This runs every step BEFORE any future failover needs
        it: the router can only replay what it has observed — a dead
        replica's unsynced state is gone, exactly as it would be with
        process-backed replicas."""
        for rr in self._requests.values():
            if rr.done() or rr.replica is None or rr.engine_rid is None:
                continue
            if rr.replica.state == DEAD:
                continue
            ereq = rr.replica.engine.requests.get(rr.engine_rid)
            if ereq is None:
                continue
            fresh = ereq.tokens[len(rr.tokens):]
            if fresh:
                wall = time.monotonic()
                if rr.token_walls:
                    self._itl_window.append(
                        (wall - rr.token_walls[-1]) * 1e3)
                rr.tokens.extend(fresh)
                rr.token_walls.extend([wall] * len(fresh))
                if rr.recovering_since is not None:
                    ms = (now - rr.recovering_since) * 1e3
                    rr.recovering_since = None
                    self.recoveries_ms.append(ms)
                    telemetry.histogram(
                        "serve.router.failover_ms").observe(ms)
            if ereq.done():
                rr.state = ereq.state
                rr.finish_reason = ereq.finish_reason

    # -- death & failover --------------------------------------------------

    def _declare_dead(self, rep: Replica, cause: str, now: float,
                      error: Optional[BaseException] = None) -> None:
        rep.state = DEAD
        rep.death_cause = cause
        rep.death_error = None if error is None else type(error).__name__
        self._hb.forget(rep.idx)
        inflight = [rr for rr in self._requests.values()
                    if not rr.done() and rr.replica is rep]
        telemetry.counter("serve.router.deaths").inc(cause=cause)
        telemetry.dump_flight("serve-replica-death", extra={
            "replica": rep.idx, "cause": cause,
            "error": None if error is None else repr(error),
            "inflight": [rr.rid for rr in inflight]})
        for rr in inflight:
            self._failover(rr, now)

    def _failover(self, rr: RouterRequest, now: float) -> None:
        """Re-home one request onto a survivor, continuing its exact
        token stream (see module docstring)."""
        rr.failovers += 1
        if rr.recovering_since is None:
            rr.recovering_since = now
        rr.replica = None
        rr.engine_rid = None
        if len(rr.tokens) >= rr.max_new_tokens:
            # the final token was already observed; only the dead
            # replica's finish bookkeeping was lost
            rr.state = FINISHED
            rr.finish_reason = "length"
            return
        target = self._pick(rr.prompt + rr.tokens)
        if target is None or rr.failovers > self.config.max_failovers:
            self._fail(rr, "error")
            return
        with telemetry.span("serve.router.failover", req=rr.rid,
                            to=target.idx, tokens=len(rr.tokens)):
            rr.engine_rid = target.engine.adopt(
                rr.prompt, rr.tokens,
                max_new_tokens=rr.max_new_tokens,
                temperature=rr.temperature, top_k=rr.top_k,
                slo_ms=rr.slo_ms, eos_id=rr.eos_id, seed=rr.seed,
                deadline_ms=rr.deadline_ms, submit_t=rr.submit_t)
        rr.replica = target
        telemetry.counter("serve.router.failovers").inc()
        telemetry.flight_recorder().record({
            "kind": "serve.failover", "req": rr.rid, "to": target.idx,
            "tokens_so_far": len(rr.tokens)})

    def _fail(self, rr: RouterRequest, reason: str) -> None:
        rr.state = FAILED
        rr.finish_reason = reason

    # -- drain -------------------------------------------------------------

    def drain(self, idx: int) -> None:
        """Graceful drain: the replica takes no new work; its ACTIVE
        requests finish in place, its still-QUEUED ones migrate to
        survivors immediately (no point waiting behind a closing
        door)."""
        with self._lock:
            rep = self.replicas[idx]
            if rep.state != HEALTHY:
                raise MXNetError(
                    f"replica {idx} is {rep.state}; only a healthy "
                    "replica drains")
            rep.state = DRAINING
            telemetry.counter("serve.router.drains").inc()
            for rr in self._requests.values():
                if rr.done() or rr.replica is not rep:
                    continue
                ereq = rep.engine.requests.get(rr.engine_rid)
                if ereq is None or ereq.state != QUEUED:
                    continue
                # silent engine-side cancel: the router-level request
                # lives on and re-homes with its original seed and
                # submit time
                rep.engine.sched.cancel(ereq)
                rr.replica = None
                rr.engine_rid = None
                target = self._pick(rr.prompt + rr.tokens)
                if target is None:
                    self._fail(rr, "error")
                    continue
                rr.engine_rid = target.engine.adopt(
                    rr.prompt, rr.tokens,
                    max_new_tokens=rr.max_new_tokens,
                    temperature=rr.temperature, top_k=rr.top_k,
                    slo_ms=rr.slo_ms, eos_id=rr.eos_id, seed=rr.seed,
                    deadline_ms=rr.deadline_ms, submit_t=rr.submit_t)
                rr.replica = target

    def undrain(self, idx: int) -> None:
        """Reverse of :meth:`drain`: reactivate a DRAINING/DRAINED
        replica.  A parked replica keeps its live engine — KV pool and
        prefix cache intact — so reactivation is a state flip plus a
        heartbeat re-arm.  Dead replicas cannot undrain; their engine
        state is gone."""
        with self._lock:
            if not 0 <= idx < len(self.replicas):
                raise MXNetError(f"undrain: no replica {idx} "
                                 f"(fleet size {len(self.replicas)})")
            rep = self.replicas[idx]
            if rep.state not in (DRAINING, DRAINED):
                raise MXNetError(
                    f"replica {idx} is {rep.state}; only a draining or "
                    "drained replica undrains")
            rep.state = HEALTHY
            rep.death_cause = rep.death_error = None
            self._hb.beat(rep.idx, now=self._clock())
            telemetry.counter("serve.router.undrains").inc()

    # -- fleet sizing (the autoscaler's actuator) --------------------------

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas if r.state == HEALTHY)

    def scale_to(self, n: int, *, warm: bool = True) -> Dict[str, Any]:
        """Actuate fleet size toward ``n`` healthy replicas.

        Scale-UP reactivates parked (DRAINING/DRAINED) replicas first
        — their engines are warm — then spawn-warmup-attaches brand-new
        replicas: the engine is built and warmed *before* it joins the
        table, so ``_pick`` never routes to a cold replica (the kernel
        library is already built, so warmup builds nothing).  Scale-DOWN drains
        the least-loaded healthy replicas (their drains finish
        fastest; ties prefer the newest index, keeping the original
        fleet stable); they park as DRAINED via the normal step()
        retirement and are first back on the next ramp.  Scale-down is
        asynchronous: the healthy count drops immediately (``_pick``
        skips DRAINING), the engines park once in-flight work ends."""
        n = int(n)
        if n < 1:
            raise MXNetError(f"scale_to: target must be >= 1, got {n}")
        with self._lock:
            healthy = [r for r in self.replicas if r.state == HEALTHY]
            out: Dict[str, Any] = {
                "target": n, "healthy_before": len(healthy),
                "reactivated": [], "spawned": [], "draining": []}
            deficit = n - len(healthy)
            if deficit > 0:
                parked = [r for r in self.replicas
                          if r.state in (DRAINING, DRAINED)]
                for rep in parked[:deficit]:
                    self.undrain(rep.idx)
                    out["reactivated"].append(rep.idx)
                for _ in range(deficit - len(out["reactivated"])):
                    out["spawned"].append(self._spawn(warm=warm).idx)
            elif deficit < 0:
                victims = sorted(
                    healthy, key=lambda r: (r.load, -r.idx))[:-deficit]
                for rep in victims:
                    self.drain(rep.idx)
                    out["draining"].append(rep.idx)
            if (out["reactivated"] or out["spawned"]
                    or out["draining"]):
                telemetry.flight_recorder().record({
                    "kind": "serve.scale", "target": n,
                    "reactivated": out["reactivated"],
                    "spawned": out["spawned"],
                    "draining": out["draining"]})
            return out

    def _spawn(self, warm: bool = True) -> Replica:
        """Build, warm, and attach one new replica (callers hold
        ``_lock``)."""
        idx = len(self.replicas)
        eng = self._engine(self._params, self._engine_config,
                           self._chaos.get(idx, self._chaos_off))
        if warm:
            eng.warmup()
        rep = Replica(idx=idx, engine=eng)
        self.replicas.append(rep)
        self._hb.beat(idx, now=self._clock())
        telemetry.counter("serve.router.spawns").inc()
        return rep

    # -- rolling weight swap -----------------------------------------------

    def rolling_swap(self, params_or_source: Any, *,
                     engine_config: Optional[EngineConfig] = None,
                     allow_rebuild: Optional[bool] = None,
                     epoch: Optional[int] = None,
                     max_steps: int = 100000,
                     target: str = "model") -> Dict[str, Any]:
        """Deploy new weights across the fleet with zero downtime:
        replica-by-replica, each behind a
        graceful drain, so **no in-flight stream ever sees a
        mid-request weight change** — active requests finish in place
        under the weights they started with, queued ones migrate to
        not-yet-swapped survivors (``Engine.adopt`` re-prefill, the
        standard drain machinery), and the rest of the fleet keeps
        serving while one replica swaps.

        ``params_or_source`` is a parameter dict or a checkpoint source
        for :func:`~mxnet_tpu_torch.predictor.load_weights`.  The compat
        predicate (:mod:`mxnet_tpu_torch.online.compat`) is evaluated
        up front: a **compatible** signature hot-swaps each engine's
        weights in place (``Engine.swap_weights``: KV pools survive);
        an **incompatible** one rebuilds each replica's
        engine from scratch (its KV entries are invalidated
        wholesale), gated by ``allow_rebuild`` (default: the
        ``MXNET_TPU_ONLINE_REBUILD`` env knob, on).  With rebuild
        forbidden an incompatible publish raises *before* any replica
        is touched — the fleet keeps serving the old weights.

        Returns a summary: per-replica ``swap_ms`` (drain wait +
        install), the mode (``hot`` / ``rebuild``), and the compat
        report.  ``online.swap_ms`` records each replica's latency;
        rebuilds count in ``online.rebuilds``.  With a single replica
        there is no survivor to migrate queued work to — queued
        requests fail over to nothing and error; run >= 2 replicas
        for actual zero-downtime deploys.
        """
        if target not in ("model", "draft"):
            raise MXNetError(f"rolling_swap target {target!r}: expected "
                             "'model' or 'draft'")
        if allow_rebuild is None:
            allow_rebuild = bool(_env_int("MXNET_TPU_ONLINE_REBUILD", 1))
        if isinstance(params_or_source, str):
            from ..predictor import load_weights
            _, params_or_source, _, _ = load_weights(params_or_source,
                                                     epoch)
        if target == "draft":
            return self._rolling_swap_draft(params_or_source, max_steps)
        new_sig = signature_of_params(params_or_source)
        targets = [rep for rep in self.replicas if rep.state == HEALTHY]
        if not targets:
            raise MXNetError("rolling_swap: no healthy replica to swap")
        report = check_compat(
            signature_of_params(targets[0].engine._params), new_sig)
        mode = "hot" if report.compatible else "rebuild"
        if mode == "rebuild" and not allow_rebuild:
            raise MXNetError(
                "rolling_swap: incompatible weights and rebuild is "
                f"disabled (MXNET_TPU_ONLINE_REBUILD=0) — "
                f"{report.summary()}; fleet unchanged")
        swap_ms: List[float] = []
        with telemetry.span("online.rolling_swap", mode=mode,
                            replicas=len(targets)):
            for rep in targets:
                t0 = time.perf_counter()
                self.drain(rep.idx)
                guard = 0
                while rep.state == DRAINING:
                    self.step()
                    guard += 1
                    if guard > max_steps:
                        raise MXNetError(
                            f"rolling_swap: replica {rep.idx} still "
                            f"draining after {max_steps} steps")
                # install under the lock: a concurrent step()/submit()
                # must never observe a half-swapped replica (the drain
                # wait above deliberately does NOT hold it, so client
                # threads keep stepping the rest of the fleet)
                with self._lock:
                    if mode == "hot":
                        rep.engine.swap_weights(params_or_source)
                    else:
                        old = rep.engine
                        rep.engine = self._engine(
                            params_or_source, engine_config or old.config,
                            old.chaos or chaos_mod.ChaosSpec({}))
                        rep.engine.warmup()
                        telemetry.counter("online.rebuilds").inc()
                    rep.state = HEALTHY
                    rep.death_cause = rep.death_error = None
                    self._hb.beat(rep.idx, now=self._clock())
                ms = (time.perf_counter() - t0) * 1e3
                swap_ms.append(ms)
                telemetry.histogram("online.swap_ms").observe(ms)
                telemetry.flight_recorder().record({
                    "kind": "online.swap", "replica": rep.idx,
                    "mode": mode, "ms": round(ms, 3)})
        return {"mode": mode, "replicas": [rep.idx for rep in targets],
                "swap_ms": swap_ms, "report": report.to_dict()}

    def _rolling_swap_draft(self, params: Dict[str, Any],
                            max_steps: int) -> Dict[str, Any]:
        """Deploy new DRAFT-model weights across the fleet —
        ``rolling_swap(..., target="draft")``.  No drain is needed: the
        draft model only *proposes* tokens, and the verify step's
        acceptance rule owns the output, so a mid-stream draft change
        can move acceptance rates but never the emitted stream (greedy)
        or its distribution (temperature).  Each replica installs under
        the lock (``Engine.swap_draft_weights``, compat-checked); an
        incompatible signature raises at the first replica, before any
        is touched."""
        targets = [rep for rep in self.replicas if rep.state == HEALTHY]
        if not targets:
            raise MXNetError("rolling_swap: no healthy replica to swap")
        for rep in targets:
            spec = rep.engine.spec
            if spec is None or spec.kind != "model":
                raise MXNetError(
                    f"rolling_swap(target='draft'): replica {rep.idx} "
                    "has no model drafter (speculate off or "
                    "spec_draft='ngram')")
        swap_ms: List[float] = []
        report: Dict[str, Any] = {}
        with telemetry.span("online.rolling_swap", mode="draft",
                            replicas=len(targets)):
            for rep in targets:
                t0 = time.perf_counter()
                with self._lock:
                    report = rep.engine.swap_draft_weights(params)
                ms = (time.perf_counter() - t0) * 1e3
                swap_ms.append(ms)
                telemetry.histogram("online.swap_ms").observe(ms)
                telemetry.flight_recorder().record({
                    "kind": "online.swap", "replica": rep.idx,
                    "mode": "draft", "ms": round(ms, 3)})
        self._draft_params = params   # future rebuilds use the new drafts
        return {"mode": "draft",
                "replicas": [rep.idx for rep in targets],
                "swap_ms": swap_ms, "report": report}

    # -- placement & shedding ----------------------------------------------

    def _pick(self, tokens: Optional[Sequence[int]] = None
              ) -> Optional[Replica]:
        """Placement: prefix-affinity first, then least-loaded (ties:
        lowest index — deterministic placement, pinned by the failover
        parity tests).  When ``tokens`` is given and replicas run the
        prefix cache, the replica whose cache holds the LONGEST
        matching prefix of them wins regardless of load — re-prefilling
        a long prefix elsewhere costs more than queueing behind the
        warm replica; with no cache (or no hit anywhere) the key
        degrades to the classic least-loaded rule."""
        best = None
        for rep in self.replicas:
            if rep.state != HEALTHY:
                continue
            eng = rep.engine
            if eng.sched.queue_depth >= eng.config.max_queue:
                continue
            hit = eng.prefix_probe(tokens) if tokens is not None else 0
            key = (-hit, rep.load, rep.idx)
            if best is None or key < best[0]:
                best = (key, rep)
        return None if best is None else best[1]

    def _shed_reason(self, rr: RouterRequest,
                     target: Optional[Replica]) -> Optional[str]:
        """Why this submit should be shed, or ``None`` to accept.
        Evaluated against the BEST candidate: if the least-loaded
        replica is past threshold, the fleet is saturated."""
        cfg = self.config
        if target is None:
            return "unavailable"
        if (cfg.shed_queue_depth
                and target.engine.sched.queue_depth >= cfg.shed_queue_depth):
            return "queue"
        if cfg.shed_kv_frac < 1.0 and target.kv_frac() >= cfg.shed_kv_frac:
            return "kv"
        if rr.slo_ms is not None and self._step_ms > 0.0:
            est_wait = target.engine.sched.queue_depth * self._step_ms
            if est_wait > rr.slo_ms:
                return "slo"
        return None

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> Dict[str, Any]:
        return {
            "replicas": [{
                "idx": rep.idx, "state": rep.state,
                "death_cause": rep.death_cause,
                "death_error": rep.death_error,
                "active": rep.engine.sched.active,
                "queued": rep.engine.sched.queue_depth,
                "blocks_used": rep.engine.alloc.num_used,
                "beat": rep.engine.beat,
            } for rep in self.replicas],
            "requests": len(self._requests),
            "live": sum(1 for rr in self._requests.values()
                        if not rr.done()),
            "failovers": sum(rr.failovers
                             for rr in self._requests.values()),
            "recoveries_ms": list(self.recoveries_ms),
            "step_ms_ewma": self._step_ms,
            "itl_p99_ewma_ms": self._itl_p99_ewma,
        }
