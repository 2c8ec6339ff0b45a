"""Seeded, replay-exact production traffic simulation.

Counterpart of ``mxnet_tpu/serve/traffic.py`` (host code and numpy): the
same configuration gives the same trace, byte for byte, in both packages.
A fixed batch of requests is not what production sends; this module
models what many users actually send at a fleet, in four layers, all
derived from one seed so the same config replays **byte-identically**:

* **Arrival process** — a non-homogeneous Poisson process, thinned
  against a diurnal rate curve (``base_rate * (1 + A sin(2pi t/P +
  phase))``) and **correlated burst episodes** (a second Poisson
  process of episode starts; while an episode is open the instant
  rate is multiplied).  Thinning keeps the draw sequence fixed, so
  the schedule is a pure function of the seed.
* **Session templates** — a small set of shared system prompts (the
  workload the prefix cache exists for); each arriving
  session picks one and opens a multi-turn conversation.
* **Turns** — per turn: user tokens with **power-law** length, a
  power-law output budget, and a log-uniform **think time** separating
  the next turn from this turn's *completion* (not its arrival —
  think time is a property of the user, so follow-up arrival times are
  only known at replay time).
* **Per-request seeds** — folded from ``(trace seed, session, turn)``,
  never from arrival order, so sampling streams survive any admission
  / placement / failover reshuffle — the router's failover contract
  extended to whole traces.

Everything runs in **virtual time**: :class:`VirtualClock` is
injectable into the router, the autoscaler, and :class:`LoadGen` (the
same pattern as the heartbeat clock), so the canonical 10-minute
diurnal trace replays in far less wall time.
Latency *measurements* (TTFT / inter-token gaps) intentionally stay on
the wall clock — queueing and compute are real even when arrivals are
simulated; only *decisions* (arrivals, think time, autoscale
cooldowns, heartbeats) run on virtual time, which is what makes the
replay deterministic.
"""
from __future__ import annotations

import heapq
import json
import math
import time
import zlib
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import telemetry
from ..base import MXNetError
from .engine import _env_int
from .scheduler import FINISHED

__all__ = ["TraceConfig", "TurnSpec", "Session", "Trace", "VirtualClock",
           "LoadGen", "generate_trace", "request_seed"]


# ----------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class TraceConfig:
    """One knob set = one reproducible workload.  Rates and durations
    are in *virtual* seconds."""
    seed: int = 0
    duration_s: float = 600.0          # the canonical 10-minute trace
    # arrival process
    base_rate: float = 0.1             # mean session arrivals / s
    diurnal_amplitude: float = 0.8     # 0 = flat Poisson, <= 1
    diurnal_period_s: float = 600.0    # one compressed "day"
    diurnal_phase: float = -0.5 * math.pi  # start at the trough: the
    #                                      ramp happens mid-trace,
    #                                      where gamedays inject chaos
    # correlated bursts (episodes of multiplied rate)
    burst_hazard_per_s: float = 1.0 / 200.0  # episode starts / s
    burst_duration_s: float = 30.0
    burst_multiplier: float = 3.0
    # session templates (shared system prompts)
    n_templates: int = 4
    sys_prompt_min: int = 8
    sys_prompt_max: int = 24
    # multi-turn structure
    max_turns: int = 4
    turn_continue_p: float = 0.55      # P(another turn | one more turn)
    think_min_s: float = 2.0
    think_max_s: float = 30.0
    # power-law lengths (discrete bounded Pareto, alpha = tail index)
    prompt_alpha: float = 1.8
    prompt_min: int = 4
    prompt_max: int = 48
    output_alpha: float = 1.6
    output_min: int = 4
    output_max: int = 24
    # decode params + context budget
    vocab: int = 512
    temperature: float = 0.0           # greedy: byte-identity testable
    top_k: int = 0
    context_budget: int = 120          # cap on sys + sum(user + output)

    @classmethod
    def from_env(cls, **overrides) -> "TraceConfig":
        """`MXNET_TPU_SERVE_TRACE_SEED` seeds the canonical trace;
        explicit kwargs win."""
        env = dict(seed=_env_int("MXNET_TPU_SERVE_TRACE_SEED", 0))
        env.update(overrides)
        return cls(**env)


@dataclass(frozen=True)
class TurnSpec:
    """One user turn, fully determined at generation time except for
    its arrival: turn k+1 arrives ``think_s`` after turn k completes."""
    user_tokens: Tuple[int, ...]
    max_new_tokens: int
    think_s: float                     # delay after the PREVIOUS turn
    seed: int                          # per-request sampling seed


@dataclass(frozen=True)
class Session:
    sid: int
    t0: float                          # virtual arrival of turn 0
    template: int
    turns: Tuple[TurnSpec, ...]


@dataclass(frozen=True)
class Trace:
    config: TraceConfig
    templates: Tuple[Tuple[int, ...], ...]
    sessions: Tuple[Session, ...]
    burst_episodes: Tuple[Tuple[float, float], ...]

    @property
    def n_requests(self) -> int:
        return sum(len(s.turns) for s in self.sessions)

    def arrival_schedule(self) -> List[Tuple[float, int]]:
        """First-turn arrivals ``[(t, sid), ...]`` in time order (the
        part of the schedule that is a pure function of the seed)."""
        return [(s.t0, s.sid) for s in self.sessions]

    def to_jsonl(self) -> str:
        """Canonical serialization — the byte-identity surface for the
        same-seed replay contract, and the JAX package's
        `tools/loadgen.py --out` format."""
        lines = [json.dumps({"kind": "trace_config",
                             **asdict(self.config)}, sort_keys=True)]
        for i, tpl in enumerate(self.templates):
            lines.append(json.dumps({"kind": "template", "id": i,
                                     "tokens": list(tpl)},
                                    sort_keys=True))
        for a, b in self.burst_episodes:
            lines.append(json.dumps({"kind": "burst",
                                     "t0": round(a, 6),
                                     "t1": round(b, 6)}, sort_keys=True))
        for s in self.sessions:
            lines.append(json.dumps({
                "kind": "session", "sid": s.sid, "t0": round(s.t0, 6),
                "template": s.template,
                "turns": [{"user": list(t.user_tokens),
                           "max_new": t.max_new_tokens,
                           "think_s": round(t.think_s, 6),
                           "seed": t.seed} for t in s.turns],
            }, sort_keys=True))
        return "\n".join(lines) + "\n"

    def stats(self) -> Dict[str, Any]:
        lens = [len(t.user_tokens) for s in self.sessions
                for t in s.turns]
        outs = [t.max_new_tokens for s in self.sessions for t in s.turns]
        return {
            "sessions": len(self.sessions),
            "requests": self.n_requests,
            "duration_s": self.config.duration_s,
            "burst_episodes": len(self.burst_episodes),
            "mean_turns": (self.n_requests / max(1, len(self.sessions))),
            "user_len_mean": float(np.mean(lens)) if lens else 0.0,
            "user_len_max": max(lens) if lens else 0,
            "out_tokens_mean": float(np.mean(outs)) if outs else 0.0,
        }


# ----------------------------------------------------------------------
# Generation
# ----------------------------------------------------------------------

def request_seed(trace_seed: int, sid: int, turn: int) -> int:
    """Per-request sampling seed folded from identity, not from
    arrival order: reshuffles (admission, placement, failover) can
    never change a request's stream."""
    return zlib.crc32(
        ("%d:%d:%d" % (trace_seed, sid, turn)).encode()) & 0x7FFFFFFF


def _power_law(rng: np.random.RandomState, alpha: float,
               lo: int, hi: int) -> int:
    """Discrete bounded Pareto draw via inverse transform."""
    u = float(rng.uniform(1e-9, 1.0))
    return int(min(hi, max(lo, math.floor(lo * u ** (-1.0 / alpha)))))


def _rate_at(cfg: TraceConfig, t: float,
             episodes: List[Tuple[float, float]]) -> float:
    lam = cfg.base_rate * (1.0 + cfg.diurnal_amplitude * math.sin(
        2.0 * math.pi * t / cfg.diurnal_period_s + cfg.diurnal_phase))
    lam = max(0.0, lam)
    for a, b in episodes:
        if a <= t < b:
            lam *= cfg.burst_multiplier
            break
    return lam


def generate_trace(config: Optional[TraceConfig] = None, **over) -> Trace:
    """Build the full trace from one seed.  Every draw comes from one
    ``RandomState`` in a fixed order, so the result — schedule, token
    contents, per-request seeds — is byte-identical across runs
    (``Trace.to_jsonl()`` is the pinned surface)."""
    cfg = config or TraceConfig(**over)
    if not 0.0 <= cfg.diurnal_amplitude <= 1.0:
        raise MXNetError("diurnal_amplitude must be in [0, 1], got %r"
                         % (cfg.diurnal_amplitude,))
    rng = np.random.RandomState(cfg.seed)

    # 1) burst episodes: Poisson starts, fixed duration
    episodes: List[Tuple[float, float]] = []
    t = 0.0
    while cfg.burst_hazard_per_s > 0.0:
        t += float(rng.exponential(1.0 / cfg.burst_hazard_per_s))
        if t >= cfg.duration_s:
            break
        episodes.append((t, min(cfg.duration_s, t + cfg.burst_duration_s)))

    # 2) session arrivals: thinned non-homogeneous Poisson.  The
    # homogeneous candidate stream at lam_max is generated in full and
    # thinned per-candidate, so the draw order never depends on the
    # accept/reject outcome.
    lam_max = (cfg.base_rate * (1.0 + cfg.diurnal_amplitude)
               * max(1.0, cfg.burst_multiplier))
    arrivals: List[float] = []
    t = 0.0
    while lam_max > 0.0:
        t += float(rng.exponential(1.0 / lam_max))
        if t >= cfg.duration_s:
            break
        if float(rng.uniform()) * lam_max <= _rate_at(cfg, t, episodes):
            arrivals.append(t)

    # 3) shared system-prompt templates
    templates = tuple(
        tuple(int(x) for x in rng.randint(
            1, cfg.vocab, int(rng.randint(cfg.sys_prompt_min,
                                          cfg.sys_prompt_max + 1))))
        for _ in range(cfg.n_templates))

    # 4) sessions and turns
    sessions: List[Session] = []
    for sid, t0 in enumerate(arrivals):
        template = int(rng.randint(cfg.n_templates))
        budget = cfg.context_budget - len(templates[template])
        turns: List[TurnSpec] = []
        for k in range(cfg.max_turns):
            plen = _power_law(rng, cfg.prompt_alpha,
                              cfg.prompt_min, cfg.prompt_max)
            out = _power_law(rng, cfg.output_alpha,
                             cfg.output_min, cfg.output_max)
            think = float(math.exp(rng.uniform(
                math.log(cfg.think_min_s), math.log(cfg.think_max_s))))
            user = tuple(int(x) for x in rng.randint(1, cfg.vocab, plen))
            cont = float(rng.uniform())      # drawn even for the last
            #                                  turn: fixed draw order
            if k > 0 and plen + out > budget:
                break                        # context budget exhausted
            if k == 0:
                plen = min(plen, max(1, budget - out))
                user = user[:plen]
            budget -= plen + out
            turns.append(TurnSpec(user_tokens=user, max_new_tokens=out,
                                  think_s=think,
                                  seed=request_seed(cfg.seed, sid, k)))
            if cont >= cfg.turn_continue_p:
                break
        sessions.append(Session(sid=sid, t0=float(t0), template=template,
                                turns=tuple(turns)))
    return Trace(config=cfg, templates=templates,
                 sessions=tuple(sessions),
                 burst_episodes=tuple(episodes))


# ----------------------------------------------------------------------
# Virtual time
# ----------------------------------------------------------------------

class VirtualClock:
    """Monotonic simulated clock, callable like ``time.monotonic`` so
    it plugs straight into ``Router(clock=...)``, ``Heartbeat`` and
    :class:`~mxnet_tpu_torch.serve.autoscale.Autoscaler`."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise MXNetError("VirtualClock.advance: dt must be >= 0, "
                             "got %r" % (dt,))
        self._t += float(dt)
        return self._t

    def advance_to(self, t: float) -> float:
        self._t = max(self._t, float(t))
        return self._t


# ----------------------------------------------------------------------
# Replay
# ----------------------------------------------------------------------

@dataclass
class TurnRecord:
    """What the load generator observed for one request."""
    sid: int
    turn: int
    rid: int
    t_submit: float                    # virtual
    finish_reason: Optional[str] = None
    tokens: List[int] = field(default_factory=list)
    ttft_ms: Optional[float] = None    # wall
    itl_ms: List[float] = field(default_factory=list)  # wall
    failovers: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {"sid": self.sid, "turn": self.turn, "rid": self.rid,
                "t_submit": round(self.t_submit, 6),
                "finish_reason": self.finish_reason,
                "tokens": list(self.tokens),
                "ttft_ms": self.ttft_ms,
                "itl_ms": list(self.itl_ms),
                "failovers": self.failovers}


class LoadGen:
    """Replay a :class:`Trace` against a
    :class:`~mxnet_tpu_torch.serve.router.Router` in virtual time.

    The loop is deterministic by construction: arrivals come from the
    trace, the virtual clock advances a fixed ``step_virtual_s`` per
    router step, follow-up turns are scheduled at (virtual completion
    + think time), and a shed turn ends its session (the remaining
    turns are abandoned — a user whose request was refused does not
    keep typing).  Same trace + same fleet config => the same submit
    order, the same shed set, the same scale events, and — via
    position-keyed sampling — byte-identical token streams.

    Turn k+1's prompt is the session context so far (system prompt +
    every earlier user turn + every earlier *generated* reply) plus
    the new user tokens, clamped to the engine's prompt capacity from
    the left like a context window — the grow-the-chat pattern the
    prefix cache and the router's prefix-affinity ``_pick``
    are built for.
    """

    def __init__(self, router, trace: Trace, clock: VirtualClock, *,
                 step_virtual_s: float = 0.004,
                 autoscaler=None,
                 max_router_steps: int = 1_000_000):
        self._router = router
        self._trace = trace
        self._clock = clock
        self._step_s = float(step_virtual_s)
        self._asc = autoscaler
        self._max_steps = int(max_router_steps)

    # -- submit one turn ---------------------------------------------------

    def _submit(self, sid: int, k: int, ctx: Dict[int, List[int]],
                live: Dict[int, Tuple[int, int]],
                records: List[TurnRecord]) -> None:
        trace, router = self._trace, self._router
        sess = trace.sessions[sid]
        spec = sess.turns[k]
        cfg = router.replicas[0].engine.config
        base = ctx.get(sid)
        if base is None:
            base = list(trace.templates[sess.template])
        prompt = base + list(spec.user_tokens)
        if len(prompt) > cfg.max_prompt_len:
            prompt = prompt[-cfg.max_prompt_len:]   # context window
        mnt = max(1, min(spec.max_new_tokens,
                         cfg.max_seq_len - len(prompt) - 1))
        rid = router.submit(prompt, max_new_tokens=mnt,
                            temperature=trace.config.temperature,
                            top_k=trace.config.top_k, seed=spec.seed)
        telemetry.counter("loadgen.submitted").inc()
        rec = TurnRecord(sid=sid, turn=k, rid=rid,
                         t_submit=self._clock.now())
        records.append(rec)
        rr = router.request(rid)
        if rr.done():                   # shed at the front door
            rec.finish_reason = rr.finish_reason
            telemetry.counter("loadgen.shed").inc()
            return
        ctx[sid] = prompt               # context the reply extends
        live[rid] = (sid, k)

    # -- the replay loop ---------------------------------------------------

    def run(self) -> Dict[str, Any]:
        trace, router, clock = self._trace, self._router, self._clock
        heap: List[Tuple[float, int, int, int]] = []   # (t, ord, sid, k)
        order = 0
        for sess in trace.sessions:
            if sess.turns:
                heapq.heappush(heap, (sess.t0, order, sess.sid, 0))
                order += 1
        ctx: Dict[int, List[int]] = {}
        live: Dict[int, Tuple[int, int]] = {}
        records: List[TurnRecord] = []
        by_rid: Dict[int, TurnRecord] = {}
        steps = 0
        wall0 = time.perf_counter()
        while heap or live:
            now = clock.now()
            while heap and heap[0][0] <= now + 1e-12:
                _, _, sid, k = heapq.heappop(heap)
                n_before = len(records)
                self._submit(sid, k, ctx, live, records)
                by_rid[records[n_before].rid] = records[n_before]
            if self._asc is not None:
                self._asc.poll()
            if live:
                router.step()
                steps += 1
                if steps > self._max_steps:
                    raise MXNetError(
                        "loadgen: trace did not complete within %d "
                        "router steps" % self._max_steps)
                clock.advance(self._step_s)
            elif heap:
                clock.advance_to(heap[0][0])
                continue
            telemetry.gauge("loadgen.inflight").set(len(live))
            # harvest completions; schedule follow-up turns
            done_now = [rid for rid in live
                        if router.request(rid).done()]
            for rid in done_now:
                sid, k = live.pop(rid)
                rr = router.request(rid)
                rec = by_rid[rid]
                rec.finish_reason = rr.finish_reason or rr.state
                rec.tokens = list(rr.tokens)
                rec.failovers = rr.failovers
                walls = getattr(rr, "token_walls", [])
                if walls:
                    rec.ttft_ms = (walls[0] - rr.submit_wall) * 1e3
                    rec.itl_ms = [(b - a) * 1e3 for a, b in
                                  zip(walls, walls[1:])]
                if rr.state == FINISHED:
                    telemetry.counter("loadgen.completed").inc()
                    sess = trace.sessions[sid]
                    ctx[sid] = ctx[sid] + rec.tokens
                    if k + 1 < len(sess.turns):
                        t_next = clock.now() + sess.turns[k + 1].think_s
                        heapq.heappush(heap, (t_next, order, sid, k + 1))
                        order += 1
                else:
                    telemetry.counter("loadgen.aborted").inc()
        wall_s = time.perf_counter() - wall0
        return self._summarize(records, steps, wall_s)

    def _summarize(self, records: List[TurnRecord], steps: int,
                   wall_s: float) -> Dict[str, Any]:
        completed = [r for r in records if r.finish_reason
                     in ("length", "eos")]
        shed = [r for r in records if r.finish_reason == "shed"]
        ttft = sorted(r.ttft_ms for r in completed
                      if r.ttft_ms is not None)
        itl = sorted(g for r in completed for g in r.itl_ms)

        def pct(xs: List[float], q: float) -> Optional[float]:
            if not xs:
                return None
            return xs[min(len(xs) - 1, int(q * len(xs)))]

        toks = sum(len(r.tokens) for r in completed)
        return {
            "requests": len(records),
            "completed": len(completed),
            "shed": len(shed),
            "failed": len(records) - len(completed) - len(shed),
            "shed_rate": len(shed) / max(1, len(records)),
            "failovers": sum(r.failovers for r in records),
            "tokens_total": toks,
            "tok_per_s": toks / max(1e-9, wall_s),
            "router_steps": steps,
            "wall_s": wall_s,
            "virtual_s": self._clock.now(),
            "p50_ttft_ms": pct(ttft, 0.50),
            "p99_ttft_ms": pct(ttft, 0.99),
            "p50_itl_ms": pct(itl, 0.50),
            "p99_itl_ms": pct(itl, 0.99),
            "streams": {r.rid: list(r.tokens) for r in completed},
            "stream_keys": {(r.sid, r.turn): list(r.tokens)
                            for r in completed},
            "records": [r.to_dict() for r in records],
        }
