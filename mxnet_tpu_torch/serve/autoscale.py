"""Closed-loop fleet sizing.

Counterpart of ``mxnet_tpu/serve/autoscale.py`` (host code).  The
router publishes queue-depth / KV-pressure / latency gauges to the
telemetry plane every step; an :class:`Autoscaler` polls those gauges
and actuates replica count through
:meth:`~mxnet_tpu_torch.serve.router.Router.scale_to` — spawn-
warmup-attach on the way up (parked DRAINED replicas reactivate first:
warm KV pools), drain-then-detach on the way down.

**Hysteresis**, because a ramp that flaps is worse than one that lags:

* separated **high/low watermarks** — scale-up pressure and
  scale-down slack are different thresholds with a dead band between
  them, so a signal hovering at one watermark cannot trigger both;
* **consecutive-breach polls** (``breach_polls``) — a single spiky
  sample never scales;
* **cooldowns** after each actuation, separate for up (short — under-
  capacity sheds traffic) and down (long — spare capacity is cheap);
* **min/max clamps**, with a floor-repair path: if deaths drop the
  fleet below ``min_replicas`` the autoscaler restores the floor
  immediately, bypassing streaks and cooldowns — that is healing, not
  scaling.

The clock is injectable (the heartbeat pattern) so policy
tests and virtual-time gamedays advance time without sleeping; the
poller reads only ``telemetry.snapshot_flat()`` plus the router's
``healthy_count()``/``scale_to()`` surface, so policy unit tests run
against a fake router with hand-set gauges.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .. import telemetry
from ..base import MXNetError
from .engine import _env_float, _env_int

__all__ = ["AutoscaleConfig", "Autoscaler", "autoscaler_from_env"]


@dataclass(frozen=True)
class AutoscaleConfig:
    """Policy knobs (``MXNET_TPU_SERVE_AUTOSCALE_*``).  Queue watermarks are
    per-healthy-replica queue depth; KV watermarks are the fleet's max
    used-fraction; latency watermarks (optional) gate on the router's
    ``serve.itl_p99_ewma_ms`` gauge — wall-clock based, so leave them
    ``None`` for replay-exact virtual-time traces."""
    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 5.0            # poll cadence (router clock)
    high_queue: float = 8.0
    low_queue: float = 1.0
    high_kv_frac: float = 0.85
    low_kv_frac: float = 0.5
    high_itl_ms: Optional[float] = None
    low_itl_ms: Optional[float] = None
    breach_polls: int = 2              # consecutive polls before acting
    cooldown_up_s: float = 15.0
    cooldown_down_s: float = 30.0
    step: int = 1                      # replicas per actuation

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise MXNetError(
                "autoscale: need 1 <= min_replicas <= max_replicas, got "
                f"[{self.min_replicas}, {self.max_replicas}]")
        if self.low_queue >= self.high_queue:
            raise MXNetError(
                "autoscale: low_queue must sit below high_queue "
                f"({self.low_queue} >= {self.high_queue}) — the dead "
                "band between them is the anti-flap margin")
        if self.low_kv_frac >= self.high_kv_frac:
            raise MXNetError(
                "autoscale: low_kv_frac must sit below high_kv_frac "
                f"({self.low_kv_frac} >= {self.high_kv_frac})")

    @classmethod
    def from_env(cls, **overrides) -> "AutoscaleConfig":
        env = dict(
            min_replicas=_env_int("MXNET_TPU_SERVE_AUTOSCALE_MIN", 1),
            max_replicas=_env_int("MXNET_TPU_SERVE_AUTOSCALE_MAX", 4),
            high_queue=_env_float(
                "MXNET_TPU_SERVE_AUTOSCALE_HIGH_QUEUE", 8.0),
            low_queue=_env_float(
                "MXNET_TPU_SERVE_AUTOSCALE_LOW_QUEUE", 1.0),
            high_kv_frac=_env_float(
                "MXNET_TPU_SERVE_AUTOSCALE_HIGH_KV", 0.85),
            low_kv_frac=_env_float(
                "MXNET_TPU_SERVE_AUTOSCALE_LOW_KV", 0.5),
            cooldown_up_s=_env_float(
                "MXNET_TPU_SERVE_AUTOSCALE_COOLDOWN_UP_S", 15.0),
            cooldown_down_s=_env_float(
                "MXNET_TPU_SERVE_AUTOSCALE_COOLDOWN_DOWN_S", 30.0),
        )
        env.update(overrides)
        return cls(**env)


class Autoscaler:
    """Poll gauges, decide, actuate.  Drive it by calling
    :meth:`poll` from the serving loop (``LoadGen`` does this once per
    router step); polls inside ``interval_s`` of the previous one are
    free no-ops."""

    def __init__(self, router, config: Optional[AutoscaleConfig] = None,
                 *, clock=None):
        self.router = router
        self.config = config or AutoscaleConfig.from_env()
        self._clock = clock if clock is not None else getattr(
            router, "_clock", time.monotonic)
        self._last_poll: Optional[float] = None
        self._last_scale: Optional[float] = None
        self._up_streak = 0
        self._down_streak = 0
        self.events: List[Dict[str, Any]] = []

    # -- signals -----------------------------------------------------------

    def signals(self) -> Dict[str, float]:
        """Current load signals, read from the telemetry plane (the
        router refreshes these every step)."""
        snap = telemetry.snapshot_flat()
        healthy = self.router.healthy_count()
        queue = float(snap.get("serve.queue_depth", 0.0))
        return {
            "healthy": float(healthy),
            "queue_depth": queue,
            "queue_per_replica": queue / max(1, healthy),
            "kv_frac": float(snap.get("serve.kv_frac", 0.0)),
            "itl_p99_ewma_ms": float(
                snap.get("serve.itl_p99_ewma_ms", 0.0)),
        }

    # -- the loop ----------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """One control iteration.  Returns the scale event (also kept
        in ``self.events``) or ``None``."""
        cfg = self.config
        now = self._clock() if now is None else now
        if (self._last_poll is not None
                and now - self._last_poll < cfg.interval_s):
            return None
        self._last_poll = now
        telemetry.counter("serve.autoscale.polls").inc()
        sig = self.signals()
        healthy = int(sig["healthy"])
        telemetry.gauge("serve.autoscale.replicas").set(healthy)

        # floor repair: deaths are healed immediately, no hysteresis
        if healthy < cfg.min_replicas:
            return self._actuate(cfg.min_replicas, "floor", sig, now)

        breach = (sig["queue_per_replica"] >= cfg.high_queue
                  or sig["kv_frac"] >= cfg.high_kv_frac
                  or (cfg.high_itl_ms is not None
                      and sig["itl_p99_ewma_ms"] >= cfg.high_itl_ms))
        slack = (sig["queue_per_replica"] <= cfg.low_queue
                 and sig["kv_frac"] <= cfg.low_kv_frac
                 and (cfg.low_itl_ms is None
                      or sig["itl_p99_ewma_ms"] <= cfg.low_itl_ms))
        self._up_streak = self._up_streak + 1 if breach else 0
        self._down_streak = self._down_streak + 1 if slack else 0

        if (breach and self._up_streak >= cfg.breach_polls
                and healthy < cfg.max_replicas
                and self._cool(now, cfg.cooldown_up_s)):
            return self._actuate(
                min(cfg.max_replicas, healthy + cfg.step), "up", sig, now)
        if (slack and self._down_streak >= cfg.breach_polls
                and healthy > cfg.min_replicas
                and self._cool(now, cfg.cooldown_down_s)):
            return self._actuate(
                max(cfg.min_replicas, healthy - cfg.step), "down", sig,
                now)
        return None

    def _cool(self, now: float, cooldown_s: float) -> bool:
        return (self._last_scale is None
                or now - self._last_scale >= cooldown_s)

    def _actuate(self, target: int, direction: str,
                 sig: Dict[str, float], now: float) -> Dict[str, Any]:
        res = self.router.scale_to(target)
        self._last_scale = now
        self._up_streak = 0
        self._down_streak = 0
        event = {"t": now, "direction": direction, "target": target,
                 "healthy_before": int(sig["healthy"]),
                 "signals": {k: round(v, 4) for k, v in sig.items()},
                 "actuation": res}
        self.events.append(event)
        name = ("serve.autoscale.scale_ups"
                if direction in ("up", "floor")
                else "serve.autoscale.scale_downs")
        telemetry.counter(name).inc()
        telemetry.gauge("serve.autoscale.replicas").set(target)
        telemetry.flight_recorder().record({
            "kind": "serve.autoscale", "direction": direction,
            "target": target, "t": round(now, 3)})
        return event

    # -- reporting ---------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        ups = sum(1 for e in self.events if e["direction"] in
                  ("up", "floor"))
        downs = sum(1 for e in self.events if e["direction"] == "down")
        return {"scale_ups": ups, "scale_downs": downs,
                "events": list(self.events)}


def autoscaler_from_env(router, *, clock=None) -> Optional[Autoscaler]:
    """`MXNET_TPU_SERVE_AUTOSCALE=1` turns the loop on (default off);
    the policy knobs come from :meth:`AutoscaleConfig.from_env`."""
    if not _env_int("MXNET_TPU_SERVE_AUTOSCALE", 0):
        return None
    return Autoscaler(router, AutoscaleConfig.from_env(), clock=clock)
