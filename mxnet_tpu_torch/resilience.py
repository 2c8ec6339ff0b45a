"""Training guardrails: the non-finite step guard, global-norm clipping
and the divergence sentinel.

Counterpart of the in-step part of ``mxnet_tpu/resilience.py``.  The
trainer reduces the gradients to one float32 statistic, their sum of
squares (:func:`tree_sq_sum`); ``ok = isfinite(sq)`` gates the whole
update (a bad step leaves parameters, optimizer state and aux states
bitwise unchanged) and the effective norm ``sqrt(sq) * |rescale_grad|``
sets the clip multiplier.  The guard's counters (:func:`init_state`,
:func:`state_update`) live on the card as 0-d tensors, so no step waits
for the host; ``ShardedTrainer.fit`` drains them every
``GuardConfig.check_every`` batches into :class:`DivergenceSentinel`, a
host-side detector that backs off the learning rate on a gradient-norm
spike or an all-skipped window.

:class:`Heartbeat` is the progress-based liveness tracker the serving
router checks its replicas with.

:class:`LegacyGuard` is the skip/clip guard of the legacy loops
(``FeedForward``, ``Module``): one sum of squares per device and one
fetch a step, which those loops make anyway.

Loss scaling (``loss_scale`` and its schedule knobs) is not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import collections
import logging
import os
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .base import not_ported

__all__ = ["GuardConfig", "resolve", "init_state", "tree_sq_sum",
           "state_update", "STATE_KEYS", "DivergenceSentinel", "Heartbeat",
           "LegacyGuard", "legacy_guard_for"]

_LOGGER = logging.getLogger(__name__)

STATE_KEYS = ("skipped", "norm_sum", "norm_cnt")

# the loss-scale schedule's knobs, which raise until loss scaling is ported
_LOSS_SCALE_KNOBS = ("init_scale", "growth_factor", "backoff_factor",
                     "growth_interval", "min_scale", "max_scale")


def _env_flag(name: str) -> Optional[bool]:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return None
    return raw.strip().lower() not in ("0", "false", "off", "no")


class GuardConfig:
    """Static guard configuration: the non-finite skip is always on;
    ``clip_global_norm`` adds the clip multiplier.  The sentinel knobs
    (host side, read by :class:`DivergenceSentinel` and
    ``ShardedTrainer.fit``) are the JAX package's, with its defaults; the
    loss-scale knobs are not ported and raise."""

    def __init__(self, clip_global_norm: Optional[float] = None,
                 loss_scale: Any = None,
                 check_every: int = 25,
                 window: int = 16,
                 min_history: int = 4,
                 spike_factor: float = 8.0,
                 lr_backoff: float = 0.5,
                 min_lr_scale: float = 1.0 / 64.0,
                 rollback_after: int = 2,
                 cooldown: int = 2,
                 **knobs: Any):
        if loss_scale is not None:
            raise not_ported("loss scaling (loss_scale)")
        unknown = sorted(k for k in knobs if k not in _LOSS_SCALE_KNOBS)
        if unknown:
            raise TypeError(f"unknown guard knobs {unknown}")
        if knobs:
            raise not_ported(f"guard knobs {sorted(knobs)} (the loss-scale "
                             "schedule)")
        if clip_global_norm is not None:
            clip_global_norm = float(clip_global_norm)
            if clip_global_norm <= 0:
                raise ValueError("clip_global_norm must be positive")
        self.clip_global_norm = clip_global_norm
        self.check_every = int(check_every)
        self.window = int(window)
        self.min_history = int(min_history)
        self.spike_factor = float(spike_factor)
        self.lr_backoff = float(lr_backoff)
        self.min_lr_scale = float(min_lr_scale)
        self.rollback_after = int(rollback_after)
        self.cooldown = int(cooldown)


def resolve(guard: Optional[bool] = None,
            clip_global_norm: Optional[float] = None,
            loss_scale: Any = None,
            **overrides: Any) -> Optional[GuardConfig]:
    """The effective :class:`GuardConfig`, or None when every defense is
    off.  An unset ``guard`` reads ``MXNET_TPU_GUARD``; clipping turns the
    guard on, as in the JAX package."""
    if guard is None:
        guard = _env_flag("MXNET_TPU_GUARD")
    if loss_scale is None and os.environ.get(
            "MXNET_TPU_LOSS_SCALE", "").strip().lower() not in (
                "", "0", "off", "none"):
        raise not_ported("loss scaling (MXNET_TPU_LOSS_SCALE)")
    if guard is False:
        if clip_global_norm is not None or loss_scale is not None:
            raise ValueError("guard=False conflicts with "
                             "clip_global_norm/loss_scale (both ride on "
                             "the fused grad stats)")
        return None
    if not guard and clip_global_norm is None and loss_scale is None:
        return None
    return GuardConfig(clip_global_norm=clip_global_norm,
                       loss_scale=loss_scale, **overrides)


def init_state(device) -> Dict[str, torch.Tensor]:
    """Initial guard state: 0-d tensors on ``device`` -- the skipped-step
    and taken-step counters (int32) and the sum of the taken steps'
    norms (float32)."""
    return {k: torch.zeros((), device=device,
                           dtype=torch.float32 if k == "norm_sum"
                           else torch.int32) for k in STATE_KEYS}


def tree_sq_sum(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """float32 sum of squares over a {name: grad} dict, summed in sorted
    name order (the JAX package's pytree leaf order)."""
    total = None
    for name in sorted(grads):
        sq = torch.sum(torch.square(grads[name].float()))
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("tree_sq_sum of no gradients")
    return total


def state_update(state: Dict[str, torch.Tensor], ok: torch.Tensor,
                 norm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Guard-state transition: count skipped steps, and sum the norm of
    the steps taken."""
    oki = ok.to(torch.int32)
    new = dict(state)
    new["skipped"] = state["skipped"] + (1 - oki)
    new["norm_sum"] = state["norm_sum"] + torch.where(
        ok, norm, torch.zeros_like(norm)).to(torch.float32)
    new["norm_cnt"] = state["norm_cnt"] + oki
    return new


class DivergenceSentinel(object):
    """Rolling anomaly detector over periodic guard-state drains.

    ``observe`` gets the window's mean gradient norm (None when every
    step in the window was skipped), the number of skipped steps and the
    number of steps, and returns ``None``, ``"backoff"`` or
    ``"rollback"``.  A spike is a window mean above ``spike_factor``
    times the rolling median of healthy windows; an all-skipped window
    is an anomaly too.  ``rollback_after`` anomalies in a row ask for a
    rollback, after which ``cooldown`` windows pass unjudged while the
    history refills."""

    def __init__(self, cfg: GuardConfig, logger=None):
        self.cfg = cfg
        self.logger = logger or _LOGGER
        self.history: "collections.deque" = collections.deque(
            maxlen=cfg.window)
        self.anomaly_streak = 0
        self.cooldown = 0
        self.backoffs = 0
        self.rollbacks = 0

    def observe(self, norm_mean: Optional[float], skipped: int,
                steps: int) -> Optional[str]:
        if steps <= 0:
            return None
        if self.cooldown > 0:
            self.cooldown -= 1
            if norm_mean is not None:
                self.history.append(norm_mean)
            return None
        anomaly = False
        reason = ""
        if skipped >= steps:
            anomaly = True
            reason = "all %d steps in window skipped" % steps
        if (norm_mean is not None and
                len(self.history) >= self.cfg.min_history):
            med = statistics.median(self.history)
            if med > 0.0 and norm_mean > self.cfg.spike_factor * med:
                anomaly = True
                reason = ("grad-norm spike %.3g vs rolling median %.3g"
                          % (norm_mean, med))
        if not anomaly:
            self.anomaly_streak = 0
            if norm_mean is not None:
                self.history.append(norm_mean)
            return None
        self.anomaly_streak += 1
        from . import telemetry
        telemetry.gauge("sentinel.anomaly_streak").set(self.anomaly_streak)
        if self.anomaly_streak >= self.cfg.rollback_after:
            self.anomaly_streak = 0
            self.cooldown = self.cfg.cooldown
            self.history.clear()
            self.rollbacks += 1
            telemetry.counter("sentinel.rollbacks").inc()
            self.logger.warning("Resilience sentinel: %s -> rollback",
                                reason)
            return "rollback"
        self.backoffs += 1
        telemetry.counter("sentinel.backoffs").inc()
        self.logger.warning("Resilience sentinel: %s -> LR backoff",
                            reason)
        return "backoff"


class LegacyGuard(object):
    """Skip/clip guard for the legacy per-device updater path.

    ``prepare(per_device_grads)`` computes one float32 sum of squares per
    device (:func:`tree_sq_sum`) and fetches them to the host together,
    one transfer a step.  It returns False when the step must be skipped
    (a non-finite gradient anywhere); otherwise per-device clip
    coefficients are staged and ``grad_for(grad, dev)`` rescales, an
    identity when no clip is needed.
    """

    def __init__(self, clip_global_norm: Optional[float] = None,
                 skip_nonfinite: bool = True,
                 rescale_grad: float = 1.0, logger=None):
        self.clip_global_norm = (None if clip_global_norm is None
                                 else float(clip_global_norm))
        self.skip_nonfinite = bool(skip_nonfinite)
        self.rescale_grad = abs(float(rescale_grad)) or 1.0
        self.logger = logger or _LOGGER
        self.skipped_steps = 0
        self.clipped_steps = 0
        self._coefs: List[float] = []
        self._warned = False

    def prepare(self, per_device_grads: Sequence[Sequence[torch.Tensor]],
                allow_clip: bool = True) -> bool:
        """``per_device_grads[k]``: every gradient tensor on device k.
        Returns whether the update should proceed."""
        sqs = [tree_sq_sum(dict(enumerate(gs))) for gs in per_device_grads]
        # one fetch: the devices' sums stacked where they lie (one device
        # in the port; slice E brings several)
        vals = torch.stack(sqs).to("cpu").numpy().astype(np.float64)
        finite = bool(np.isfinite(vals).all())
        if self.skip_nonfinite and not finite:
            self.skipped_steps += 1
            if not self._warned:
                self.logger.warning(
                    "non-finite gradient detected; skipping update "
                    "(further skips counted on .skipped_steps)")
                self._warned = True
            return False
        self._coefs = [1.0] * len(vals)
        if self.clip_global_norm is not None and allow_clip and finite:
            clipped = False
            for k, v in enumerate(vals):
                norm = float(np.sqrt(v)) * self.rescale_grad
                if norm > self.clip_global_norm:
                    self._coefs[k] = self.clip_global_norm / max(norm,
                                                                 1e-12)
                    clipped = True
            if clipped:
                self.clipped_steps += 1
        return True

    def grad_for(self, grad, dev: int):
        """Clip-rescaled gradient for device ``dev`` (NDArray in, NDArray
        out; the same array unless this step clips)."""
        coef = self._coefs[dev] if dev < len(self._coefs) else 1.0
        if coef >= 1.0:
            return grad
        from .ndarray import NDArray
        return NDArray(grad.data * float(np.float32(coef)), ctx=grad.context)


def legacy_guard_for(optimizer, logger=None) -> Optional[LegacyGuard]:
    """The legacy guard an optimizer asks for, or None: on with
    ``clip_global_norm``, ``skip_nonfinite=True`` or ``MXNET_TPU_GUARD=1``."""
    clip = getattr(optimizer, "clip_global_norm", None)
    skip = getattr(optimizer, "skip_nonfinite", None)
    if skip is None:
        skip = bool(_env_flag("MXNET_TPU_GUARD"))
    if clip is None and not skip:
        return None
    return LegacyGuard(clip_global_norm=clip, skip_nonfinite=skip,
                       rescale_grad=getattr(optimizer, "rescale_grad", 1.0),
                       logger=logger)


class Heartbeat(object):
    """Progress-based liveness tracking for a set of named peers.

    A peer is healthy while its *progress counter advances*, stale once
    ``timeout_ms`` passes without an advance.  Merely calling into a peer
    and returning is not proof of life — a wedged replica's ``step()`` can
    return at once having done nothing, which is exactly the failure this
    must catch.

    ``clock`` is injectable so timeout tests advance a fake clock instead
    of sleeping."""

    def __init__(self, timeout_ms: float, clock=time.monotonic):
        self.timeout_ms = float(timeout_ms)
        self._clock = clock
        self._last: Dict[Any, float] = {}
        self._progress: Dict[Any, Any] = {}

    def beat(self, peer, progress=None, now: Optional[float] = None) -> bool:
        """Record a liveness observation.  With ``progress`` given, the
        beat only registers when the counter moved since the last
        observation; without it, the call itself counts (use for peers
        that are legitimately idle).  Returns whether the beat
        registered."""
        now = self._clock() if now is None else now
        known = peer in self._last
        if (known and progress is not None
                and progress == self._progress.get(peer)):
            return False
        self._last[peer] = now
        self._progress[peer] = progress
        return True

    def age_ms(self, peer, now: Optional[float] = None) -> float:
        """Milliseconds since the peer's last registered beat (0 for a
        never-seen peer: unknown is not the same as dead)."""
        now = self._clock() if now is None else now
        return (now - self._last.get(peer, now)) * 1e3

    def stale(self, now: Optional[float] = None) -> List[Any]:
        """Peers whose last registered beat is older than
        ``timeout_ms``."""
        now = self._clock() if now is None else now
        return [p for p, t in sorted(self._last.items())
                if (now - t) * 1e3 > self.timeout_ms]

    def forget(self, peer) -> None:
        """Stop tracking a peer (declared dead or drained)."""
        self._last.pop(peer, None)
        self._progress.pop(peer, None)
