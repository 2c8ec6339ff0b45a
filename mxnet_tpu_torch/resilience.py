"""Training guardrails: the non-finite step guard, dynamic loss scaling,
global-norm clipping and the divergence sentinel.

Counterpart of ``mxnet_tpu/resilience.py``.  The trainer reduces the
gradients to one float32 statistic, their sum of squares
(:func:`tree_sq_sum`); ``ok = isfinite(sq)`` gates the whole update (a
bad step leaves parameters, optimizer state and aux states bitwise
unchanged) and the effective norm ``sqrt(sq) * |rescale_grad| / scale``
sets the clip multiplier.  With ``loss_scale`` the heads' cotangents are
the scale instead of ones, so the backward runs at ``scale`` times the
magnitude, and ``1 / scale`` folds into the one combined multiplier with
the clip coefficient.  The guard's six counters (:data:`STATE_KEYS`:
the loss scale, the good-step streak, and the windowed skipped, overflow
and norm counters; :func:`init_state`, :func:`state_update`) live on
the card as 0-d tensors, so no step waits for the host; under
``"dynamic"`` scaling the scale grows by ``growth_factor`` after
``growth_interval`` good steps in a row and backs off by
``backoff_factor`` on an overflow, clamped to ``[min_scale,
max_scale]``.  ``ShardedTrainer.fit`` drains the counters every
``GuardConfig.check_every`` batches into :class:`DivergenceSentinel`, a
host-side detector that backs off the learning rate on a gradient-norm
spike or an all-skipped window and, after ``rollback_after`` anomalies in
a row, rolls back to the last checkpoint; each drain folds the windowed
counters (:data:`WINDOW_KEYS`) into a host-side base and zeroes them on
the card.

:class:`Heartbeat` is the progress-based liveness tracker the serving
router checks its replicas with.

:class:`LegacyGuard` is the skip/clip guard of the legacy loops
(``FeedForward``, ``Module``): one sum of squares per device and one
fetch a step, which those loops make anyway.
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

__all__ = ["GuardConfig", "resolve", "init_state", "tree_sq_sum",
           "state_update", "STATE_KEYS", "WINDOW_KEYS",
           "DivergenceSentinel", "Heartbeat", "LegacyGuard",
           "legacy_guard_for"]

_LOGGER = logging.getLogger(__name__)

# the device-side guard state, in a fixed order (checkpoints read it so)
STATE_KEYS = ("scale", "good", "skipped", "overflows", "norm_sum", "norm_cnt")

_INT_KEYS = frozenset(("good", "skipped", "overflows", "norm_cnt"))

# windowed counters: folded into the host-side base and zeroed on the
# card at each drain; "scale" and "good" carry the live schedule
WINDOW_KEYS = ("skipped", "overflows", "norm_sum", "norm_cnt")


def _env_flag(name: str) -> Optional[bool]:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return None
    return raw.strip().lower() not in ("0", "false", "off", "no")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError("%s must be a float, got %r" % (name, raw))


class GuardConfig:
    """Static guard configuration: the non-finite skip is always on;
    ``clip_global_norm`` adds the clip multiplier and ``loss_scale``
    (None, a fixed float or ``"dynamic"``) the scaled backward.  The
    schedule knobs and the sentinel knobs (host side, read by
    :class:`DivergenceSentinel` and ``ShardedTrainer.fit``) are the JAX
    package's, with its defaults."""

    def __init__(self, clip_global_norm: Optional[float] = None,
                 loss_scale: Any = None,
                 init_scale: float = 2.0 ** 15,
                 growth_factor: float = 2.0,
                 backoff_factor: float = 0.5,
                 growth_interval: int = 200,
                 min_scale: float = 2.0 ** -14,
                 max_scale: float = 2.0 ** 24,
                 check_every: int = 25,
                 window: int = 16,
                 min_history: int = 4,
                 spike_factor: float = 8.0,
                 lr_backoff: float = 0.5,
                 min_lr_scale: float = 1.0 / 64.0,
                 rollback_after: int = 2,
                 cooldown: int = 2):
        if clip_global_norm is not None:
            clip_global_norm = float(clip_global_norm)
            if clip_global_norm <= 0:
                raise ValueError("clip_global_norm must be positive")
        if loss_scale is not None and loss_scale != "dynamic":
            loss_scale = float(loss_scale)
            if loss_scale <= 0:
                raise ValueError("loss_scale must be positive or 'dynamic'")
        self.clip_global_norm = clip_global_norm
        self.loss_scale = loss_scale
        self.init_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.check_every = int(check_every)
        self.window = int(window)
        self.min_history = int(min_history)
        self.spike_factor = float(spike_factor)
        self.lr_backoff = float(lr_backoff)
        self.min_lr_scale = float(min_lr_scale)
        self.rollback_after = int(rollback_after)
        self.cooldown = int(cooldown)

    @property
    def scaling(self) -> bool:
        return self.loss_scale is not None

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == "dynamic"

    def describe(self) -> Dict[str, Any]:
        """The fields that change the step's arithmetic (the JAX package
        keys its compiled program with them)."""
        return {
            "clip_global_norm": self.clip_global_norm,
            "loss_scale": ("dynamic" if self.dynamic
                           else self.loss_scale),
            "dynamic": (self.growth_factor, self.backoff_factor,
                        self.growth_interval, self.min_scale,
                        self.max_scale) if self.dynamic else None,
        }


def _loss_scale_from_env() -> Any:
    raw = os.environ.get("MXNET_TPU_LOSS_SCALE")
    if raw is None:
        return None
    raw = raw.strip().lower()
    if raw in ("", "0", "off", "none"):
        return None
    if raw == "dynamic":
        return "dynamic"
    return float(raw)


def resolve(guard: Optional[bool] = None,
            clip_global_norm: Optional[float] = None,
            loss_scale: Any = None,
            **overrides: Any) -> Optional[GuardConfig]:
    """The effective :class:`GuardConfig`, or None when every defense is
    off.  Unset arguments read ``MXNET_TPU_GUARD`` and
    ``MXNET_TPU_LOSS_SCALE`` (with ``_INIT``, ``_GROWTH``, ``_BACKOFF``
    and ``_INTERVAL`` for the schedule); clipping or scaling turns the
    guard on, as in the JAX package."""
    if guard is None:
        guard = _env_flag("MXNET_TPU_GUARD")
    if loss_scale is None:
        loss_scale = _loss_scale_from_env()
    if guard is False:
        if clip_global_norm is not None or loss_scale is not None:
            raise ValueError("guard=False conflicts with "
                             "clip_global_norm/loss_scale (both ride on "
                             "the fused grad stats)")
        return None
    if not guard and clip_global_norm is None and loss_scale is None:
        return None
    kwargs: Dict[str, Any] = dict(
        clip_global_norm=clip_global_norm,
        loss_scale=loss_scale,
        init_scale=_env_float("MXNET_TPU_LOSS_SCALE_INIT", 2.0 ** 15),
        growth_factor=_env_float("MXNET_TPU_LOSS_SCALE_GROWTH", 2.0),
        backoff_factor=_env_float("MXNET_TPU_LOSS_SCALE_BACKOFF", 0.5),
        growth_interval=int(_env_float("MXNET_TPU_LOSS_SCALE_INTERVAL",
                                       200)),
    )
    kwargs.update(overrides)
    return GuardConfig(**kwargs)


def init_state(cfg: GuardConfig, device) -> Dict[str, torch.Tensor]:
    """Initial guard state: 0-d tensors on ``device`` keyed
    :data:`STATE_KEYS` -- the scale (``init_scale`` under dynamic
    scaling, the fixed scale, else 1.0) and the float32 ``norm_sum``,
    int32 counters otherwise."""
    scale = cfg.init_scale if cfg.dynamic else (
        float(cfg.loss_scale) if cfg.scaling else 1.0)
    out = {}
    for k in STATE_KEYS:
        if k in _INT_KEYS:
            out[k] = torch.zeros((), dtype=torch.int32, device=device)
        else:
            out[k] = torch.full((), scale if k == "scale" else 0.0,
                                dtype=torch.float32, device=device)
    return out


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
                 norm: torch.Tensor,
                 cfg: GuardConfig) -> Dict[str, torch.Tensor]:
    """Guard-state transition: count skipped steps, sum the norm of the
    steps taken, and under dynamic scaling run the schedule (a step that
    is not finite is an overflow: it backs the scale off)."""
    oki = ok.to(torch.int32)
    new = dict(state)
    new["skipped"] = state["skipped"] + (1 - oki)
    new["norm_sum"] = state["norm_sum"] + torch.where(
        ok, norm, torch.zeros_like(norm)).to(torch.float32)
    new["norm_cnt"] = state["norm_cnt"] + oki
    if cfg.dynamic:
        scale = state["scale"]
        good = torch.where(ok, state["good"] + 1,
                           torch.zeros_like(state["good"]))
        grow = good >= cfg.growth_interval
        grown = torch.clamp_max(scale * cfg.growth_factor, cfg.max_scale)
        shrunk = torch.clamp_min(scale * cfg.backoff_factor, cfg.min_scale)
        new["scale"] = torch.where(ok, torch.where(grow, grown, scale),
                                   shrunk).to(torch.float32)
        new["good"] = torch.where(grow, torch.zeros_like(good), good)
        new["overflows"] = state["overflows"] + (1 - oki)
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
        # one fetch: the devices' sums stacked on the first device
        vals = torch.stack([s.to(sqs[0].device) for s in sqs]).to(
            "cpu").numpy().astype(np.float64)
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

    def share_coef(self, num_device: int) -> None:
        """Device 0's clip coefficient for every device: after a kvstore
        pull the gradients are the same on every device, and one
        coefficient keeps the parameter copies the same."""
        coef = self._coefs[0] if self._coefs else 1.0
        self._coefs = [coef] * num_device

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
