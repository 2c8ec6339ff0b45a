"""Training guardrails: the non-finite step guard and global-norm clipping.

Counterpart of the in-step part of ``mxnet_tpu/resilience.py``.  The
trainer reduces the gradients to one float32 statistic, their sum of
squares (:func:`tree_sq_sum`); ``ok = isfinite(sq)`` gates the whole
update (a bad step leaves parameters, optimizer state and aux states
bitwise unchanged) and the effective norm ``sqrt(sq) * |rescale_grad|``
sets the clip multiplier.  The guard's counters (:func:`init_state`,
:func:`state_update`) live on the card as 0-d tensors, so no step waits
for the host.

:class:`Heartbeat` is the progress-based liveness tracker the serving
router checks its replicas with.

Loss scaling (``loss_scale``), the host-side divergence sentinel and the
legacy Module/FeedForward guard are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import torch

from .base import not_ported

__all__ = ["GuardConfig", "resolve", "init_state", "tree_sq_sum",
           "state_update", "STATE_KEYS", "Heartbeat"]

STATE_KEYS = ("skipped", "norm_sum", "norm_cnt")


def _env_flag(name: str) -> Optional[bool]:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return None
    return raw.strip().lower() not in ("0", "false", "off", "no")


class GuardConfig:
    """Static guard configuration: the non-finite skip is always on;
    ``clip_global_norm`` adds the clip multiplier.  The JAX package's
    loss-scale and sentinel knobs are not ported and raise."""

    def __init__(self, clip_global_norm: Optional[float] = None,
                 loss_scale: Any = None, **knobs: Any):
        if loss_scale is not None:
            raise not_ported("loss scaling (loss_scale)")
        if knobs:
            raise not_ported(f"guard knobs {sorted(knobs)} (loss-scale "
                             "schedule, divergence sentinel)")
        if clip_global_norm is not None:
            clip_global_norm = float(clip_global_norm)
            if clip_global_norm <= 0:
                raise ValueError("clip_global_norm must be positive")
        self.clip_global_norm = clip_global_norm


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
