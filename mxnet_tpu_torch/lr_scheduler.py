"""Learning-rate schedulers.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (host code, kept as a copy so
the port imports nothing of the JAX package).  A scheduler maps an update
count to a learning rate in Python floats on the host; the trainer hands
the value to the card as a 0-d tensor each step.
"""
from __future__ import annotations

import logging
import math

from .base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "WarmupScheduler", "CosineScheduler"]


class LRScheduler:
    """Base: ``__call__(num_update) -> lr``."""

    def __init__(self, base_lr: float = None):
        # None = "not explicitly chosen": wrappers (WarmupScheduler) and
        # Optimizer.__init__ may overwrite an implicit base_lr, but an
        # explicitly constructed one wins
        self._explicit_base_lr = base_lr is not None
        self.base_lr = 0.01 if base_lr is None else base_lr

    def _set_base_lr_explicit(self, lr: float) -> None:
        """Stamp an EXPLICIT base_lr (an optimizer's learning_rate=...).
        Explicit optimizer lr outranks everything; wrappers override to
        propagate it through to their inner scheduler."""
        self.base_lr = lr
        self._explicit_base_lr = True

    def _effective_explicit_base_lr(self):
        """The explicitly-chosen base_lr this schedule will actually run
        at, or None if everything is implicit.  Wrappers look through to
        their inner scheduler so Optimizer.lr backfills correctly."""
        return self.base_lr if self._explicit_base_lr else None

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates, down to ``stop_factor_lr``."""

    def __init__(self, step: int, factor: float = 1.0,
                 stop_factor_lr: float = 1e-8):
        super().__init__()
        if step < 1:
            raise MXNetError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise MXNetError("Factor must be no more than 1 to make lr "
                             "reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update: int) -> float:
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: now learning rate arrived at "
                             "%.5e, will not change in the future",
                             num_update, self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each of the given update counts."""

    def __init__(self, step, factor: float = 1.0):
        super().__init__()
        if not isinstance(step, (list, tuple)) or len(step) < 1:
            raise MXNetError("step must be a non-empty list")
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise MXNetError("Schedule step must be an increasing list")
            if _step < 1:
                raise MXNetError("Schedule step must be greater or equal "
                                 "than 1")
        if factor > 1.0:
            raise MXNetError("Factor must be no more than 1 to make lr "
                             "reduce")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update: int) -> float:
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class WarmupScheduler(LRScheduler):
    """Linear warmup 0 -> base_lr over ``warmup_steps``, then ``after``
    (or base_lr held)."""

    def __init__(self, warmup_steps: int, after: "LRScheduler" = None,
                 base_lr: float = None):
        super().__init__(base_lr)
        if warmup_steps < 1:
            raise MXNetError("warmup_steps must be >= 1")
        self.warmup_steps = warmup_steps
        self.after = after

    def _set_base_lr_explicit(self, lr: float) -> None:
        # the optimizer's explicit lr is the post-warmup lr too: stamp
        # the inner scheduler as well, and mark the lazy sync done
        super()._set_base_lr_explicit(lr)
        if self.after is not None:
            self.after._set_base_lr_explicit(lr)
        self._synced = True

    def _effective_explicit_base_lr(self):
        if self._explicit_base_lr:
            return self.base_lr
        if self.after is not None:
            return self.after._effective_explicit_base_lr()
        return None

    def __call__(self, num_update: int) -> float:
        # propagate ONCE, lazily: Optimizer.__init__ rewrites base_lr on
        # this wrapper after construction and that must reach `after`;
        # FactorScheduler keeps its decay state in base_lr, so a rewrite
        # on every call would erase its progress, and an inner scheduler
        # built with an explicit base_lr keeps it (the wrapper then adopts
        # it as the ramp peak, so warmup -> after stays continuous)
        if self.after is not None and not getattr(self, "_synced", False):
            if getattr(self.after, "_explicit_base_lr", False):
                if not self._explicit_base_lr:
                    self.base_lr = self.after.base_lr
            else:
                self.after.base_lr = self.base_lr
            self._synced = True
        if num_update < self.warmup_steps:
            return self.base_lr * (num_update + 1) / self.warmup_steps
        if self.after is not None:
            return self.after(num_update - self.warmup_steps)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay base_lr -> final_lr over ``max_update`` updates."""

    def __init__(self, max_update: int, final_lr: float = 0.0,
                 base_lr: float = None):
        super().__init__(base_lr)
        if max_update < 1:
            raise MXNetError("max_update must be >= 1")
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update: int) -> float:
        if num_update >= self.max_update:
            return self.final_lr
        frac = num_update / self.max_update
        return (self.final_lr + (self.base_lr - self.final_lr)
                * 0.5 * (1.0 + math.cos(math.pi * frac)))
