"""Optimizers: SGD (with momentum), Adam and AdamW.

Counterpart of ``mxnet_tpu/optimizer.py``.  Each optimizer has a
functional core ``_functional_step(hyper, w, g, state, lr, wd, t, rng) ->
(new_w, new_state)`` written as torch ops in the JAX package's operation
order: every op is its own correctly rounded float32 operation, so the
fused kernel K2 (``ops/fused_update.py``), which repeats the same order
with round-to-nearest intrinsics, is a bitwise twin of it.  ``lr`` and
``t`` arrive as 0-d float32 tensors on the parameters' device (the
trainer fills them each step), so no step reads anything back to the
host.

The imperative ``update(index, weight, grad, state)`` API, the other
optimizers (NAG, SGLD, AdaGrad, RMSProp, AdaDelta) and learning-rate
schedulers are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .base import MXNetError, Registry, not_ported

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create", "register",
           "adam_lr_t"]

OPTIMIZER_REGISTRY: Registry = Registry("optimizer")


def register(klass):
    """Register an optimizer class under its lower-cased name."""
    OPTIMIZER_REGISTRY.register(klass, name=klass.__name__.lower())
    return klass


def _prep_grad(g, hyper):
    """rescale, then clip -- the JAX package's order."""
    g = g * hyper["rescale_grad"]
    if "clip_gradient" in hyper:
        c = hyper["clip_gradient"]
        g = torch.clamp(g, -c, c)
    return g


def adam_lr_t(lr, beta1: float, beta2: float, t):
    """Bias-corrected Adam step size ``lr * sqrt(1 - b2^t) / (1 - b1^t)``
    with ``t`` cast to float32, shared by the unfused step and the fused
    update so both see the same value."""
    return lr * torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)


def _as_f32(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype)
    return torch.tensor(float(v), dtype=like.dtype, device=like.device)


class Optimizer:
    """Base optimizer: hyperparameters, per-name lr/wd multipliers."""

    _needs_rng = False
    _default_lr = 0.01

    def __init__(self, rescale_grad: Optional[float] = None,
                 param_idx2name: Optional[Dict[int, str]] = None,
                 wd: float = 0.0, clip_gradient: Optional[float] = None,
                 learning_rate: Optional[float] = None,
                 lr_scheduler=None, sym=None, begin_num_update: int = 0,
                 arg_names=None, clip_global_norm: Optional[float] = None,
                 skip_nonfinite: Optional[bool] = None, **kwargs):
        if lr_scheduler is not None:
            raise not_ported("learning-rate schedulers (lr_scheduler.py)")
        # None = "caller did not choose": ShardedTrainer.bind then rescales
        # by 1/batch
        self._rescale_set = rescale_grad is not None
        self.rescale_grad = 1.0 if rescale_grad is None else rescale_grad
        self.lr = (type(self)._default_lr if learning_rate is None
                   else learning_rate)
        self.wd = wd
        self.lr_mult: Dict[str, float] = {}
        self.wd_mult: Dict[str, float] = {}
        self.begin_num_update = begin_num_update
        self.clip_gradient = clip_gradient
        if clip_global_norm is not None and not clip_global_norm > 0:
            raise MXNetError("clip_global_norm must be > 0, got "
                             f"{clip_global_norm!r}")
        self.clip_global_norm = clip_global_norm
        self.skip_nonfinite = skip_nonfinite
        if sym is not None:
            self.set_lr_wd_mult_from_sym(sym)

    def set_lr_wd_mult_from_sym(self, sym) -> None:
        for name, d in sym.attr_dict().items():
            if "lr_mult" in d:
                self.lr_mult[name] = float(d["lr_mult"])
            if "wd_mult" in d:
                self.wd_mult[name] = float(d["wd_mult"])

    def set_lr_mult(self, args_lr_mult: Dict[str, float]) -> None:
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[str, float]) -> None:
        self.wd_mult.update(args_wd_mult)

    def _hyper(self) -> Dict[str, float]:
        """Scalar hyperparameters fed to :meth:`_functional_step`."""
        h = {"rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            h["clip_gradient"] = self.clip_gradient
        return h

    def state_zeros_like(self, weight):
        """Initial optimizer state for one weight (None, a tensor or a
        tuple of tensors)."""
        return None

    @staticmethod
    def _functional_step(hyper, w, g, state, lr, wd, t, rng):
        raise NotImplementedError


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay."""

    def __init__(self, momentum: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def _hyper(self):
        h = super()._hyper()
        h["momentum"] = self.momentum
        return h

    def state_zeros_like(self, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @staticmethod
    def _functional_step(hyper, w, g, state, lr, wd, t, rng):
        g = _prep_grad(g, hyper)
        if state is not None:
            mom = hyper["momentum"] * state - lr * (g + wd * w)
            return w + mom, mom
        return w - lr * (g + wd * w), None


@register
class Adam(Optimizer):
    """Adam, with weight decay folded into the gradient."""

    _default_lr = 0.001

    def __init__(self, learning_rate: Optional[float] = None,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, decay_factor: float = 1 - 1e-8,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.decay_factor = decay_factor

    def _hyper(self):
        h = super()._hyper()
        h.update(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)
        return h

    def state_zeros_like(self, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @staticmethod
    def _functional_step(hyper, w, g, state, lr, wd, t, rng):
        mean, variance = state
        b1, b2 = hyper["beta1"], hyper["beta2"]
        g = _prep_grad(g, hyper) + wd * w
        m = b1 * mean + (1.0 - b1) * g
        v = b2 * variance + (1.0 - b2) * g * g
        lr_t = adam_lr_t(lr, b1, b2, _as_f32(t, w))
        return w - lr_t * m / (torch.sqrt(v) + hyper["epsilon"]), (m, v)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay."""

    @staticmethod
    def _functional_step(hyper, w, g, state, lr, wd, t, rng):
        mean, variance = state
        b1, b2 = hyper["beta1"], hyper["beta2"]
        g = _prep_grad(g, hyper)
        m = b1 * mean + (1.0 - b1) * g
        v = b2 * variance + (1.0 - b2) * g * g
        lr_t = adam_lr_t(lr, b1, b2, _as_f32(t, w))
        update = lr_t * m / (torch.sqrt(v) + hyper["epsilon"])
        return w - update - lr * wd * w, (m, v)


def create(name: str, rescale_grad: Optional[float] = None,
           **kwargs) -> Optimizer:
    """Create an optimizer by registered name."""
    try:
        klass = OPTIMIZER_REGISTRY.get(name)
    except KeyError as e:
        raise MXNetError(str(e)) from e
    return klass(rescale_grad=rescale_grad, **kwargs)
