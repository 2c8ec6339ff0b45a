"""Optimizers: SGD (with momentum), NAG, SGLD, ccSGD, Adam, AdamW, AdaGrad,
RMSProp, AdaDelta and Test.

Counterpart of ``mxnet_tpu/optimizer.py``.  Each optimizer has a
functional core ``_functional_step(hyper, w, g, state, lr, wd, t, rng) ->
(new_w, new_state)`` written as torch ops in the JAX package's operation
order: every op is its own correctly rounded float32 operation, so the
fused kernel K2 (``ops/fused_update.py``), which repeats the same order
with round-to-nearest intrinsics, is a bitwise twin of it.  ``lr`` and
``t`` arrive as 0-d float32 tensors on the parameters' device (the
trainer fills them each step), so no step reads anything back to the
host.

The imperative API (``create_state``, ``update(index, weight, grad,
state)`` on NDArrays, :func:`get_updater`) runs the same
``_functional_step`` per parameter.  An ``lr_scheduler``
(:mod:`.lr_scheduler`) sets the rate on the host from the update count,
with the JAX package's base-rate hand-over between the optimizer's
``learning_rate`` and the scheduler's ``base_lr``.  SGLD draws its noise
from a ``torch.Generator`` on the weights' device (the trainer's, or the
imperative API's per-device one), so its bits cannot equal the JAX
package's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .base import MXNetError, Registry

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "ccSGD", "Adam", "AdamW",
           "AdaGrad", "RMSProp", "AdaDelta", "Test", "create", "register",
           "adam_lr_t", "sqrt_rn", "get_updater", "states_to_host",
           "states_from_host"]

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


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on every device, as the JAX
    package's and the kernel's (``__fsqrt_rn``).  CUDA's ``torch.sqrt`` is
    correctly rounded; ATen's vectorised CPU float32 sqrt is not (one ulp
    off on about 0.65 % of random inputs on an AVX-512 host), so on the CPU
    the root is taken in float64 and rounded once to ``x``'s type, which
    is correct for float32 inputs (53 >= 2 * 24 + 2 bits)."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)  # staticcheck: disable=program.widen -- the CPU's correctly rounded root: float64 for one op, rounded once


def _as_f32(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype)
    # a fill, not a copy from the host: capturable in a CUDA graph
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


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
        # None = "caller did not choose": ShardedTrainer.bind then rescales
        # by 1/batch
        self._rescale_set = rescale_grad is not None
        self.rescale_grad = 1.0 if rescale_grad is None else rescale_grad
        self.lr = (type(self)._default_lr if learning_rate is None
                   else learning_rate)
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            # an explicit optimizer learning_rate wins (and reaches the
            # inner scheduler of a wrapper); otherwise a scheduler built
            # with an explicit base_lr keeps it and backfills self.lr
            if learning_rate is not None:
                if hasattr(lr_scheduler, "_set_base_lr_explicit"):
                    lr_scheduler._set_base_lr_explicit(self.lr)
                else:
                    lr_scheduler.base_lr = self.lr
            else:
                eff = getattr(lr_scheduler, "_effective_explicit_base_lr",
                              lambda: None)()
                if eff is None:
                    lr_scheduler.base_lr = self.lr
                else:
                    self.lr = eff
        self.wd = wd
        self.lr_mult: Dict[str, float] = {}
        self.wd_mult: Dict[str, float] = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise MXNetError("param_idx2name should be a dict of param "
                             "indexes to names")
        self.idx2name = dict(param_idx2name)
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

    # --- the imperative API: one index at a time, on NDArrays ----------

    def _update_count(self, index) -> None:
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _name(self, index):
        return self.idx2name.get(index,
                                 index if isinstance(index, str) else None)

    def _get_lr(self, index) -> float:
        lr = (self.lr_scheduler(self.num_update) if self.lr_scheduler
              else self.lr)
        name = self._name(index)
        if name is not None and name in self.lr_mult:
            lr *= self.lr_mult[name]
        return lr

    def _get_wd(self, index) -> float:
        """``wd`` times the name's multiplier; names ending in ``_gamma``,
        ``_beta`` or ``_bias`` default to no decay, as in the reference."""
        wd = self.wd
        name = self._name(index)
        if name is not None:
            if name in self.wd_mult:
                wd *= self.wd_mult[name]
            elif name.endswith(("_gamma", "_beta", "_bias")):
                wd = 0.0
        return wd

    def create_state(self, index, weight):
        """State for one weight NDArray: None, an NDArray or a tuple of
        NDArrays on the weight's context."""
        from .ndarray import NDArray
        sval = self.state_zeros_like(weight.data)
        if isinstance(sval, tuple):
            return tuple(NDArray(s, ctx=weight.context) for s in sval)
        return None if sval is None else NDArray(sval, ctx=weight.context)

    def update(self, index, weight, grad, state) -> None:
        """Update one weight NDArray in place from its gradient, through
        the same ``_functional_step`` as the trainer's unfused update."""
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        svals = (None if state is None else
                 tuple(s.data for s in state) if isinstance(state, tuple)
                 else state.data)
        rng = None
        if self._needs_rng:
            from . import random as _random
            rng = _random.generator(weight.context)
        with torch.no_grad():
            new_w, new_s = self._functional_step(
                self._hyper(), weight.data, grad.data.to(weight.data.dtype),
                svals, lr, wd, t, rng)
        weight._write(new_w)
        if isinstance(state, tuple):
            for s, v in zip(state, new_s):
                s._write(v)
        elif state is not None:
            state._write(new_s)


def states_to_host(states: Dict[Any, Any]) -> Dict[Any, Any]:
    """An updater's per-index states in host (numpy) form, pickleable and
    equal to the JAX package's."""
    from .ndarray import NDArray

    def conv(v):
        if isinstance(v, NDArray):
            return ("__nd__", v.asnumpy())
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        return v

    return {k: conv(v) for k, v in states.items()}


def states_from_host(blob: Dict[Any, Any], ctx_for_key=None
                     ) -> Dict[Any, Any]:
    """Updater states from :func:`states_to_host`'s form;
    ``ctx_for_key(key)`` may name the context of that key's arrays (a
    weight's states live with it)."""
    from .ndarray import array as nd_array

    def conv(v, ctx):
        if isinstance(v, tuple) and len(v) == 2 and v[0] == "__nd__":
            return nd_array(v[1], ctx=ctx, dtype=v[1].dtype)
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x, ctx) for x in v)
        return v

    return {k: conv(v, ctx_for_key(k) if ctx_for_key is not None else None)
            for k, v in blob.items()}


def get_updater(optimizer: Optimizer):
    """``updater(index, grad, weight)``: creates each index's state on
    first use and calls :meth:`Optimizer.update` (the reference's
    ``get_updater``)."""
    states: Dict[Any, Any] = {}

    def updater(index, grad, weight):
        if index not in states:
            states[index] = optimizer.create_state(index, weight)
        optimizer.update(index, weight, grad, states[index])

    updater.states = states
    return updater


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
class NAG(SGD):
    """Nesterov accelerated SGD."""

    @staticmethod
    def _functional_step(hyper, w, g, state, lr, wd, t, rng):
        g = _prep_grad(g, hyper)
        if state is not None:
            gw = g + wd * w
            mom = hyper["momentum"] * state - lr * gw
            return w + hyper["momentum"] * mom - lr * gw, mom
        return w - lr * (g + wd * w), None


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: a half step plus Gaussian
    noise of variance ``lr``, drawn from ``rng`` (a ``torch.Generator``
    on the weight's device)."""

    _needs_rng = True

    @staticmethod
    def _functional_step(hyper, w, g, state, lr, wd, t, rng):
        g = _prep_grad(g, hyper)
        noise = torch.randn(w.shape, generator=rng, dtype=w.dtype,
                            device=w.device) * torch.sqrt(_as_f32(lr, w))
        return w - lr / 2 * (g + wd * w) + noise, None


@register
class ccSGD(SGD):
    """SGD under the reference's name for its C++ flat-buffer SGD; the
    fused update (K2) takes it as SGD."""


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
        return w - lr_t * m / (sqrt_rn(v) + hyper["epsilon"]), (m, v)


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
        update = lr_t * m / (sqrt_rn(v) + hyper["epsilon"])
        return w - update - lr * wd * w, (m, v)


@register
class AdaGrad(Optimizer):
    """AdaGrad."""

    def __init__(self, eps: float = 1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def _hyper(self):
        h = super()._hyper()
        h["eps"] = self.float_stable_eps
        return h

    def state_zeros_like(self, weight):
        return torch.zeros_like(weight)

    @staticmethod
    def _functional_step(hyper, w, g, state, lr, wd, t, rng):
        g = _prep_grad(g, hyper)
        history = state + g * g
        return (w - lr * (g / sqrt_rn(history + hyper["eps"]) + wd * w),
                history)


@register
class RMSProp(Optimizer):
    """RMSProp with Graves-style momentum terms."""

    _default_lr = 0.002

    def __init__(self, learning_rate: Optional[float] = None,
                 gamma1: float = 0.95, gamma2: float = 0.9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2

    def _hyper(self):
        h = super()._hyper()
        h.update(gamma1=self.gamma1, gamma2=self.gamma2)
        return h

    def state_zeros_like(self, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight),
                torch.zeros_like(weight))           # n, g, delta

    @staticmethod
    def _functional_step(hyper, w, g_in, state, lr, wd, t, rng):
        n, g_avg, delta = state
        g1, g2 = hyper["gamma1"], hyper["gamma2"]
        g = _prep_grad(g_in, hyper) + wd * w
        n_new = (1 - g1) * g * g + g1 * n
        g_new = (1 - g1) * g + g1 * g_avg
        d = g2 * delta - lr * g / sqrt_rn(n_new - g_new * g_new + 1e-4)
        return w + d, (n_new, g_new, d)


@register
class AdaDelta(Optimizer):
    """AdaDelta (the learning rate is not used)."""

    def __init__(self, rho: float = 0.90, epsilon: float = 1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def _hyper(self):
        h = super()._hyper()
        h.update(rho=self.rho, epsilon=self.epsilon)
        return h

    def state_zeros_like(self, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @staticmethod
    def _functional_step(hyper, w, g, state, lr, wd, t, rng):
        rho, eps = hyper["rho"], hyper["epsilon"]
        g = _prep_grad(g, hyper)
        acc_g, acc_delta = state
        ag = rho * acc_g + (1.0 - rho) * g * g
        current_delta = (sqrt_rn(acc_delta + eps) / sqrt_rn(ag + eps)) * g
        ad = rho * acc_delta + (1.0 - rho) * current_delta * current_delta
        return w - current_delta - wd * w, (ag, ad)


@register
class Test(Optimizer):
    """The reference's test optimizer: ``w += g * rescale_grad``, the new
    weight kept as its state."""

    def state_zeros_like(self, weight):
        return torch.zeros_like(weight)

    @staticmethod
    def _functional_step(hyper, w, g, state, lr, wd, t, rng):
        new_w = w + g * hyper["rescale_grad"]
        return new_w, new_w


def create(name: str, rescale_grad: Optional[float] = None,
           **kwargs) -> Optimizer:
    """Create an optimizer by registered name."""
    try:
        klass = OPTIMIZER_REGISTRY.get(name)
    except KeyError as e:
        raise MXNetError(str(e)) from e
    return klass(rescale_grad=rescale_grad, **kwargs)
