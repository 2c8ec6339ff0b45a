"""Single-pass fused optimizer update over flat gradient buckets (K2).

Counterpart of ``mxnet_tpu/ops/fused_update.py``.  The unfused step runs
the combined multiplier, rescale, clip, the optimizer math and the guard's
gating as separate eager ops, each a pass over the same bytes; the fused
update does all of it in ONE pass per flat bucket::

    (g, w, *state[, wd_vec], *kind_scalars[, mult][, ok])
        -> (new_w, *new_state), written in place into w and state

:func:`fused_update` launches the kernel of ``csrc/fused_update.cu`` on
CUDA tensors (and counts the launch in ``fused_update.launches``) and runs
the plain version :func:`reference_update` on CPU tensors, copying its
result into ``w`` and ``state`` so both routes update in place.  The plain
version repeats ``optimizer._functional_step`` op for op (the JAX
package's ``_reference``), and the kernel repeats that order with
round-to-nearest intrinsics, so fused and unfused updates agree bitwise.

:class:`FusedPlan`/:func:`build_plan` give the bucket layout: parameters
in reversed order, cut into buckets of ``bucket_bytes`` by
``plan_buckets``.  The buckets tile the concatenation of the parameters,
so the trainer keeps weights and state in one flat buffer each, whose
slices are the buckets and whose views are the parameters.

Opt-out knob: ``MXNET_TPU_FUSED_UPDATE=0``, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..base import MXNetError

__all__ = ["fused_update", "reference_update", "FusedPlan", "build_plan",
           "fused_kind", "fused_enabled", "SUPPORTED_KINDS"]

SUPPORTED_KINDS = ("sgd", "sgd_momentum", "adam", "adamw")

# number of state operands / scalar operands per optimizer kind
_N_STATE = {"sgd": 0, "sgd_momentum": 1, "adam": 2, "adamw": 2}
_N_SCALARS = {"sgd": 1, "sgd_momentum": 1, "adam": 1, "adamw": 2}
_KIND_CODES = {k: i for i, k in enumerate(SUPPORTED_KINDS)}


def fused_enabled() -> bool:
    """The MXNET_TPU_FUSED_UPDATE opt-out knob (default: on)."""
    return os.environ.get("MXNET_TPU_FUSED_UPDATE", "1") != "0"


def _check(g, w, state, scalars, kind, mult, ok, wd_vec):
    if kind not in SUPPORTED_KINDS:
        raise MXNetError(f"unsupported fused kind {kind!r}")
    if len(state) != _N_STATE[kind]:
        raise MXNetError(f"{kind} expects {_N_STATE[kind]} state operands, "
                         f"got {len(state)}")
    if len(scalars) != _N_SCALARS[kind]:
        raise MXNetError(f"{kind} expects {_N_SCALARS[kind]} scalar "
                         f"operands, got {len(scalars)}")
    flat = [("g", g), ("w", w)] + [(f"state[{i}]", s)
                                   for i, s in enumerate(state)]
    if wd_vec is not None:
        flat.append(("wd_vec", wd_vec))
    for name, t in flat:
        if t.dim() != 1 or t.shape != g.shape or t.dtype != torch.float32:
            raise MXNetError(f"fused_update: {name} must be a flat float32 "
                             f"bucket of {tuple(g.shape)}, got {t.dtype}"
                             f"{tuple(t.shape)}")
    smalls = [(f"scalars[{i}]", s) for i, s in enumerate(scalars)]
    if mult is not None:
        smalls.append(("mult", mult))
    for name, t in smalls:
        if t.numel() != 1 or t.dtype != torch.float32:
            raise MXNetError(f"fused_update: {name} must be a one-element "
                             f"float32 tensor, got {t.dtype}"
                             f"{tuple(t.shape)}")
    if ok is not None and (ok.numel() != 1 or ok.dtype != torch.bool):
        raise MXNetError(f"fused_update: ok must be a one-element bool "
                         f"tensor, got {ok.dtype}{tuple(ok.shape)}")
    devs = {t.device for _, t in flat + smalls}
    if ok is not None:
        devs.add(ok.device)
    if len(devs) != 1:
        raise MXNetError(f"fused_update: operands on several devices {devs}")


def reference_update(g, w, state=(), scalars=(), *, kind, mult=None,
                     ok=None, wd_vec=None, momentum=0.0, beta1=0.0,
                     beta2=0.0, epsilon=0.0, wd=0.0, rescale_grad=1.0,
                     clip_gradient=None):
    """Plain PyTorch version of the kernel: returns ``(new_w,
    *new_state)`` and leaves its inputs unchanged.  Same operation order
    as ``optimizer._functional_step`` and the JAX ``_reference``."""
    wdv = wd_vec if wd_vec is not None else wd
    if mult is not None:
        g = g * mult
    g = g * rescale_grad
    if clip_gradient is not None:
        g = torch.clamp(g, -clip_gradient, clip_gradient)

    if kind == "sgd":
        new_w = w - scalars[0] * (g + wdv * w)
        new_state = ()
    elif kind == "sgd_momentum":
        mom = momentum * state[0] - scalars[0] * (g + wdv * w)
        new_w = w + mom
        new_state = (mom,)
    elif kind == "adam":
        lr_t = scalars[0]
        mean, variance = state
        g = g + wdv * w
        m = beta1 * mean + (1.0 - beta1) * g
        v = beta2 * variance + (1.0 - beta2) * g * g
        new_w = w - lr_t * m / (torch.sqrt(v) + epsilon)
        new_state = (m, v)
    elif kind == "adamw":
        lr_t, lrwd = scalars
        if wd_vec is not None:
            lrwd = lrwd * wd_vec
        mean, variance = state
        m = beta1 * mean + (1.0 - beta1) * g
        v = beta2 * variance + (1.0 - beta2) * g * g
        update = lr_t * m / (torch.sqrt(v) + epsilon)
        new_w = w - update - lrwd * w
        new_state = (m, v)
    else:
        raise MXNetError(f"unsupported fused kind {kind!r}")

    if ok is not None:
        new_w = torch.where(ok, new_w, w)
        new_state = tuple(torch.where(ok, ns, s)
                          for ns, s in zip(new_state, state))
    return (new_w, *new_state)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_update")
    if not getattr(lib, "_mxt_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mxt_fused_update.argtypes = [
            ci, ctypes.c_int64, vp, vp, vp, vp, vp, vp, vp, vp, vp,
            cf, cf, cf, cf, cf, cf, cf, cf, ci, cf, vp]
        lib.mxt_fused_update.restype = ci
        lib.mxt_error_string.argtypes = [ci]
        lib.mxt_error_string.restype = ctypes.c_char_p
        lib._mxt_typed = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_update(g, w, state=(), scalars=(), *, kind, mult=None, ok=None,
                 wd_vec=None, momentum=0.0, beta1=0.0, beta2=0.0,
                 epsilon=0.0, wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """One fused update over a flat float32 bucket, in place on ``w`` and
    ``state``; returns ``(w, *state)``.

    ``scalars`` is the kind's learning-rate chain as one-element float32
    tensors on the bucket's device: ``(lr_eff,)`` for sgd/sgd_momentum,
    ``(lr_t,)`` for adam, ``(lr_t, lr_eff * wd)`` for adamw, or ``(lr_t,
    lr_eff)`` for adamw with ``wd_vec`` (the kernel forms ``lr_eff *
    wd_vec``).  ``mult`` (float32) multiplies the gradient first; ``ok``
    (bool) false makes the whole update a bitwise no-op.  ``wd_vec`` is
    the per-element weight decay, in place of the scalar ``wd``.

    CPU tensors go to :func:`reference_update`.  CUDA tensors launch the
    kernel (and count the launch) or raise.
    """
    state = tuple(state)
    scalars = tuple(scalars)
    _check(g, w, state, scalars, kind, mult, ok, wd_vec)
    hyper = dict(momentum=momentum, beta1=beta1, beta2=beta2,
                 epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
                 clip_gradient=clip_gradient)
    if g.device.type == "cpu":
        res = reference_update(g, w, state, scalars, kind=kind, mult=mult,
                               ok=ok, wd_vec=wd_vec, **hyper)
        with torch.no_grad():
            for dst, src in zip((w,) + state, res):
                dst.copy_(src)
        return (w, *state)
    if g.device.type != "cuda":
        raise MXNetError(f"fused_update: unsupported device {g.device}")
    for t in (g, w, wd_vec) + state:
        if t is not None and not t.is_contiguous():
            raise MXNetError("fused_update: buckets must be contiguous")
    s0 = state[0] if len(state) > 0 else None
    s1 = state[1] if len(state) > 1 else None
    sc1 = scalars[1] if len(scalars) > 1 else None
    lib = _lib()
    with torch.cuda.device(g.device):
        rc = lib.mxt_fused_update(
            _KIND_CODES[kind], g.numel(), g.data_ptr(), w.data_ptr(),
            _ptr(s0), _ptr(s1), _ptr(wd_vec), scalars[0].data_ptr(),
            _ptr(sc1), _ptr(mult), _ptr(ok), momentum, beta1, beta2,
            1.0 - beta1, 1.0 - beta2, epsilon, wd, rescale_grad,
            int(clip_gradient is not None),
            0.0 if clip_gradient is None else clip_gradient,
            torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise MXNetError(f"fused_update kernel launch failed: CUDA error "
                         f"{rc} ({lib.mxt_error_string(rc).decode()})")
    fused_update.launches += 1
    return (w, *state)


fused_update.launches = 0


# ----------------------------------------------------------------------
# optimizer-kind detection
# ----------------------------------------------------------------------

def fused_kind(opt) -> Optional[str]:
    """Map an optimizer instance to a fused kind, or None if its update
    rule has no fused twin (detected by the identity of the class's
    ``_functional_step``, so subclasses that override it fall back)."""
    from ..optimizer import SGD, Adam, AdamW
    if type(opt)._needs_rng:
        return None
    step = type(opt)._functional_step
    if step is SGD._functional_step:
        return "sgd_momentum" if getattr(opt, "momentum", 0.0) else "sgd"
    if step is AdamW._functional_step:
        return "adamw"
    if step is Adam._functional_step:
        return "adam"
    return None


# ----------------------------------------------------------------------
# flat bucket plan
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class FusedPlan:
    """Bucket-aligned layout for params, grads and optimizer state: the
    JAX package's plan (reversed parameter order, greedy ``plan_buckets``
    fill).  The JAX package gathers each bucket from the parameters and
    scatters it back; here the buckets are slices of flat buffers whose
    views are the parameters (``offsets``), so neither is needed."""
    order: Tuple[str, ...]                       # reversed param order
    shapes: Dict[str, Tuple[int, ...]] = field(hash=False)
    # per bucket: ((name, start_elem, stop_elem), ...)
    buckets: Tuple[Tuple[Tuple[str, int, int], ...], ...] = ()

    @property
    def bucket_sizes(self) -> Tuple[int, ...]:
        return tuple(sum(s1 - s0 for _, s0, s1 in b) for b in self.buckets)

    @property
    def offsets(self) -> Dict[str, int]:
        """Start of each parameter in the concatenation of the buckets."""
        out, off = {}, 0
        for n in self.order:
            out[n] = off
            off += int(np.prod(self.shapes[n]))
        return out


def build_plan(param_names: Sequence[str],
               shapes: Dict[str, Tuple[int, ...]],
               bucket_bytes: int) -> FusedPlan:
    """The JAX package's bucket layout: reversed priority order, greedy
    byte-budget fill, f32 params."""
    from ..parallel.collectives import plan_buckets
    order = [n for n in reversed(list(param_names))
             if int(np.prod(shapes[n])) > 0]
    counts = [int(np.prod(shapes[n])) for n in order]
    raw = plan_buckets(counts, 4, bucket_bytes)
    buckets = tuple(
        tuple((order[idx], s0, s1) for idx, s0, s1 in bucket)
        for bucket in raw)
    return FusedPlan(order=tuple(order),
                     shapes={n: tuple(shapes[n]) for n in order},
                     buckets=buckets)
