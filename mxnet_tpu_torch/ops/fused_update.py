"""Single-pass fused optimizer update (K2).

Counterpart of ``mxnet_tpu/ops/fused_update.py``.  The unfused step runs
the combined multiplier, rescale, clip, the optimizer math and the guard's
gating as separate eager ops, each a pass over the same bytes; the fused
update does all of it in ONE pass::

    (g, w, *state[, wd_vec], *kind_scalars[, mult][, ok])
        -> (new_w, *new_state), written in place into w and state

The kernel (``csrc/fused_update.cu``) has two forms, picked by
:func:`kernel_form`:

* ``"hopper"``: :func:`fused_update_params` takes every parameter's
  gradient where autograd left it and updates the matching slices of the
  flat weight and state buffers, one launch per step (per
  ``TABLE_TENSORS`` gradients) over a :class:`ChunkPlan` built once per
  layout, with 16-byte accesses;
* ``"bucket"``: the first port, one launch per flat gradient bucket.

:func:`fused_update` is the JAX package's per-bucket API; it runs either
form (the hopper form over a list of one tensor).  Both count launches in
``fused_update.launches`` and ``fused_update.launches_by_form``.  On CPU
tensors both run the plain version :func:`reference_update` and copy its
result into ``w`` and ``state``, so every route updates in place.  The
plain version repeats ``optimizer._functional_step`` op for op (the JAX
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
import functools
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..analysis import program as _program
from ..base import MXNetError
from ..optimizer import sqrt_rn

__all__ = ["fused_update", "fused_update_params", "reference_update",
           "kernel_form", "ChunkPlan", "plan_chunks", "FusedPlan",
           "build_plan", "fused_kind", "fused_enabled", "SUPPORTED_KINDS",
           "KERNEL_FORMS", "TABLE_TENSORS", "CHUNK_ELEMS"]

SUPPORTED_KINDS = ("sgd", "sgd_momentum", "adam", "adamw")

# number of state operands / scalar operands per optimizer kind
_N_STATE = {"sgd": 0, "sgd_momentum": 1, "adam": 2, "adamw": 2}
_N_SCALARS = {"sgd": 1, "sgd_momentum": 1, "adam": 1, "adamw": 2}
_KIND_CODES = {k: i for i, k in enumerate(SUPPORTED_KINDS)}

# the kernel's forms, the main path's first
KERNEL_FORMS = ("hopper", "bucket")
# gradients one hopper launch takes (the kernel's kTableTensors)
TABLE_TENSORS = 256
# elements per work item of the hopper form's chunk plan: one step of a
# 256-thread block at two float4s a thread
CHUNK_ELEMS = 2048


def fused_enabled() -> bool:
    """The MXNET_TPU_FUSED_UPDATE opt-out knob (default: on)."""
    return os.environ.get("MXNET_TPU_FUSED_UPDATE", "1") != "0"


def _check_kind(kind, state, scalars):
    if kind not in SUPPORTED_KINDS:
        raise MXNetError(f"unsupported fused kind {kind!r}")
    if len(state) != _N_STATE[kind]:
        raise MXNetError(f"{kind} expects {_N_STATE[kind]} state operands, "
                         f"got {len(state)}")
    if len(scalars) != _N_SCALARS[kind]:
        raise MXNetError(f"{kind} expects {_N_SCALARS[kind]} scalar "
                         f"operands, got {len(scalars)}")


def _check_flat(flat, shape, what):
    for name, t in flat:
        if t.dim() != 1 or t.shape != shape or t.dtype != torch.float32:
            raise MXNetError(f"fused_update: {name} must be a flat float32 "
                             f"{what} of {tuple(shape)}, got {t.dtype}"
                             f"{tuple(t.shape)}")


def _check_smalls(flat, scalars, mult, ok):
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


def _flat_operands(w, state, wd_vec, first=()):
    flat = list(first) + [("w", w)] + [(f"state[{i}]", s)
                                       for i, s in enumerate(state)]
    if wd_vec is not None:
        flat.append(("wd_vec", wd_vec))
    return flat


def _check(g, w, state, scalars, kind, mult, ok, wd_vec):
    _check_kind(kind, state, scalars)
    flat = _flat_operands(w, state, wd_vec, first=[("g", g)])
    _check_flat(flat, g.shape, "bucket")
    _check_smalls(flat, scalars, mult, ok)


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
        new_w = w - lr_t * m / (sqrt_rn(v) + epsilon)
        new_state = (m, v)
    elif kind == "adamw":
        lr_t, lrwd = scalars
        if wd_vec is not None:
            lrwd = lrwd * wd_vec
        mean, variance = state
        m = beta1 * mean + (1.0 - beta1) * g
        v = beta2 * variance + (1.0 - beta2) * g * g
        update = lr_t * m / (sqrt_rn(v) + epsilon)
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
        hyper = [cf, cf, cf, cf, cf, cf, cf, cf, ci, cf, vp]
        lib.mxt_fused_update.argtypes = [
            ci, ctypes.c_int64, vp, vp, vp, vp, vp, vp, vp, vp, vp] + hyper
        lib.mxt_fused_update.restype = ci
        lib.mxt_fused_update_params.argtypes = [
            ci, ci, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp] + hyper
        lib.mxt_fused_update_params.restype = ci
        lib.mxt_fused_update_table_tensors.restype = ci
        lib.mxt_error_string.argtypes = [ci]
        lib.mxt_error_string.restype = ctypes.c_char_p
        if lib.mxt_fused_update_table_tensors() != TABLE_TENSORS:
            raise MXNetError("fused_update: the kernel's table size "
                             f"{lib.mxt_fused_update_table_tensors()} is not "
                             f"TABLE_TENSORS {TABLE_TENSORS}")
        lib._mxt_typed = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_launch(lib, rc, form):
    raise MXNetError(f"fused_update kernel launch failed ({form} form): "
                     f"CUDA error {rc} ({lib.mxt_error_string(rc).decode()})")


def _hyper_args(momentum, beta1, beta2, epsilon, wd, rescale_grad,
                clip_gradient, stream):
    return (momentum, beta1, beta2, 1.0 - beta1, 1.0 - beta2, epsilon, wd,
            rescale_grad, int(clip_gradient is not None),
            0.0 if clip_gradient is None else clip_gradient, stream)


def kernel_form(*tensors) -> str:
    """The kernel form for these operands (``None`` entries ignored):
    ``"hopper"`` when every one is float32 and contiguous, else
    ``"bucket"`` (whose wrapper names what it refuses).  16-byte
    alignment is decided per chunk inside the hopper kernel, so it does
    not choose the form.  On the CPU the form names the route; the plain
    version runs in both."""
    if all(t.dtype == torch.float32 and t.is_contiguous()
           for t in tensors if t is not None):
        return "hopper"
    return "bucket"


def _resolve_form(form, *tensors) -> str:
    if form is None:
        return kernel_form(*tensors)
    if form not in KERNEL_FORMS:
        raise MXNetError(f"fused_update: unknown form {form!r} (forms: "
                         f"{list(KERNEL_FORMS)})")
    return form


@_program.kernel_region
def fused_update(g, w, state=(), scalars=(), *, kind, mult=None, ok=None,
                 wd_vec=None, momentum=0.0, beta1=0.0, beta2=0.0,
                 epsilon=0.0, wd=0.0, rescale_grad=1.0, clip_gradient=None,
                 form=None):
    """One fused update over a flat float32 bucket, in place on ``w`` and
    ``state``; returns ``(w, *state)``.

    ``scalars`` is the kind's learning-rate chain as one-element float32
    tensors on the bucket's device: ``(lr_eff,)`` for sgd/sgd_momentum,
    ``(lr_t,)`` for adam, ``(lr_t, lr_eff * wd)`` for adamw, or ``(lr_t,
    lr_eff)`` for adamw with ``wd_vec`` (the kernel forms ``lr_eff *
    wd_vec``).  ``mult`` (float32) multiplies the gradient first; ``ok``
    (bool) false makes the whole update a bitwise no-op.  ``wd_vec`` is
    the per-element weight decay, in place of the scalar ``wd``.
    ``form`` (default :func:`kernel_form`'s) picks the kernel: the hopper
    form runs as :func:`fused_update_params` over ``[g]``.

    CPU tensors go to :func:`reference_update`.  CUDA tensors launch the
    kernel (and count the launch) or raise; nothing falls back.
    """
    state = tuple(state)
    scalars = tuple(scalars)
    _check(g, w, state, scalars, kind, mult, ok, wd_vec)
    form = _resolve_form(form, g, w, wd_vec, *state)
    hyper = dict(momentum=momentum, beta1=beta1, beta2=beta2,
                 epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
                 clip_gradient=clip_gradient)
    if g.device.type == "cpu":
        _program.note_kernel("fused_update", reads=(g,), writes=(w,) + state)
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
    if form == "hopper":
        fused_update_params([g], w, state, _bucket_plan(g.numel()), scalars,
                            kind=kind, mult=mult, ok=ok, wd_vec=wd_vec,
                            **hyper)
        return (w, *state)
    s0 = state[0] if len(state) > 0 else None
    s1 = state[1] if len(state) > 1 else None
    sc1 = scalars[1] if len(scalars) > 1 else None
    lib = _lib()
    with torch.cuda.device(g.device):
        rc = lib.mxt_fused_update(
            _KIND_CODES[kind], g.numel(), g.data_ptr(), w.data_ptr(),
            _ptr(s0), _ptr(s1), _ptr(wd_vec), scalars[0].data_ptr(),
            _ptr(sc1), _ptr(mult), _ptr(ok),
            *_hyper_args(momentum, beta1, beta2, epsilon, wd, rescale_grad,
                         clip_gradient,
                         torch.cuda.current_stream(g.device).cuda_stream))
    if rc != 0:
        _raise_launch(lib, rc, form)
    _program.note_kernel("fused_update", reads=(g,), writes=(w,) + state)
    fused_update.launches += 1
    fused_update.launches_by_form[form] += 1
    return (w, *state)


fused_update.launches = 0
fused_update.launches_by_form = dict.fromkeys(KERNEL_FORMS, 0)


# ----------------------------------------------------------------------
# the hopper form: every parameter's gradient in place, one launch a step
# ----------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class ChunkPlan:
    """The hopper form's work list for one flat layout, built once.

    ``offsets``/``sizes``: each tensor's start and length in the flat
    buffers.  ``chunks``: int32 ``[n, 4]`` rows ``(tensor index within its
    table, start within the tensor, length, flat offset on the 16-byte
    grid)``, at most :data:`CHUNK_ELEMS` elements each, never crossing a
    tensor.  ``tables``: ``(first tensor, stop tensor, first chunk, stop
    chunk)`` per launch of at most :data:`TABLE_TENSORS` tensors."""
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    chunks: np.ndarray = field(repr=False)
    tables: Tuple[Tuple[int, int, int, int], ...]
    extent: int                     # elements the flat buffers must hold
    _cache: dict = field(default_factory=dict, repr=False)

    def device_chunks(self, device) -> torch.Tensor:
        """``chunks`` on ``device``, copied once."""
        key = ("chunks", str(device))
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(self.chunks).to(device)
        return self._cache[key]

    def host_arrays(self, table: int):
        """The ctypes int64 arrays of one table's offsets and lengths."""
        key = ("host", table)
        if key not in self._cache:
            t0, t1 = self.tables[table][:2]
            arr = ctypes.c_int64 * (t1 - t0)
            self._cache[key] = (arr(*self.offsets[t0:t1]),
                                arr(*self.sizes[t0:t1]))
        return self._cache[key]


def plan_chunks(offsets: Sequence[int], sizes: Sequence[int], *,
                chunk: int = CHUNK_ELEMS,
                table: int = TABLE_TENSORS) -> ChunkPlan:
    """The :class:`ChunkPlan` of tensors of ``sizes`` elements at flat
    ``offsets``: each tensor cut from its start into chunks of ``chunk``
    elements (a multiple of 4, so a tensor whose flat offset is on the
    16-byte grid keeps every chunk there), tensors grouped into tables of
    ``table``.  Raises on an empty or overlapping tensor, a negative
    offset, or a tensor of 2**31 elements or more."""
    offsets = tuple(int(o) for o in offsets)
    sizes = tuple(int(n) for n in sizes)
    if len(offsets) != len(sizes) or not sizes:
        raise MXNetError(f"plan_chunks: {len(offsets)} offsets for "
                         f"{len(sizes)} sizes")
    if chunk < 4 or chunk % 4 or not 1 <= table <= TABLE_TENSORS:
        raise MXNetError(f"plan_chunks: chunk {chunk} must be a positive "
                         f"multiple of 4, table {table} in 1.."
                         f"{TABLE_TENSORS}")
    for o, n in zip(offsets, sizes):
        if o < 0 or n < 1 or n >= 1 << 31:
            raise MXNetError(f"plan_chunks: tensor of {n} elements at "
                             f"offset {o}")
    spans = sorted(zip(offsets, sizes))
    for (o0, n0), (o1, _) in zip(spans, spans[1:]):
        if o0 + n0 > o1:
            raise MXNetError(f"plan_chunks: tensors at {o0} ({n0} elements) "
                             f"and {o1} overlap")
    rows, tables = [], []
    for t0 in range(0, len(sizes), table):
        t1 = min(t0 + table, len(sizes))
        c0 = len(rows)
        for i in range(t0, t1):
            aligned = int(offsets[i] % 4 == 0)
            for start in range(0, sizes[i], chunk):
                rows.append((i - t0, start, min(chunk, sizes[i] - start),
                             aligned))
        tables.append((t0, t1, c0, len(rows)))
    return ChunkPlan(offsets=offsets, sizes=sizes,
                     chunks=np.asarray(rows, np.int32).reshape(-1, 4),
                     tables=tuple(tables),
                     extent=max(o + n for o, n in zip(offsets, sizes)))


@functools.lru_cache(maxsize=64)
def _bucket_plan(n: int) -> ChunkPlan:
    return plan_chunks((0,), (n,))


def _check_grads(grads, plan: ChunkPlan, w_flat) -> None:
    if len(grads) != len(plan.sizes):
        raise MXNetError(f"fused_update_params: the plan has "
                         f"{len(plan.sizes)} tensors, got {len(grads)} "
                         f"gradients")
    dev = w_flat.device
    for i, (g, n) in enumerate(zip(grads, plan.sizes)):
        if (g.dtype != torch.float32 or not g.is_contiguous()
                or g.numel() != n or g.device != dev):
            raise MXNetError(
                f"fused_update_params: gradient {i} must be a contiguous "
                f"float32 tensor of {n} elements on {dev}, got "
                f"{'' if g.is_contiguous() else 'non-contiguous '}"
                f"{g.dtype}{tuple(g.shape)} on {g.device}")
    if plan.extent > w_flat.numel():
        raise MXNetError(f"fused_update_params: the plan reaches element "
                         f"{plan.extent}, past the flat buffers' "
                         f"{w_flat.numel()}")


@_program.kernel_region
def fused_update_params(grads, w_flat, state_flat=(), offsets=(),
                        scalars=(), *, kind, mult=None, ok=None,
                        wd_vec=None, momentum=0.0, beta1=0.0, beta2=0.0,
                        epsilon=0.0, wd=0.0, rescale_grad=1.0,
                        clip_gradient=None):
    """The fused update over a list of per-parameter gradients, in place
    on the flat ``w_flat`` and ``state_flat`` buffers: gradient ``i``
    (contiguous float32) updates the slice ``[offsets[i], offsets[i] +
    numel)`` of ``w_flat``, of each state buffer and of ``wd_vec``.  The
    result is :func:`fused_update` over the concatenation of the
    gradients, bit for bit; the other arguments are its.  ``offsets`` is
    a sequence of ints or the :class:`ChunkPlan` built from them once
    (:func:`plan_chunks`).

    CUDA tensors launch the hopper form once per table of
    :data:`TABLE_TENSORS` gradients (each launch counted) or raise; CPU
    tensors run :func:`reference_update` per gradient into the flat
    slices.  Returns ``(w_flat, *state_flat)``."""
    state = tuple(state_flat)
    scalars = tuple(scalars)
    grads = list(grads)
    plan = (offsets if isinstance(offsets, ChunkPlan)
            else plan_chunks(offsets, [g.numel() for g in grads]))
    _check_kind(kind, state, scalars)
    flat = _flat_operands(w_flat, state, wd_vec)
    _check_flat(flat, w_flat.shape, "buffer")
    _check_smalls(flat, scalars, mult, ok)
    _check_grads(grads, plan, w_flat)
    hyper = dict(momentum=momentum, beta1=beta1, beta2=beta2,
                 epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
                 clip_gradient=clip_gradient)
    dev = w_flat.device
    if dev.type == "cpu":
        for t0, t1, _, _ in plan.tables:     # the launches the card makes
            _program.note_kernel("fused_update", reads=grads[t0:t1],
                                 writes=(w_flat,) + state)
        with torch.no_grad():
            for g, o, n in zip(grads, plan.offsets, plan.sizes):
                sl = slice(o, o + n)
                dst = (w_flat[sl],) + tuple(s[sl] for s in state)
                res = reference_update(
                    g.reshape(-1), dst[0], dst[1:], scalars, kind=kind,
                    mult=mult, ok=ok,
                    wd_vec=None if wd_vec is None else wd_vec[sl], **hyper)
                for d, r in zip(dst, res):
                    d.copy_(r)
        return (w_flat, *state)
    if dev.type != "cuda":
        raise MXNetError(f"fused_update_params: unsupported device {dev}")
    s0 = state[0] if len(state) > 0 else None
    s1 = state[1] if len(state) > 1 else None
    sc1 = scalars[1] if len(scalars) > 1 else None
    chunks = plan.device_chunks(dev)
    lib = _lib()
    with torch.cuda.device(dev):
        tail = _hyper_args(momentum, beta1, beta2, epsilon, wd,
                           rescale_grad, clip_gradient,
                           torch.cuda.current_stream(dev).cuda_stream)
        for ti, (t0, t1, c0, c1) in enumerate(plan.tables):
            ptrs = (ctypes.c_uint64 * (t1 - t0))(
                *[g.data_ptr() for g in grads[t0:t1]])
            offs, lens = plan.host_arrays(ti)
            rc = lib.mxt_fused_update_params(
                _KIND_CODES[kind], t1 - t0, ctypes.addressof(ptrs),
                ctypes.addressof(offs), ctypes.addressof(lens),
                chunks.data_ptr() + c0 * chunks.stride(0) * 4, c1 - c0,
                w_flat.data_ptr(), _ptr(s0), _ptr(s1), _ptr(wd_vec),
                scalars[0].data_ptr(), _ptr(sc1), _ptr(mult), _ptr(ok),
                *tail)
            if rc != 0:
                _raise_launch(lib, rc, "hopper")
            _program.note_kernel("fused_update", reads=grads[t0:t1],
                                 writes=(w_flat,) + state)
            fused_update.launches += 1
            fused_update.launches_by_form["hopper"] += 1
    return (w_flat, *state)


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
