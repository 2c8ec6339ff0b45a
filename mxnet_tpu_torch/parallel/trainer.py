"""ShardedTrainer on one device: eager autograd plus the fused update (K2).

Counterpart of ``mxnet_tpu/parallel/trainer.py`` for one device.  The JAX
trainer compiles one program per step; here each step runs eagerly:

1. ``eval_symbol`` runs the forward in training mode over parameters that
   are autograd leaves;
2. the heads are back-propagated with a ones cotangent (the JAX
   ``_grads_and_heads``: loss heads define their own backward);
3. the update follows the JAX ``train_step`` line for line: under the
   guard, ``sq = tree_sq_sum(grads)``, ``ok = isfinite(sq)``, the
   effective norm ``sqrt(sq) * |rescale_grad|`` and the clip multiplier
   ``mult = min(1, clip / max(norm, 1e-12))``; then either the fused
   update (``ops/fused_update.py``: in its hopper form one kernel launch
   a step over the gradients where autograd left them, in its bucket
   form a gather into one flat gradient and a launch per bucket), or the
   unfused per-parameter
   ``optimizer._functional_step`` gated by ``where(ok, new, old)``; aux
   states (BatchNorm moving statistics) keep their old values on a bad
   step.

With ``compute_dtype`` (the JAX trainer's AMP lever) every float32
parameter is cast to that type at the forward's edge, so activations and
matrix products run in it; the batch is not cast, norm statistics and
loss heads stay f32 (the ops see to that), and autograd carries the
gradients back through the cast to the f32 master parameters, so the
flat buffers and the update are unchanged.

The fused layout keeps each of the weights, the optimizer state and the
per-element weight decay in ONE flat float32 buffer, in the bucket plan's
order: each bucket is a slice of it and each parameter a view, so the
kernel updates the parameters in place and nothing is scattered back.
The hopper form reads each gradient where autograd left it, through a
chunk plan over those views built once, at bind; the bucket form
gathers the gradients into one flat buffer with ``torch.cat``.  All
step scalars (learning rate, update count, ``ok``, ``mult``) stay on the
card as 0-d tensors: a step never waits for the host.

Not ported yet (they raise): ``mesh``, ``rules``, ``data_axis``,
``matmul_precision``, ``shard_optimizer``, ``grad_accum > 1``,
``grad_compression``, ``error_feedback``, ``loss_scale``, checkpoints
(``save_state``/``restore_state``) and ``fit``.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import optimizer as opt_mod
from .. import resilience
from ..base import MXNetError, not_ported
from ..context import cpu, resolve_device
from ..graph_eval import eval_symbol
from ..initializer import Uniform
from ..ndarray import NDArray, array as nd_array, zeros as nd_zeros
from ..ops import fused_update as fu
from .collectives import DEFAULT_BUCKET_BYTES

__all__ = ["ShardedTrainer"]


class _PlacedBatch(dict):
    """A batch already on the trainer's device (``place_batch``)."""


class ShardedTrainer:
    """Trainer for a Symbol on one device.

    Parameters
    ----------
    symbol : Symbol
        Network whose heads are loss outputs (SoftmaxOutput etc.).
    optimizer : str or Optimizer
    initializer : Initializer, optional
        Default ``Uniform(0.07)``; draws from a ``torch.Generator`` seeded
        with ``seed``.
    compute_dtype : str, optional
        Activation type (e.g. ``"bfloat16"``): float32 parameters are cast
        to it inside each forward; masters and the update stay float32.
    fused_update : bool, optional
        None = fused when eligible (``MXNET_TPU_FUSED_UPDATE=0`` opts
        out); True raises at ``bind`` when the configuration cannot fuse;
        False forces the unfused update.
    guard, clip_global_norm : the non-finite step guard and global-norm
        clipping (``resilience.py``).
    device : the card unless the caller asks for the CPU
        (``device="cpu"``); raises when CUDA is asked for and absent.
    """

    def __init__(self, symbol, optimizer="sgd", optimizer_params=None,
                 mesh=None, rules=None, data_axis: Optional[str] = None,
                 initializer=None, matmul_precision: Optional[str] = None,
                 shard_optimizer: bool = False,
                 compute_dtype: Optional[str] = None, grad_accum: int = 1,
                 grad_compression: Optional[str] = None,
                 grad_bucket_bytes: Optional[int] = None,
                 error_feedback: Optional[bool] = None,
                 fused_update: Optional[bool] = None,
                 guard: Optional[bool] = None,
                 clip_global_norm: Optional[float] = None,
                 loss_scale=None,
                 guard_params: Optional[Dict[str, Any]] = None,
                 logger=None, device=None, seed: int = 0):
        for what, val in (("mesh", mesh), ("rules", rules),
                          ("data_axis", data_axis),
                          ("matmul_precision", matmul_precision),
                          ("grad_compression", grad_compression),
                          ("error_feedback", error_feedback),
                          ("loss_scale", loss_scale)):
            if val is not None:
                raise not_ported(f"ShardedTrainer({what}=...)")
        if shard_optimizer:
            raise not_ported("ShardedTrainer(shard_optimizer=True)")
        if int(grad_accum) != 1:
            raise not_ported("ShardedTrainer(grad_accum > 1)")
        self.device = resolve_device(device)
        self.compute_dtype = _torch_dtype(compute_dtype)
        self.symbol = symbol
        self.initializer = initializer or Uniform(0.07)
        self.logger = logger or logging.getLogger(__name__)
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self.optimizer = optimizer
        self.grad_bucket_bytes = (int(grad_bucket_bytes) if grad_bucket_bytes
                                  else DEFAULT_BUCKET_BYTES)
        self._generator = torch.Generator().manual_seed(int(seed))
        self._fused_req = fused_update
        self._fused = False
        self._fused_kind: Optional[str] = None
        self._fused_plan: Optional[fu.FusedPlan] = None
        if clip_global_norm is None:
            clip_global_norm = getattr(self.optimizer, "clip_global_norm",
                                       None)
        if guard is None and getattr(self.optimizer, "skip_nonfinite",
                                     None):
            guard = True
        self._resil = resilience.resolve(guard=guard,
                                         clip_global_norm=clip_global_norm,
                                         **(guard_params or {}))
        self._guard_state: Optional[Dict[str, torch.Tensor]] = None
        self._bound = False

    # ------------------------------------------------------------------
    # Bind: infer shapes, initialize and place params, lay out the state
    # ------------------------------------------------------------------

    def bind(self, data_shapes: Dict[str, Tuple[int, ...]],
             label_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
             arg_params: Optional[Dict[str, Any]] = None,
             aux_params: Optional[Dict[str, Any]] = None
             ) -> "ShardedTrainer":
        """Infer shapes and lay out parameters, aux states and optimizer
        state on the device.  ``arg_params``/``aux_params`` (numpy arrays,
        tensors or NDArrays keyed by the JAX package's names) are copied
        in; the rest is drawn by the initializer."""
        sym = self.symbol
        input_shapes = dict(data_shapes)
        input_shapes.update(label_shapes or {})
        arg_names = sym.list_arguments()
        self._input_names = [n for n in arg_names if n in input_shapes]
        self._label_names = [n for n in arg_names
                             if n in (label_shapes or {})]
        self._param_names = [n for n in arg_names if n not in input_shapes]
        self._aux_names = sym.list_auxiliary_states()
        arg_shapes, _, aux_shapes = sym.infer_shape(**input_shapes)
        shape_of = dict(zip(arg_names, arg_shapes))
        self._input_shapes = {n: tuple(input_shapes[n])
                              for n in self._input_names}
        self._topo = sym._topo()

        def host_value(name, shape, given):
            nd = nd_zeros(shape, ctx=cpu())
            if given is not None and name in given:
                src = given[name]
                nd[:] = src.data if isinstance(src, NDArray) else src
            else:
                self.initializer(name, nd, generator=self._generator)
            return nd.data

        host = {n: host_value(n, shape_of[n], arg_params)
                for n in self._param_names}
        self._aux = {n: host_value(n, s, aux_params).to(self.device)
                     for n, s in zip(self._aux_names, aux_shapes)}

        opt = self.optimizer
        if opt._rescale_set:
            self._rescale_grad = opt.rescale_grad
        else:
            # per-sample loss-head gradients sum into the weight grads:
            # rescale by 1/global batch, as the JAX trainer does
            self._rescale_grad = 1.0 / float(
                next(iter(data_shapes.values()))[0])
        self._num_update = opt.begin_num_update
        self._lr_mult = {n: opt.lr_mult.get(n, 1.0)
                         for n in self._param_names}
        self._wd_mult = {}
        for n in self._param_names:
            if n in opt.wd_mult:
                self._wd_mult[n] = opt.wd_mult[n]
            elif n.endswith(("_gamma", "_beta", "_bias")):
                self._wd_mult[n] = 0.0
            else:
                self._wd_mult[n] = 1.0
        self._setup_fused(shape_of)
        if self._fused:
            self._layout_fused(host)
        else:
            self._params = {n: host[n].to(self.device).requires_grad_(True)
                            for n in self._param_names}
            self._opt_state = {
                n: opt.state_zeros_like(self._params[n].detach())
                for n in self._param_names}
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        # step scalars, refilled in place each step (a fill launches a
        # kernel; it never copies from the host or waits for the card)
        self._lr_dev = torch.zeros((), **f32)
        self._t_dev = torch.zeros((), **f32)
        self._c_one = torch.ones((), **f32)
        self._c_tiny = torch.full((), 1e-12, **f32)
        if self._resil is not None:
            self._guard_state = resilience.init_state(dev)
            clip = self._resil.clip_global_norm
            self._c_clip = (None if clip is None
                            else torch.full((), clip, **f32))
        self._bound = True
        return self

    def _setup_fused(self, shape_of) -> None:
        """The JAX trainer's eligibility gate: any configuration the
        kernel cannot express bitwise falls back to the unfused update,
        unless ``fused_update=True`` made ineligibility an error."""
        self._fused = False
        self._fused_kind = None
        self._fused_plan = None
        req = self._fused_req
        if req is False or (req is None and not fu.fused_enabled()):
            return
        kind = fu.fused_kind(self.optimizer)
        why = []
        if not self._param_names:
            why.append("no parameters")
        if kind is None:
            why.append(f"optimizer {type(self.optimizer).__name__} has no "
                       "fused twin")
        if any(int(np.prod(shape_of[n], dtype=np.int64)) == 0
               for n in self._param_names):
            why.append("zero-size params")
        if len({float(v) for v in self._lr_mult.values()}) > 1:
            why.append("per-param lr_mult")
        # per-param effective wd (gamma/beta/bias exclusion) rides a
        # per-element wd vector into the kernel
        self._fused_wd_uniform = len(
            {float(self.optimizer.wd * v)
             for v in self._wd_mult.values()}) <= 1
        if kind == "adam" and any(
                float(self.optimizer.wd * v) != 0.0
                for v in self._wd_mult.values()):
            # as in the JAX package: adam folds wd into the gradient and
            # that fold feeds both moments; no bitwise fused twin is
            # promised there (use adamw)
            why.append("adam with weight decay (folded wd has no bitwise "
                       "fused twin; use adamw)")
        if why:
            if req:
                raise MXNetError("fused_update=True but this configuration "
                                 "cannot fuse: " + "; ".join(why))
            self.logger.debug("fused update off: %s", "; ".join(why))
            return
        self._fused_kind = kind
        self._fused_plan = fu.build_plan(self._param_names, shape_of,
                                         self.grad_bucket_bytes)
        self._fused = True

    def _layout_fused(self, host: Dict[str, torch.Tensor]) -> None:
        plan = self._fused_plan
        opt = self.optimizer
        offs = plan.offsets
        total = sum(plan.bucket_sizes)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._flat_w = torch.empty(total, **f32)
        self._params = {}
        for n in plan.order:
            size = int(np.prod(plan.shapes[n]))
            view = self._flat_w[offs[n]:offs[n] + size]
            view.copy_(host[n].reshape(-1))
            self._params[n] = view.view(plan.shapes[n]).requires_grad_(True)
        # keep the symbol's argument order for the dict
        self._params = {n: self._params[n] for n in self._param_names}
        bounds, off = [], 0
        for size in plan.bucket_sizes:
            bounds.append((off, off + size))
            off += size
        self._bucket_bounds = bounds
        self._chunk_plan = fu.plan_chunks(
            [offs[n] for n in plan.order],
            [int(np.prod(plan.shapes[n])) for n in plan.order])
        self._flat_state = [torch.zeros(total, **f32)
                            for _ in range(fu._N_STATE[self._fused_kind])]
        self._opt_state = {}
        self._flat_wd = None
        if not self._fused_wd_uniform:
            vec = np.empty(total, np.float32)
            for n in plan.order:
                size = int(np.prod(plan.shapes[n]))
                vec[offs[n]:offs[n] + size] = np.float32(
                    opt.wd * self._wd_mult[n])
            self._flat_wd = torch.from_numpy(vec).to(self.device)
        # the kernel form of the update: "hopper" for these flat float32
        # buffers; "bucket" gathers the gradients and launches per bucket
        self._fused_route = fu.kernel_form(self._flat_w, self._flat_wd,
                                           *self._flat_state)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def place_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Copy a batch (dict, DataBatch or list aligned with the input
        names; numpy arrays, tensors or NDArrays) onto the device once;
        passing the result to :meth:`step` skips the copy."""
        if isinstance(batch, _PlacedBatch):
            return batch
        if hasattr(batch, "data"):  # DataBatch
            vals = list(batch.data) + list(batch.label or [])
            named = dict(zip(self._input_names, vals))
        elif isinstance(batch, dict):
            named = batch
        else:
            named = dict(zip(self._input_names, batch))
        out = _PlacedBatch()
        for n in self._input_names:
            v = named[n]
            if isinstance(v, NDArray):
                v = v.data
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            out[n] = v.to(self.device)
        return out

    def _cast_params(self) -> Dict[str, torch.Tensor]:
        """The parameters as the forward sees them: float32 ones cast to
        ``compute_dtype`` (a differentiable cast), the rest as they are."""
        cdt = self.compute_dtype
        if cdt is None:
            return dict(self._params)
        return {n: (p.to(cdt) if p.dtype == torch.float32 else p)
                for n, p in self._params.items()}

    def _forward_backward(self, placed):
        """Training forward and backward: ``(heads, grads, aux_updates)``
        with a ones cotangent on every head."""
        for p in self._params.values():
            p.grad = None
        args = self._cast_params()
        args.update(placed)
        heads, auxu = eval_symbol(self.symbol, args, self._aux, None, True,
                                  topo=self._topo)
        live = [h for h in heads if h.requires_grad]
        torch.autograd.backward(live, [torch.ones_like(h) for h in live])
        grads = {n: (p.grad if p.grad is not None
                     else torch.zeros_like(p, requires_grad=False))
                 for n, p in self._params.items()}
        return (tuple(h.detach() for h in heads), grads,
                {k: v.detach() for k, v in auxu.items()})

    def step(self, batch) -> List[torch.Tensor]:
        """Run one training step; returns the head outputs."""
        if not self._bound:
            raise MXNetError("call bind() before step()")
        self._num_update += 1
        placed = self.place_batch(batch)
        heads, grads, auxu = self._forward_backward(placed)
        self._apply_update(grads, auxu)
        return list(heads)

    def _apply_update(self, grads: Dict[str, torch.Tensor],
                      auxu: Dict[str, torch.Tensor]) -> None:
        """The update half of the JAX ``train_step`` for update number
        ``self._num_update``: guard scalars, then the fused or unfused
        optimizer step, then the aux states."""
        resil = self._resil
        with torch.no_grad():
            self._lr_dev.fill_(float(self.optimizer.lr))
            self._t_dev.fill_(float(self._num_update))
            ok = mult = eff_norm = None
            if resil is not None:
                sq = resilience.tree_sq_sum(grads)
                ok = torch.isfinite(sq)
                eff_norm = torch.sqrt(sq) * float(
                    abs(self._rescale_grad) or 1.0)
                if resil.clip_global_norm is not None:
                    mult = torch.minimum(
                        self._c_one,
                        self._c_clip / torch.maximum(eff_norm,
                                                     self._c_tiny))
                if mult is not None and not self._fused:
                    grads = {n: g * mult for n, g in grads.items()}
            if self._fused:
                self._fused_apply(grads, mult, ok)
            else:
                self._unfused_apply(grads, ok)
            if resil is not None:
                for k, v in auxu.items():
                    self._aux[k] = torch.where(ok, v, self._aux[k])
                self._guard_state = resilience.state_update(
                    self._guard_state, ok, eff_norm)
            else:
                self._aux.update(auxu)

    def _fused_apply(self, grads, mult, ok) -> None:
        """The hopper form: one kernel launch a step over the gradients
        in plan order; the bucket form: a gather into one flat gradient
        and one launch per bucket.  The scalar chain mirrors the unfused
        step op for op, so the result is bitwise the same."""
        opt = self.optimizer
        kind = self._fused_kind
        lr_eff = self._lr_dev * float(next(iter(self._lr_mult.values())))
        wd_common = (float(opt.wd * next(iter(self._wd_mult.values())))
                     if self._fused_wd_uniform else 0.0)
        b1 = float(getattr(opt, "beta1", 0.0) or 0.0)
        b2 = float(getattr(opt, "beta2", 0.0) or 0.0)
        if kind in ("sgd", "sgd_momentum"):
            scalars = (lr_eff,)
        else:
            lr_t = opt_mod.adam_lr_t(lr_eff, b1, b2, self._t_dev)
            scalars = ((lr_t,) if kind == "adam"
                       else (lr_t, lr_eff * wd_common)
                       if self._fused_wd_uniform else (lr_t, lr_eff))
        common = dict(
            kind=kind, mult=mult, ok=ok,
            momentum=float(getattr(opt, "momentum", 0.0) or 0.0),
            beta1=b1, beta2=b2,
            epsilon=float(getattr(opt, "epsilon", 0.0) or 0.0),
            wd=wd_common, rescale_grad=self._rescale_grad,
            clip_gradient=opt._hyper().get("clip_gradient"))
        order = self._fused_plan.order
        if self._fused_route == "hopper":
            fu.fused_update_params([grads[n] for n in order], self._flat_w,
                                   self._flat_state, self._chunk_plan,
                                   scalars, wd_vec=self._flat_wd, **common)
            return
        g_flat = torch.cat([grads[n].reshape(-1) for n in order])
        for b0, b1_ in self._bucket_bounds:
            fu.fused_update(
                g_flat[b0:b1_], self._flat_w[b0:b1_],
                tuple(s[b0:b1_] for s in self._flat_state), scalars,
                wd_vec=(None if self._flat_wd is None
                        else self._flat_wd[b0:b1_]),
                form="bucket", **common)

    def _unfused_apply(self, grads, ok) -> None:
        """Per parameter: ``optimizer._functional_step``, gated by
        ``where(ok, new, old)``, written back in place."""
        opt = self.optimizer
        hyper = opt._hyper()
        hyper["rescale_grad"] = self._rescale_grad
        step_fn = type(opt)._functional_step
        lrs: Dict[float, torch.Tensor] = {}
        for n in self._param_names:
            p = self._params[n]
            m = float(self._lr_mult[n])
            if m not in lrs:
                lrs[m] = self._lr_dev * m
            w2, s2 = step_fn(hyper, p, grads[n], self._opt_state[n], lrs[m],
                             opt.wd * self._wd_mult[n], self._t_dev, None)
            if ok is not None:
                w2 = torch.where(ok, w2, p)
                s2 = _gate(ok, s2, self._opt_state[n])
            p.copy_(w2)
            self._opt_state[n] = s2

    def forward(self, batch) -> List[torch.Tensor]:
        """Inference forward (moving statistics, no aux update)."""
        if not self._bound:
            raise MXNetError("call bind() before forward()")
        placed = self.place_batch(batch)
        with torch.no_grad():
            args = self._cast_params()
            args.update(placed)
            heads, _ = eval_symbol(self.symbol, args, self._aux, None, False,
                                   topo=self._topo)
        return list(heads)

    # ------------------------------------------------------------------
    # Param access
    # ------------------------------------------------------------------

    def get_params(self) -> Tuple[Dict[str, NDArray], Dict[str, NDArray]]:
        """Host copies (NDArrays on the CPU) of parameters and aux
        states."""
        arg = {n: nd_array(v.detach(), ctx=cpu())
               for n, v in self._params.items()}
        aux = {n: nd_array(v, ctx=cpu()) for n, v in self._aux.items()}
        return arg, aux

    def set_params(self, arg_params, aux_params=None) -> None:
        """Copy values (numpy, tensors or NDArrays) into the parameters
        and aux states of the same names, in place."""
        with torch.no_grad():
            for n, v in (arg_params or {}).items():
                if n in self._params:
                    NDArray(self._params[n].detach())[:] = v
            for n, v in (aux_params or {}).items():
                if n in self._aux:
                    NDArray(self._aux[n])[:] = v

    def opt_state_by_param(self) -> Dict[str, Tuple[torch.Tensor, ...]]:
        """Optimizer state per parameter name, as a tuple of tensors in
        the optimizer's state order, whatever the layout (flat buckets on
        the fused path)."""
        if not self._fused:
            out = {}
            for n, s in self._opt_state.items():
                if s is None:
                    out[n] = ()
                elif isinstance(s, torch.Tensor):
                    out[n] = (s,)
                else:
                    out[n] = tuple(s)
            return out
        plan = self._fused_plan
        offs = plan.offsets
        return {n: tuple(s[offs[n]:offs[n] + int(np.prod(plan.shapes[n]))]
                         .view(plan.shapes[n]) for s in self._flat_state)
                for n in self._param_names}

    def save_state(self, *args, **kwargs):
        raise not_ported("ShardedTrainer.save_state (checkpoint/)")

    def restore_state(self, *args, **kwargs):
        raise not_ported("ShardedTrainer.restore_state (checkpoint/)")

    def fit(self, *args, **kwargs):
        raise not_ported("ShardedTrainer.fit (io.py, metric.py)")


def _torch_dtype(name) -> Optional[torch.dtype]:
    """``compute_dtype`` as a torch dtype (None stays None)."""
    if name is None:
        return None
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise MXNetError(f"compute_dtype {name!r} is not a floating-point "
                         "dtype")
    return dt


def _gate(ok, new, old):
    """``where(ok, new, old)`` over matching state trees."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    return type(new)(_gate(ok, a, b) for a, b in zip(new, old))
