"""Executor: a symbol bound to arrays on one device.

Counterpart of ``mxnet_tpu/executor.py``.  The JAX executor traces the
symbol into jitted programs; here the graph runs eagerly through
:func:`~mxnet_tpu_torch.graph_eval.eval_symbol`:

* ``forward(is_train=True)`` records autograd's graph with the arguments
  that have gradient arrays as leaves; ``forward(is_train=False)`` runs
  under ``torch.no_grad()``, so no op (a custom op included) records a
  backward node.
* ``backward(out_grads)`` is ``torch.autograd.grad`` of the heads with
  ``out_grads`` (default ones) as cotangents, written into the bound
  gradient arrays under ``grad_req`` ``write`` (overwrite), ``add``
  (accumulate) or ``null`` (untouched).  Without a recorded graph (the
  last forward was not a training one) it first runs the training
  forward on the bound values, the aux states and the random key of that
  forward (:func:`~mxnet_tpu_torch.random.next_key`, drawn once per
  ``forward``), as the JAX executor's ``_frozen_rng`` does: the gradient
  comes from the same Dropout masks as the outputs returned.
* Auxiliary states (BatchNorm's moving statistics) are updated in place
  after a training forward, the reference's mutate-in-forward semantics.
* ``group2ctx`` (model parallelism, the reference's ``AssignContext``):
  each node whose ``ctx_group`` attribute names a group runs on that
  group's context, the others on the executor's; every variable, its
  gradient array and a node's aux states live on the context of their
  first consumer; each value that crosses between two contexts goes
  through :func:`~mxnet_tpu_torch.ops.nn_ops.cross_device_copy` (counted,
  and the gradient crosses back through it), and each output lives on
  its node's context.  Contexts of different device types mix
  (``{"embed": cpu(0), "blocks": gpu(0)}``).  Such a graph runs eagerly,
  without recompute scopes, as in the JAX package.

The bound arrays are read in place, not copied: write them before
``forward``, not between ``forward`` and ``backward`` (autograd then
raises, as the saved values would be stale).

Programs (:meth:`Executor.warmup`), as in the JAX executor: ``fwd_False``
and ``fwd_True`` (the inference and training forwards) and
``fb_<grads>`` (forward and backward in one), each the step's device
work over the bound arrays, captured as a CUDA graph on the card
(:class:`~mxnet_tpu_torch.compile_cache.CapturedProgram`).  After
``warmup`` a forward replays its program (the outputs are cloned from
its static buffers, the aux updates land in the bound arrays), and
``backward()`` after a training forward replays ``fb``, which recomputes
the forward from the aux states that forward saw, as the JAX executor's
``fb`` program does.  A graph with a Python custom op or a sampling op
is not captured (the program runs eagerly and says why), nor is a
forward with a monitor hook installed (it needs every internal value).
Executors bound with ``shared_exec`` share one program table
(:meth:`Executor.program_cache_size` counts it), each program bound to
its own executor's arrays.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import compile_cache as cc
from .base import MXNetError
from .context import Context, as_context, resolve_device
from .graph_eval import eval_symbol
from . import random as _random
from .ndarray import NDArray

__all__ = ["Executor"]


def _touch(arrays) -> None:
    """Mark NDArrays written by a replayed program (their version counts
    writes, as an eager in-place write does)."""
    for a in arrays:
        a._chunk.version += 1


def _as_req_dict(grad_req, arg_names: List[str]) -> Dict[str, str]:
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    if isinstance(grad_req, dict):
        return {n: grad_req.get(n, "null") for n in arg_names}
    raise MXNetError(f"invalid grad_req {grad_req!r}")


class Executor:
    """One Symbol bound to argument, gradient and aux arrays on one
    context.  ``shared_exec`` is taken for the JAX signature, whose
    executors share their compiled programs there; an eager graph has
    none (``Symbol.simple_bind(shared_exec=...)`` shares the arrays)."""

    def __init__(self, symbol, ctx: Context, args, args_grad=None,
                 grad_req="write", aux_states=None, group2ctx=None,
                 shared_exec=None):
        self._symbol = symbol
        self._ctx = as_context(ctx)
        resolve_device(self._ctx)           # raises without the card
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        if isinstance(args, dict):
            missing = [n for n in arg_names if n not in args]
            if missing:
                raise MXNetError(f"bind: missing arguments {missing}")
            self._arg_dict = {n: args[n] for n in arg_names}
        else:
            if len(args) != len(arg_names):
                raise MXNetError(
                    f"bind: expected {len(arg_names)} args, got {len(args)}")
            self._arg_dict = dict(zip(arg_names, args))

        if args_grad is None:
            self._grad_dict: Dict[str, NDArray] = {}
        elif isinstance(args_grad, dict):
            self._grad_dict = dict(args_grad)
        else:
            self._grad_dict = {n: g for n, g in zip(arg_names, args_grad)
                               if g is not None}

        self._req = _as_req_dict(grad_req, arg_names)
        for n in arg_names:
            if self._req.get(n, "null") != "null" and n not in self._grad_dict:
                self._req[n] = "null"
        for n, r in self._req.items():
            if r not in ("write", "add", "null", "inplace"):
                raise MXNetError(f"unknown grad_req {r!r} for {n}")
        self._grad_names = [n for n in arg_names
                            if self._req.get(n, "null") != "null"]

        aux_states = {} if aux_states is None else aux_states
        if isinstance(aux_states, dict):
            missing = [n for n in aux_names if n not in aux_states]
            self._aux_dict = {n: aux_states[n] for n in aux_names
                              if n in aux_states}
        else:
            self._aux_dict = dict(zip(aux_names, aux_states))
            missing = aux_names[len(aux_states):]
        if missing:
            raise MXNetError(f"bind: missing aux states {missing}")

        self._arg_names = arg_names
        self._aux_names = aux_names
        self._topo = symbol._topo()
        self._placement = (self._place(group2ctx) if group2ctx else None)
        self._outputs: Optional[List[NDArray]] = None
        self._graph = None          # (heads, leaves) of a training forward
        self._forwarded = False
        self._frozen_aux: Dict[str, torch.Tensor] = {}
        self._frozen_key = None
        self._monitor_cb: Optional[Callable[[str, NDArray], None]] = None
        # captured programs, shared with the executors bound over this
        # one's arrays: {(owner token, program name): CapturedProgram}
        self._programs: Dict[Any, cc.CapturedProgram] = (
            shared_exec._programs if shared_exec is not None else {})
        self._frozen_static: Optional[Dict[str, torch.Tensor]] = None
        self._cot_static: Optional[List[torch.Tensor]] = None
        self._last_train = False
        self._graph_pool = None

    def _place(self, group2ctx) -> Dict[str, Context]:
        """The context of every node and variable under ``group2ctx``
        (the JAX executor's placement), with the bound arrays moved
        there."""
        g2c = {g: as_context(c) for g, c in group2ctx.items()}
        for c in g2c.values():
            resolve_device(c)                 # raises without the card
        placement: Dict[str, Context] = {}
        for node in self._topo:
            if node.is_variable:
                continue
            group = node.anno_attrs().get("ctx_group")
            placement[node.name] = g2c.get(group, self._ctx) if group \
                else self._ctx
        for node in self._topo:
            if node.is_variable:
                continue
            for src, _ in node.inputs:
                if src.is_variable and src.name not in placement:
                    placement[src.name] = placement[node.name]
            for aux in node.aux_full_names():
                if aux in self._aux_dict:
                    self._aux_dict[aux]._migrate(placement[node.name])
        for node in self._topo:
            if node.is_variable and node.name not in placement:
                placement[node.name] = self._ctx
        for arrays in (self._arg_dict, self._grad_dict):
            for name_, arr in arrays.items():
                if name_ in placement and arr.context != placement[name_]:
                    arr._migrate(placement[name_])
        return placement

    def _out_ctx(self, i: int) -> Context:
        """The context of head ``i``: its node's under a placement."""
        if self._placement is None:
            return self._ctx
        return self._placement[self._symbol._heads[i][0].name]

    # ------------------------------------------------------------------
    # Running the graph
    # ------------------------------------------------------------------

    def _run(self, is_train: bool, aux_vals: Dict[str, torch.Tensor],
             want_internals: bool = False):
        """Evaluate the graph; with ``is_train`` and gradient arrays bound,
        record autograd's graph over leaves sharing the bound storage."""
        record = is_train and bool(self._grad_names)
        leaves = {}
        arg_vals = {}
        for n, arr in self._arg_dict.items():
            t = arr.data
            if record and n in self._grad_names and t.is_floating_point():
                t = t.detach().requires_grad_(True)
                leaves[n] = t
            arg_vals[n] = t
        with torch.set_grad_enabled(record):
            res = eval_symbol(self._symbol, arg_vals, aux_vals,
                              self._frozen_key, is_train,
                              want_internals=want_internals,
                              topo=self._topo, placement=self._placement)
        self._graph = (res[0], leaves) if record else None
        if is_train:
            for name_, val in res[1].items():
                self._aux_dict[name_]._write(val.detach())
        self._outputs = [NDArray(h.detach(), ctx=self._out_ctx(i))
                         for i, h in enumerate(res[0])]
        return res

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Write ``kwargs`` into the bound arguments, run the graph and
        return the outputs."""
        for k, v in kwargs.items():
            if k not in self._arg_dict:
                raise MXNetError(f"forward: no argument named {k}")
            self._arg_dict[k]._write(v)
        self._forwarded = True
        self._last_train = bool(is_train)
        self._frozen_key = _random.next_key(self._ctx)
        prog = (self._program(f"fwd_{bool(is_train)}")
                if self._monitor_cb is None else None)
        if prog is not None:
            outs = prog()
            self._graph = None
            self._frozen_aux = self._frozen_static
            if is_train:
                _touch(self._aux_dict.values())
            self._outputs = [NDArray(h.clone(), ctx=self._out_ctx(i))
                             for i, h in enumerate(outs)]
            return self.outputs
        self._frozen_aux = {n: a.data.clone()
                            for n, a in self._aux_dict.items()}
        res = self._run(bool(is_train), self._frozen_aux,
                        want_internals=self._monitor_cb is not None)
        if self._monitor_cb is not None:
            # in name order, as the JAX executor calls its hook
            for name_, arr in sorted(res[2].items()):
                self._monitor_cb(name_, NDArray(arr.detach(), ctx=self._ctx))
        return self.outputs

    @property
    def outputs(self) -> List[NDArray]:
        if self._outputs is None:
            raise MXNetError("call forward() before reading outputs")
        return self._outputs

    def backward(self, out_grads=None) -> None:
        """Gradients of the heads into the bound gradient arrays, honouring
        grad_req write/add/null."""
        if not self._forwarded:
            raise MXNetError("call forward(is_train=True) before backward()")
        if not self._grad_names:
            raise MXNetError("backward called on an executor bound without "
                             "gradient arrays (grad_req=null)")
        prog = (self._program("fb_" + ",".join(self._grad_names))
                if self._last_train and self._graph is None else None)
        if prog is not None:
            self._stage_cotangents(out_grads)
            prog()
            _touch(self._grad_dict[n] for n in self._grad_names)
            return
        if self._graph is None:
            self._run(True, self._frozen_aux)
        heads, leaves = self._graph
        self._graph = None
        if out_grads is None:
            out_grads = [torch.ones_like(h) for h in heads]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor, np.ndarray)):
                out_grads = [out_grads]
            if len(out_grads) != len(heads):
                raise MXNetError(f"backward: need {len(heads)} head grads, "
                                 f"got {len(out_grads)}")
            out_grads = [self._cotangent(g, h)
                         for g, h in zip(out_grads, heads)]
        live = [(h, g) for h, g in zip(heads, out_grads) if h.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if live and names:
            grads = torch.autograd.grad(
                [h for h, _ in live], [leaves[n] for n in names],
                [g for _, g in live], allow_unused=True)
        got = dict(zip(names, grads))
        for name_ in self._grad_names:
            dst = self._grad_dict[name_]
            g = got.get(name_)
            if g is None:
                g = torch.zeros(dst.shape, dtype=dst.data.dtype,
                                device=dst.data.device)
            if self._req[name_] == "add":
                dst._write(dst.data + g.to(dst.data.dtype))
            else:  # write / inplace
                dst._write(g)

    @staticmethod
    def _cotangent(g, head: torch.Tensor) -> torch.Tensor:
        if isinstance(g, NDArray):
            g = g.data
        elif not isinstance(g, torch.Tensor):
            g = torch.as_tensor(np.asarray(g))
        return g.to(device=head.device, dtype=head.dtype)

    # ------------------------------------------------------------------
    # Programs (the JAX executor's AOT warmup)
    # ------------------------------------------------------------------

    def _program(self, name: str) -> Optional[cc.CapturedProgram]:
        return self._programs.get((cc.owner_token(self), name))

    def program_cache_size(self) -> int:
        """Programs in this executor's (possibly shared) table: the
        bucketing reuse gauge."""
        return len(self._programs)

    def _fingerprint(self) -> str:
        if getattr(self, "_graph_fp", None) is None:
            from .graph_eval import graph_fingerprint
            self._graph_fp = graph_fingerprint(self._symbol, topo=self._topo)
        return self._graph_fp

    def _body_fwd(self, is_train: bool, with_aux: bool = False):
        """The forward's device work: save the aux states it sees, run
        the graph, write the aux updates (training) in place.  With
        ``with_aux`` the body returns ``(heads, aux updates)``: the
        program auditor's view, whose aux outputs pair with the aux
        states by name."""
        frozen = self._frozen_static

        def body():
            with torch.no_grad():
                for n, a in self._aux_dict.items():
                    frozen[n].copy_(a.data)
                heads, auxu = eval_symbol(
                    self._symbol, {n: a.data for n, a in
                                   self._arg_dict.items()},
                    frozen, None, is_train, topo=self._topo,
                    placement=self._placement)
                if is_train:
                    for n, v in auxu.items():
                        self._aux_dict[n].data.copy_(v)
            if with_aux:
                return tuple(heads), (dict(auxu) if is_train else {})
            return tuple(heads)
        return body

    def _body_fb(self):
        """Forward and backward in one, from the aux states the last
        training forward saw, with the staged cotangents: the gradients
        land in the bound arrays per ``grad_req``."""
        frozen, cots = self._frozen_static, self._cot_static

        def body():
            arg_vals, leaves = {}, {}
            for n, arr in self._arg_dict.items():
                t = arr.data
                if n in self._grad_names and t.is_floating_point():
                    t = t.detach().requires_grad_(True)
                    leaves[n] = t
                arg_vals[n] = t
            with torch.enable_grad():
                heads, _ = eval_symbol(self._symbol, arg_vals, frozen, None,
                                       True, topo=self._topo,
                                       placement=self._placement)
                live = [(h, g) for h, g in zip(heads, cots)
                        if h.requires_grad]
                names = list(leaves)
                grads = [None] * len(names)
                if live and names:
                    grads = torch.autograd.grad(
                        [h for h, _ in live], [leaves[n] for n in names],
                        [g for _, g in live], allow_unused=True)
            got = dict(zip(names, grads))
            with torch.no_grad():
                for name_ in self._grad_names:
                    dst = self._grad_dict[name_].data
                    g = got.get(name_)
                    if self._req[name_] == "add":
                        if g is not None:
                            dst.add_(g.to(dst.dtype))
                    elif g is None:
                        dst.zero_()
                    else:
                        dst.copy_(g)
            return ()
        return body

    def _stage_cotangents(self, out_grads) -> None:
        heads = self._cot_static
        if out_grads is None:
            for c in heads:
                c.fill_(1)
            return
        if isinstance(out_grads, (NDArray, torch.Tensor, np.ndarray)):
            out_grads = [out_grads]
        if len(out_grads) != len(heads):
            raise MXNetError(f"backward: need {len(heads)} head grads, "
                             f"got {len(out_grads)}")
        for c, g in zip(heads, out_grads):
            c.copy_(self._cotangent(g, c))

    def warmup(self, fb: Optional[bool] = None) -> List[Dict[str, Any]]:
        """Resolve this executor's programs through the global
        :class:`~mxnet_tpu_torch.compile_cache.ProgramCache` now instead
        of running the first batch eagerly: ``fwd_False``, and (when
        gradients are bound, or ``fb=True``) ``fwd_True`` and the fused
        forward and backward ``fb_<grads>``.  Later ``forward`` /
        ``backward`` calls replay them.  Returns the per-program infos
        (``kind``, ``source``, ``seconds``, ``digest``; ``reason`` for a
        program that runs eagerly).  The bound arrays are left as they
        were."""
        want_fb = fb or (fb is None and self._grad_names)
        if want_fb and not self._grad_names:
            raise MXNetError("warmup(fb=True) on an executor bound without "
                             "gradient arrays")
        dev = resolve_device(self._ctx)
        self._ensure_statics(want_fb)
        if self._graph_pool is None and dev.type == "cuda":
            self._graph_pool = torch.cuda.graph_pool_handle()
        reason = cc.graph_uncapturable(self._topo)
        if reason is None and self._placement is not None:
            reason = ("a group2ctx placement runs eagerly (a CUDA graph "
                      "holds one device's work)")
        arrays = self._program_inputs()
        written = self._written()
        infos: List[Dict[str, Any]] = []

        def warm(name: str, body, extra):
            key = cc.program_key(
                self._fingerprint(), arrays, backend=cc.backend_of(dev),
                extra=dict(extra, owner=cc.owner_token(self)))
            prog, info = cc.get_cache().get_or_compile(
                key, lambda: cc.CapturedProgram(
                    f"executor.{name}", body, dev,
                    preserve=lambda: cc.snapshot_state(written),
                    pool=self._graph_pool, reason=reason,
                    state=self._owned).build(),
                label=f"executor.{name}")
            self._programs[(cc.owner_token(self), name)] = prog
            infos.append(dict(info, kind=name))

        warm("fwd_False", self._body_fwd(False), {"kind": "fwd_False"})
        if want_fb:
            warm("fwd_True", self._body_fwd(True), {"kind": "fwd_True"})
            grads = ",".join(self._grad_names)
            warm("fb_" + grads, self._body_fb(),
                 {"kind": "fb", "grads": grads,
                  "req": [self._req[n] for n in self._grad_names]})
        return infos

    def _ensure_statics(self, want_fb: bool) -> None:
        """The programs' static buffers: the aux states a forward saw and
        (with ``want_fb``) the heads' cotangents."""
        if self._frozen_static is None:
            self._frozen_static = {n: torch.empty_like(a.data)
                                   for n, a in self._aux_dict.items()}
        if want_fb and self._cot_static is None:
            with torch.no_grad():
                heads, _ = eval_symbol(
                    self._symbol, {n: a.data for n, a in
                                   self._arg_dict.items()},
                    {n: a.data for n, a in self._aux_dict.items()}, None,
                    False, topo=self._topo, placement=self._placement)
            self._cot_static = [torch.ones_like(h) for h in heads]

    def _program_inputs(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"args": {n: a.data for n, a in self._arg_dict.items()},
                "aux": {n: a.data for n, a in self._aux_dict.items()}}

    def _written(self) -> List[torch.Tensor]:
        """What a program writes: the aux states and the gradients."""
        return ([a.data for a in self._aux_dict.values()]
                + [self._grad_dict[n].data for n in self._grad_names])

    def _owned(self) -> List[torch.Tensor]:
        """Every tensor of this executor a program reads or writes: the
        bound arrays and the programs' static buffers."""
        return (self._written()
                + [a.data for a in self._arg_dict.values()]
                + list((self._frozen_static or {}).values())
                + list(self._cot_static or []))

    def _audit_programs(self, train: Optional[bool] = None):
        """``(kind, body, inputs, state, preserve)`` of each program the
        program auditor records (:func:`mxnet_tpu_torch.analysis.
        audit_executor`): ``fwd_False``, and with gradients bound (or
        ``train=True``) ``fwd_True`` and ``fb``; the forwards return
        their aux updates beside the heads."""
        want_fb = bool(train or (train is None and self._grad_names))
        if want_fb and not self._grad_names:
            raise MXNetError("audit of a training program on an executor "
                             "bound without gradient arrays")
        self._ensure_statics(want_fb)
        inputs = self._program_inputs()
        written = self._written()
        preserve = lambda: cc.snapshot_state(  # noqa: E731
            written + list(self._frozen_static.values()))
        work = [("fwd_False", self._body_fwd(False, with_aux=True))]
        if want_fb:
            work += [("fwd_True", self._body_fwd(True, with_aux=True)),
                     ("fb", self._body_fb())]
        return [(kind, body, inputs, self._owned(), preserve)
                for kind, body in work]

    # ------------------------------------------------------------------
    # Accessors
    # ------------------------------------------------------------------

    @property
    def arg_dict(self) -> Dict[str, NDArray]:
        return self._arg_dict

    @property
    def grad_dict(self) -> Dict[str, NDArray]:
        return self._grad_dict

    @property
    def aux_dict(self) -> Dict[str, NDArray]:
        return self._aux_dict

    @property
    def arg_arrays(self) -> List[NDArray]:
        return [self._arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self) -> List[Optional[NDArray]]:
        return [self._grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self) -> List[NDArray]:
        return [self._aux_dict[n] for n in self._aux_names]

    def copy_params_from(self, arg_params: Dict[str, NDArray],
                         aux_params: Optional[Dict[str, NDArray]] = None,
                         allow_extra_params: bool = False) -> None:
        """Copy parameters (NDArrays, tensors or numpy) into the bound
        arrays."""
        for name_, arr in arg_params.items():
            if name_ in self._arg_dict:
                self._arg_dict[name_]._write(arr)
            elif not allow_extra_params:
                raise MXNetError(f"copy_params_from: no argument {name_}")
        for name_, arr in (aux_params or {}).items():
            if name_ in self._aux_dict:
                self._aux_dict[name_]._write(arr)
            elif not allow_extra_params:
                raise MXNetError(f"copy_params_from: no aux state {name_}")

    def set_monitor_callback(self, callback) -> None:
        """Install a hook called with ``(name, NDArray)`` for every
        variable and node output on each forward."""
        self._monitor_cb = callback

    def debug_str(self) -> str:
        """The graph's nodes in execution order (``Executor::Print``)."""
        lines = [f"Symbol outputs: {self._symbol.list_outputs()}"]
        for n in self._topo:
            kind = "var" if n.is_variable else n.op.name
            lines.append(f"  {kind:20s} {n.name}")
        return "\n".join(lines)
