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

The bound arrays are read in place, not copied: write them before
``forward``, not between ``forward`` and ``backward`` (autograd then
raises, as the saved values would be stale).  The JAX executor's
ahead-of-time program cache (``warmup``, ``program_cache_size``) waits
for the port of ``compile_cache`` and raises.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError, not_ported
from .context import Context, as_context, resolve_device
from .graph_eval import eval_symbol
from . import random as _random
from .ndarray import NDArray

__all__ = ["Executor"]


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
        if group2ctx:
            raise not_ported("Executor(group2ctx=...) (model-parallel "
                             "placement)")
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
        self._outputs: Optional[List[NDArray]] = None
        self._graph = None          # (heads, leaves) of a training forward
        self._forwarded = False
        self._frozen_aux: Dict[str, torch.Tensor] = {}
        self._frozen_key = None
        self._monitor_cb: Optional[Callable[[str, NDArray], None]] = None

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
                              self._frozen_key, is_train, want_internals=want_internals,
                              topo=self._topo)
        self._graph = (res[0], leaves) if record else None
        if is_train:
            for name_, val in res[1].items():
                self._aux_dict[name_]._write(val.detach())
        self._outputs = [NDArray(h.detach(), ctx=self._ctx) for h in res[0]]
        return res

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Write ``kwargs`` into the bound arguments, run the graph and
        return the outputs."""
        for k, v in kwargs.items():
            if k not in self._arg_dict:
                raise MXNetError(f"forward: no argument named {k}")
            self._arg_dict[k]._write(v)
        self._forwarded = True
        self._frozen_aux = {n: a.data.clone()
                            for n, a in self._aux_dict.items()}
        self._frozen_key = _random.next_key(self._ctx)
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
    # The JAX executor's compiled-program cache: not ported
    # ------------------------------------------------------------------

    def warmup(self, fb=None):
        raise not_ported("Executor.warmup (the AOT program cache, "
                         "compile_cache.py)")

    def program_cache_size(self) -> int:
        raise not_ported("Executor.program_cache_size (the AOT program "
                         "cache, compile_cache.py)")

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
