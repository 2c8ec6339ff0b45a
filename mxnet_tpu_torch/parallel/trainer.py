"""ShardedTrainer: eager autograd over a mesh plus the fused update (K2).

Counterpart of ``mxnet_tpu/parallel/trainer.py`` for one device.  The JAX
trainer compiles one program per step; here each step runs eagerly:

1. ``eval_symbol`` runs the forward in training mode over parameters that
   are autograd leaves;
2. the heads are back-propagated with a ones cotangent (the JAX
   ``_grads_and_heads``: loss heads define their own backward), or with
   the guard's loss scale under ``loss_scale``, so the whole backward
   runs at ``scale`` times the magnitude; with ``grad_accum = k`` the
   batch is cut into ``k`` microbatches run in order (each one's aux
   updates feed the next, each keyed ``mix(mix(seed, t), 0xACC, i)``,
   as the JAX trainer folds ``0xACC`` and ``i`` into the step's key),
   their gradients summed by autograd into the same ``.grad`` and their
   heads concatenated back to ``[B, ...]``;
3. the update follows the JAX ``train_step`` line for line: under the
   guard, ``sq = tree_sq_sum(grads)``, ``ok = isfinite(sq)``, the
   effective norm ``sqrt(sq) * |rescale_grad| / scale`` and ONE combined
   multiplier, ``1 / scale`` times the clip coefficient
   ``min(1, clip / max(norm, 1e-12))``; then either the fused
   update (``ops/fused_update.py``: in its hopper form one kernel launch
   a step over the gradients where autograd left them, in its bucket
   form a gather into one flat gradient and a launch per bucket; the
   multiplier rides into the kernel), or the unfused per-parameter
   ``optimizer._functional_step`` after one multiply, gated by
   ``where(ok, new, old)``; aux states (BatchNorm moving statistics)
   keep their old values on a bad step.  Under ``"dynamic"`` scaling the
   guard state runs the scale's schedule (``resilience.state_update``);
   a symbol with fp8 linears turns dynamic scaling on by default.

``matmul_precision`` takes the JAX package's names and sets PyTorch's
float32 matmul precision (and cuDNN's TF32 switch) around each step and
inference forward, restoring the global setting after it
(:func:`matmul_precision_scope`).

The graph's sampling ops (Dropout, ``_sample_*``) draw from a
:class:`~mxnet_tpu_torch.random.GraphKey` on the trainer's device keyed
by ``(seed, update count)`` for a training step and by ``(seed, 0x5EED,
eval count)`` for an inference forward, as the JAX trainer folds ``t``
into its base key (and its eval stream into a salted one): a step's
masks depend on its number only, so a skipped step, a replay or a
resumed ``fit`` draws the same masks, and two trainers of one seed draw
alike.

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
card as 0-d tensors: a step never waits for the host.  The learning
rate is the optimizer's schedule at the update count (``lr_scheduler``),
times the divergence sentinel's backoff, filled into its 0-d tensor each
step (a fill launches a kernel; it does not copy or wait).

:meth:`ShardedTrainer.fit` is the JAX trainer's loop: a
``DevicePrefetchIter`` stages batch *k+1* on a side stream while step
*k* runs (``place_batch`` copies from pinned host memory), ``Accuracy``
folds into a 0-d int32 carry on the card inside each step
(:meth:`_step_acc`) and any other metric buffers head references
(:class:`_AsyncMetric`), so no batch waits for the host; the metric,
the guard counters (every ``GuardConfig.check_every`` batches, into the
divergence sentinel) and the epoch end are the only drains.

Checkpoints (:meth:`ShardedTrainer.save_state`, :meth:`restore_state`,
:meth:`restore_or_initialize`, ``fit(checkpoint_manager=...)``) hold the
full state under the JAX package's array names (``param:<n>``,
``aux:<n>``, ``opt:<key>:<i>`` with ``<key>`` a parameter name, or
``fused:<i>`` for bucket ``i`` of the fused layout) and its meta (the
update count, the guard's six counters cumulative), so a checkpoint of
either package restores into the other when both trainers are fused or
both unfused.  The divergence sentinel's ``"rollback"`` restores the
manager's newest checkpoint.

Programs (:meth:`ShardedTrainer.compile`): the JAX trainer compiles its
step ahead of time; here ``compile`` captures the step's device work
(forward, backward, guard, update, with ``train_acc`` the accuracy fold,
or the inference forward for ``eval``) as a CUDA graph
(:class:`~mxnet_tpu_torch.compile_cache.CapturedProgram`) over static
batch buffers, resolved through the program cache.  :meth:`step`,
``fit``'s accuracy step and :meth:`forward` replay it when the placed
batch's shapes and types match the program's, copying the batch into the
static buffers first and cloning the heads after (the next replay
overwrites them); otherwise they run eagerly, as the JAX trainer falls
back to jit.  A graph reads the storage it captured, so every piece of
state a step writes is written in place (``copy_``), never rebound, and
every host scalar a step needs (learning rate, update count) is filled
into its 0-d tensor before the replay.  ``compile()`` leaves the state
bitwise as it found it: the warm-up steps before the capture are undone.
A graph with a sampling op, or an optimizer that draws noise (SGLD),
is not captured: its generators are seeded per step on the host, and a
replay would repeat the captured draws; such a program runs eagerly and
says why (``compile_info``'s ``reason``).

Data parallelism over a mesh (``mesh=``, ``data_axis=``; default: a
data mesh over every local device of the trainer's platform, one member
on the CPU), as the JAX trainer has it.  The batch is split over the
members (``place_batch``: rows ``[k, N, B/(kN)]`` so that each of the
``grad_accum`` microbatches is split as the JAX trainer splits it), each
member runs the forward and backward on its rows over its own replica of
the parameters, the gradients are summed over the members, the lead
member (the first) applies the update and the others copy the new
parameters and aux states:

* **Implicit mode** (no ``grad_compression``): the JAX trainer's one
  program over the global batch.  Members run in threads that meet at
  every cross-row statistic (``OpContext.sync``, ``members.NodeSync``):
  BatchNorm's batch moments and SoftmaxOutput's ``batch``/``valid``
  denominators count every member's rows, through a differentiable sum,
  so one backward over all members' heads gives the global batch's
  gradients; a reduction over the rows (``sum``, ``max``, ``min``,
  ``norm``, ``softmax_cross_entropy``, ``sum_axis`` and its kin over axis
  0) is the global batch's on every member, and a head made of such
  values only is differentiated once a data group (:func:`_batch_layout`).
  A recompute scope replayed in the backward reuses what its forward met
  with.  The per-tensor gradients are summed with
  :func:`~.collectives.psum`.
* **Explicit mode** (``grad_compression``): the JAX trainer's manual
  region.  Each member is local (its own BatchNorm statistics, the aux
  updates averaged over members, its sampling key folded with its
  index); gradients are reduced over flat buckets in
  ``reversed(param_names)`` order by :func:`~.collectives.
  psum_compressed`, the guard's square sum is taken over the reduced
  buckets, and with the fused update and ``grad_accum == 1`` the reduced
  buckets go straight to K2's ``"bucket"`` form.  ``error_feedback``
  (default on for int8/fp8, ``MXNET_TPU_QUANT_EF``) keeps one f32
  residual a bucket a member (``opt:efres:<i>:0`` in checkpoints, the
  members' residuals end to end).
* ``shard_optimizer=True`` (ZeRO): each parameter's optimizer state is
  cut over the members along its first dimension the member count
  divides, else flattened and padded to a multiple of it
  (``_zero_specs``, ``_zero_flat``); each member updates its slice and
  the slices are gathered into the parameter.  The fused update refuses
  it, as in the JAX package.

Tensor parallelism (``rules=`` a :class:`ShardingRules`, e.g.
:func:`megatron_rules`, over a mesh with a ``model`` axis beside
``data``): the batch is split over the data axis and every member of a
model group (the members that share a data coordinate) gets the same
rows.  Each member holds only its piece of every rule-sharded parameter
(:class:`_PieceLayout`); the first member that holds a piece holds its
optimizer state and updates it (``_tp_apply``), and the pieces are put
together for ``get_params``, checkpoints and inference.  The plan that
computes the model axis's pieces (gather or split,
:mod:`.tensor_parallel`) is recorded in ``compile_info``; the fused
update is off under it (the JAX trainer's reason, recorded too),
``grad_compression`` refuses it, and ZeRO cuts only the replicated
parameters' state.  A rule may cut a parameter over any axis of the
mesh, and over several (``P("expert", None, "model")``,
``P(("data", "model"), None)``): a cut that no op reads in pieces is
gathered where the graph reads it.

Sequence and expert parallelism (a mesh with a ``seq`` or an ``expert``
axis beside ``data``): the batch is split over the data axis and the
members of a seq or expert group get the same rows.  The step scopes
the mesh (``default_mesh``), so ``RingAttention`` runs ring attention
over the seq group (each member its shard of the sequence) and
``MoEFFN`` the expert-parallel program over the expert group (each
member its token block and its experts), each gathering the group's
output; the rest of the step is the same on every member of the group.
Heads are differentiated on the group's member 0 only, and the gathered
outputs carry the gradient to the other members' parts, so a replicated
parameter's gradient is the sum over every member; rules may cut
parameters over the expert axis (``P("expert", ...)``: each member holds
its experts, which meet along their data group).  The dense ``MoEFFN``
over several data members routes the global batch (:func:`_batch_layout`
marks it as a reduction over the rows).  A ``pipe`` axis replicates
the parameters and the step, as the JAX trainer runs such a mesh: its
members hold the same rows and the same parameters, heads are
differentiated on the pipe group's member 0 (the others' gradients are
zero), and the implicit and explicit modes run as over the data axis
alone; the stages themselves are :class:`~.pipeline_trainer.
PipelineTrainer`'s; so does any other axis.  These axes combine:
over ``{"data": 2, "model": 2, "seq": 2}`` each model coordinate's seq
group runs the ring over its local heads, over ``{"expert": 2,
"model": 2}`` each model coordinate's expert group the expert program;
a replicated parameter's gradient is summed over the members of model
coordinate 0, a piece's over the members that hold it.
``grad_compression`` beside a seq or expert axis is refused (the
explicit mode's members do not meet inside the step; the JAX trainer's
manual region fails there too).

Meshes that span processes (``dist.init_distributed``; the JAX
trainer's multi-host mesh): each process runs the members of its box of
the global mesh (:class:`~.process_mesh.ProcessLayout`; members of one
process that form no box are refused), on any axis, and feeds the rows
of the data coordinates its members hold (the batch viewed as
``[grad_accum, data, rows]``, as one process splits it): its own rows
when the data axis spans processes, the whole batch when it lies inside
each.  Meetings along an axis that crosses processes go over that axis's
line of processes (``members.ProcessBridge``); every coordinate, key and
global head follows the global mesh.  A value several processes hold
(a replicated parameter, a piece, a data coordinate's ZeRO slice) is
updated by each of them alike from the same reduced gradient: a
replicated gradient is summed over every process, a piece's over its
holders, ZeRO slices are collected from the first process that holds
their coordinate, and the explicit mode gathers every data member's wire
payload over the data line and sums them in member order.
:meth:`ShardedTrainer.save_state` writes each value once, from the
first process that holds it, and process 0 commits the manifest;
``compile()`` runs such a trainer eagerly.

Inference forwards run on the lead member over the whole batch (no
statistic crosses rows at inference), under the mesh.  One step path
serves every member count and mode; :meth:`ShardedTrainer.compile`
captures it for one member and runs it eagerly, with its reason, over
several.  Over
several members the implicit mode refuses an op that moves rows of the
batch (:func:`_batch_layout`).
"""
from __future__ import annotations

import contextlib
import logging
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import compile_cache as cc
from .. import optimizer as opt_mod
from .. import quant as quant_mod
from .. import resilience, telemetry
from ..analysis.program import mark_grads, record_program, tag
from ..random import GraphKey, mix
from ..base import MXNetError, not_ported
from ..context import Context, as_context, cpu, resolve_device
from ..graph_eval import eval_symbol
from ..initializer import Uniform
from ..ndarray import NDArray, array as nd_array, zeros as nd_zeros
from ..ops import fused_update as fu
from . import collectives
from . import tensor_parallel as tp_mod
from .collectives import (DEFAULT_BUCKET_BYTES, check_compression,
                          plan_buckets, psum, psum_compressed)
from .members import ProcessBridge, TokenChain, run_synced
from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh,
                   NamedSharding, PartitionSpec, axis_groups,
                   data_parallel_mesh, default_mesh, make_mesh)
from .process_mesh import ProcessLayout

__all__ = ["ShardingRules", "ShardedTrainer", "megatron_rules",
           "matmul_precision_scope"]


class ShardingRules:
    """Regex -> PartitionSpec placement rules for parameters.

    The counterpart of the JAX package's rules: instead of pinning a
    layer to one device (``group2ctx``), a rule shards a weight over mesh
    axes, e.g. ``ShardingRules([("fc\\d+_weight", PartitionSpec("model",
    None))])``.  The first pattern that ``re.search``-matches a name
    gives its spec; unmatched parameters are replicated."""

    def __init__(self, rules: Optional[Sequence[Tuple[str,
                                                      PartitionSpec]]] = None):
        self._rules = [(re.compile(pat), spec) for pat, spec in (rules or [])]

    def spec_for(self, name: str) -> PartitionSpec:
        for pat, spec in self._rules:
            if pat.search(name):
                return spec
        return PartitionSpec()


def megatron_rules(model_axis: str = MODEL_AXIS) -> ShardingRules:
    """Megatron-style tensor-parallel placement for ``transformer-lm``
    (FullyConnected weights are ``(out, in)``):

    * q, k, v and ffn1 are column-parallel: the output dimension and the
      bias are cut over ``model_axis``;
    * proj and ffn2 are row-parallel: the input dimension is cut, the
      bias stays replicated;
    * the embedding and ``lm_head`` cut the vocabulary, and so does
      ``lm_head``'s bias.

    LayerNorm scales and offsets are replicated.  Compose with a
    ``{"data": N // tp, "model": tp}`` mesh; the batch is still split
    over ``data``."""
    m = model_axis
    return ShardingRules([
        (r"(^|_)(embed|lm_head)_weight$", PartitionSpec(m, None)),
        (r"(^|_)lm_head_bias$", PartitionSpec(m)),
        (r"_(q|k|v|ffn1)_weight$", PartitionSpec(m, None)),
        (r"_(q|k|v|ffn1)_bias$", PartitionSpec(m)),
        (r"_(proj|ffn2)_weight$", PartitionSpec(None, m)),
    ])


# the JAX package's precision names -> torch's float32 matmul precision.
# "medium" lets a float32 product use bfloat16 inputs where the backend
# has such a kernel; cuBLAS has none, so on the card it runs as TF32
# ("high") does (PERF.md).
_MATMUL_PRECISION = {"bfloat16": "medium", "default": "medium",
                     "tensorfloat32": "high", "high": "high",
                     "float32": "highest", "highest": "highest"}


@contextlib.contextmanager
def matmul_precision_scope(name: Optional[str]):
    """Run the body under the JAX precision ``name``: torch's float32
    matmul precision and cuDNN's TF32 switch (on for every name but
    ``float32``/``highest``); both are restored on exit.  None changes
    nothing."""
    if name is None:
        yield
        return
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision(_MATMUL_PRECISION[name])
    torch.backends.cudnn.allow_tf32 = _MATMUL_PRECISION[name] != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


class _PlacedBatch(dict):
    """A batch already on the trainer's device (``place_batch``); over
    several members ``shards`` holds each member's rows on its device."""

    shards = None


def _host_to(v: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``v`` on ``device``; a host tensor goes to the card from pinned
    memory with ``non_blocking=True`` on the current stream, so the copy
    never waits for the card."""
    pinned = device.type == "cuda" and v.device.type == "cpu"
    return (v.pin_memory() if pinned else v).to(device, non_blocking=pinned)


class ShardedTrainer:
    """Trainer for a Symbol, data parallel over a mesh of devices.

    Parameters
    ----------
    symbol : Symbol
        Network whose heads are loss outputs (SoftmaxOutput etc.).
    optimizer : str or Optimizer
    mesh : parallel.Mesh, optional
        Default: a data mesh over every local device of ``device``'s
        platform (one member on the CPU), or ``device`` alone when it
        names an index.  Beside the data axis, any of the model, seq,
        expert and pipe axes may have more than one member.  After
        ``dist.init_distributed`` the mesh may span processes, on any
        axis: this process runs its members.
    rules : ShardingRules, optional
        Parameter placement over the mesh's axes: the model axis (tensor
        parallelism), the expert axis (each member holds its experts),
        or any other (gathered where the graph reads it); default
        replicated.
    data_axis : str, optional
        The mesh axis the batch is split over (default ``"data"`` when
        the mesh has it).
    grad_compression : None, "int8", "bf16" or "fp8"
        The explicit mode: gradients reduced over flat buckets through
        that wire format (``collectives.psum_compressed``).
    error_feedback : bool, optional
        Carry each member's quantization error into the next step (default
        on for int8/fp8 with ``grad_accum == 1``).
    shard_optimizer : bool
        ZeRO: each member holds and updates a slice of the optimizer state.
    grad_bucket_bytes : int, optional
        Bucket size of the fused update's layout and of the explicit
        reduction (default 4 MiB).
    initializer : Initializer, optional
        Default ``Uniform(0.07)``; draws from a ``torch.Generator`` seeded
        with ``seed``, which also keys the graph's sampling ops.
    compute_dtype : str, optional
        Activation type (e.g. ``"bfloat16"``): float32 parameters are cast
        to it inside each forward; masters and the update stay float32.
    fused_update : bool, optional
        None = fused when eligible (``MXNET_TPU_FUSED_UPDATE=0`` opts
        out); True raises at ``bind`` when the configuration cannot fuse;
        False forces the unfused update.
    matmul_precision : str, optional
        A JAX precision name (``bfloat16``, ``tensorfloat32``,
        ``float32``, ``default``, ``high``, ``highest``) set around each
        step and inference forward (:func:`matmul_precision_scope`).
    grad_accum : int
        Microbatches a step: gradients summed, one update.  The symbol
        is built for the microbatch (``batch / grad_accum``).
    guard, clip_global_norm, loss_scale : the non-finite step guard,
        global-norm clipping and loss scaling (None, a float or
        ``"dynamic"``; ``resilience.py``).
    device : the card unless the caller asks for the CPU
        (``device="cpu"``); raises when CUDA is asked for and absent.
        With a mesh, its first member's device.
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
        if rules is not None and not isinstance(rules, ShardingRules):
            raise MXNetError(f"rules must be a parallel.ShardingRules, got "
                             f"{type(rules).__name__}")
        self.rules = rules or ShardingRules()
        if matmul_precision is not None \
                and matmul_precision not in _MATMUL_PRECISION:
            raise MXNetError(
                f"matmul_precision {matmul_precision!r}: expected one of "
                f"{sorted(_MATMUL_PRECISION)}")
        self.matmul_precision = matmul_precision
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise MXNetError("grad_accum must be >= 1")
        self._set_mesh(mesh, data_axis, device)
        self.compute_dtype = _torch_dtype(compute_dtype)
        self.symbol = symbol
        self.initializer = initializer or Uniform(0.07)
        self.logger = logger or logging.getLogger(__name__)
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self.optimizer = optimizer
        self.grad_bucket_bytes = (int(grad_bucket_bytes) if grad_bucket_bytes
                                  else DEFAULT_BUCKET_BYTES)
        self.shard_optimizer = bool(shard_optimizer)
        self.grad_compression = check_compression(grad_compression)
        if grad_compression is not None and self.data_axis is None:
            raise MXNetError("grad_compression needs a data axis to "
                             "reduce over; this mesh has none")
        split_axes = [a for a in self._dup_axes
                      if a in (SEQ_AXIS, EXPERT_AXIS)]
        if grad_compression is not None and split_axes:
            # the JAX trainer fails here too: its manual region cannot
            # hold the ring's or the expert program's shard_map
            raise MXNetError(
                f"grad_compression over a mesh with a {split_axes[0]!r} "
                "axis: the explicit mode runs each member's backward on "
                "its own, and ring attention and expert parallelism meet "
                "along that axis inside the step (the JAX trainer's manual "
                "region refuses their shard_map as well); use the implicit "
                "mode")
        # error feedback: one residual a bucket a member, on by default
        # for the lossy formats; grad_accum > 1 reduces once a
        # microbatch, where a step's residual has no home
        if error_feedback is None:
            self.error_feedback = (
                self.grad_compression is not None and self.grad_accum == 1
                and quant_mod.error_feedback_default(self.grad_compression))
        else:
            if error_feedback and self.grad_compression is None:
                raise MXNetError("error_feedback=True needs a lossy "
                                 "grad_compression to feed back from")
            if error_feedback and self.grad_accum > 1:
                logging.getLogger(__name__).warning(
                    "error_feedback=True does not compose with "
                    "grad_accum=%d (reduction runs inside the "
                    "microbatch scan); disabling error feedback for "
                    "this trainer", self.grad_accum)
                error_feedback = False
            self.error_feedback = bool(error_feedback)
        self._generator = torch.Generator().manual_seed(int(seed))
        self._seed = int(seed)
        self._node_generators: Dict[int, torch.Generator] = {}
        self._eval_count = 0
        self._fused_req = fused_update
        self._fused = False
        self._fused_kind: Optional[str] = None
        self._fused_plan: Optional[fu.FusedPlan] = None
        if clip_global_norm is None:
            clip_global_norm = getattr(self.optimizer, "clip_global_norm",
                                       None)
        # fp8 narrows the backward's range from both ends (e5m2
        # gradients underflow early): dynamic loss scaling by default
        if loss_scale is None and guard is not False \
                and quant_mod.symbol_uses_fp8(symbol):
            loss_scale = "dynamic"
        if guard is None and getattr(self.optimizer, "skip_nonfinite",
                                     None):
            guard = True
        self._resil = resilience.resolve(guard=guard,
                                         clip_global_norm=clip_global_norm,
                                         loss_scale=loss_scale,
                                         **(guard_params or {}))
        self._guard_state: Optional[Dict[str, torch.Tensor]] = None
        # the divergence sentinel's host state: the lr backoff factor, the
        # counters folded off the card by past drains, the last drain
        self._lr_scale = 1.0
        self._rollbacks = 0
        self._sentinel: Optional[resilience.DivergenceSentinel] = None
        self._resil_base = {"skipped": 0, "overflows": 0, "norm_sum": 0.0,
                            "norm_cnt": 0}
        self._resil_drained: Dict[str, Any] = {}
        self._rollback_hook = None  # runs before a sentinel rollback
        # a save asked for mid-step (a signal handler) waits for the step's
        # end; fit's own manager saves at its batch boundary
        self._in_step = False
        self._deferred_save: Optional[Tuple] = None
        self._fit_manager = None
        self._bound = False
        # captured step programs by kind: (program, batch signature)
        self._aot: Dict[str, Tuple[cc.CapturedProgram, Tuple]] = {}
        self.aot_stats: Dict[str, int] = {"hits": 0, "fallbacks": 0}
        self.compile_info: List[Dict[str, Any]] = []
        self._graph_pool = None
        self._graph_fp: Optional[str] = None
        # a step and a program's warm-up and capture never overlap (a
        # background compile restores the state its warm-up changed)
        self._step_lock = threading.RLock()

    def _set_mesh(self, mesh, data_axis, device) -> None:
        """The mesh, its data axis and the members' devices.  Without a
        mesh: a data mesh over every local device of ``device``'s
        platform (one member on the CPU), or over ``device`` alone when
        it names an index."""
        if mesh is None:
            dev = resolve_device(device)
            named = (isinstance(device, Context)
                     or (isinstance(device, torch.device)
                         and device.index is not None)
                     or (isinstance(device, str) and ":" in device))
            mesh = (make_mesh({DATA_AXIS: 1}, [as_context(dev)]) if named
                    else data_parallel_mesh(device_type=(
                        "cpu" if dev.type == "cpu" else "gpu")))
        elif not isinstance(mesh, Mesh):
            raise MXNetError(f"mesh must be a parallel.Mesh, got "
                             f"{type(mesh).__name__}")
        self.mesh = mesh
        if data_axis is None:
            # a mesh without a data axis replicates the batch
            self.data_axis = (DATA_AXIS if DATA_AXIS in mesh.axis_names
                              else None)
        else:
            if data_axis not in mesh.axis_names:
                raise MXNetError(f"mesh has no axis {data_axis!r}; "
                                 f"axes: {mesh.axis_names}")
            self.data_axis = data_axis
        gshape = mesh.shape
        # over a mesh that spans processes the members below are this
        # process's box of it (``_procs``, process_mesh.ProcessLayout);
        # every coordinate below is the global mesh's
        self._procs: Optional[ProcessLayout] = None
        if mesh.spans_processes:
            from . import dist
            self._procs = ProcessLayout(mesh, dist.process_index())
            local = self._procs.local_mesh(mesh)
            gidx = self._procs.gidx
        else:
            local, gidx = mesh, list(range(mesh.size))
        self._gidx = gidx
        others = sorted(a for a in mesh.axis_names
                        if a != self.data_axis and gshape[a] > 1)
        self.model_axis = (MODEL_AXIS if MODEL_AXIS in mesh.axis_names
                           and MODEL_AXIS != self.data_axis else None)
        # axes whose members hold the same rows and split one op's work
        # (ring attention over seq, expert parallelism) or none of it (a
        # pipe axis, or any other, replicates the step, as the JAX trainer
        # runs such a mesh); the rest of their step is the same on every
        # member of the group.  The model axis is not one of them: its
        # members compute the same function, each on its pieces
        self._dup_axes = [a for a in others if a != MODEL_AXIS]
        self._ndata = gshape[self.data_axis] if self.data_axis else 1
        # the members that meet along each axis: a data group shares every
        # other coordinate (and splits the batch); the members of a model,
        # seq, expert or pipe group share the rows.  ``_axis_of`` names
        # the mesh axis of each key
        self._groups = {DATA_AXIS: axis_groups(local, self.data_axis)}
        self._groups.update({a: axis_groups(local, a)
                             for a in local.axis_names
                             if a not in (self.data_axis, DATA_AXIS)})
        self._axis_of = {k: (self.data_axis if k == DATA_AXIS else k)
                         for k in self._groups}
        # each member's global coordinate along each axis (the data
        # axis's under DATA_AXIS)
        self._coord = {ax: [0] * local.size for ax in self._groups}
        for ax, gs in self._groups.items():
            base = (self._procs.offset(self._axis_of[ax])
                    if self._procs is not None and self._axis_of[ax]
                    else 0)
            for g in gs:
                for r, i in enumerate(g):
                    self._coord[ax][i] = base + r
        self._dcoord = list(self._coord[DATA_AXIS])
        # each member's coordinate along the axes that duplicate rows: a
        # head is differentiated on the members at 0 only
        self._dupcoord = [sum(self._coord[a][i] for a in self._dup_axes)
                          for i in range(local.size)]
        # the members whose gradients of a replicated parameter are summed:
        # every member of model coordinate 0 (each model coordinate
        # computes the whole gradient; a data, seq, expert or pipe
        # coordinate a part of it)
        mcoord = self._coord.get(MODEL_AXIS, [0] * local.size)
        self._rep_members = [i for i in range(local.size) if mcoord[i] == 0]
        self._col0 = self._groups[DATA_AXIS][0]
        # the members' rows of a placed batch: those of the data
        # coordinates this process holds, each member's the ones of its
        # place among them
        self._shard_n = len(self._col0)
        self._shard_coord = [0] * local.size
        for g in self._groups[DATA_AXIS]:
            for r, i in enumerate(g):
                self._shard_coord[i] = r
        # the bridges' specs: each axis that crosses processes, with this
        # process's line along it (bind makes the lines' process groups)
        self._bridges: Dict[str, Tuple[int, int, List[int]]] = {}
        if self._procs is not None:
            for key, ax in self._axis_of.items():
                if ax is not None and self._procs.spans(ax):
                    self._bridges[key] = (self._procs.offset(ax),
                                          self._procs.size(ax),
                                          self._procs.line(ax))
        self._members = local.members
        # resolve_device raises for a CUDA member without CUDA: a member
        # never falls back to the CPU
        self._devices = [resolve_device(m) for m in self._members]
        self._data_devices = [self._devices[i] for i in self._col0]
        self.device = self._devices[0]
        if device is not None and resolve_device(device) != self.device:
            raise MXNetError(f"device {device} is not the mesh's first "
                             f"member {self._members[0]}")

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
        ndata = self._ndata
        for name, shape in input_shapes.items():
            if shape[0] % (ndata * self.grad_accum):
                raise MXNetError(
                    f"global batch {shape[0]} for {name!r} not divisible by "
                    f"data-axis size {ndata} x grad_accum {self.grad_accum}")
        arg_names = sym.list_arguments()
        self._input_names = [n for n in arg_names if n in input_shapes]
        self._label_names = [n for n in arg_names
                             if n in (label_shapes or {})]
        self._param_names = [n for n in arg_names if n not in input_shapes]
        self._aux_names = sym.list_auxiliary_states()
        # the graph runs a microbatch at a time: a symbol that bakes the
        # batch into its Reshapes is built for the microbatch
        arg_shapes, out_shapes, aux_shapes = sym.infer_shape(**{
            n: (s[0] // self.grad_accum,) + tuple(s[1:])
            for n, s in input_shapes.items()})
        shape_of = dict(zip(arg_names, arg_shapes))
        scalars = [n for n, s in zip(sym.list_outputs(), out_shapes)
                   if s is not None and len(s) == 0]
        if scalars and self.grad_compression is not None:
            # the JAX explicit mode's shard_map cannot return a rank-0
            # head over the data axis either
            raise MXNetError(
                f"grad_compression with the 0-d head {scalars[0]!r}: the "
                "explicit mode returns each head cut over the data axis; "
                "use the implicit mode")
        self._input_shapes = {n: tuple(input_shapes[n])
                              for n in self._input_names}
        self._topo = sym._topo()
        # a cross-row statistic in the graph: implicit-mode members meet
        # in threads to count every member's rows
        self._sync_nodes = any(_synced_statistic(n) for n in self._topo
                               if not n.is_variable)
        self._row_reductions: frozenset = frozenset()
        self._global_heads: frozenset = frozenset()
        if ndata > 1 and self.grad_compression is None:
            why, reds, glob, _ = _batch_layout(sym, self._topo,
                                               input_shapes)
            if why is not None:
                raise not_ported(
                    f"ShardedTrainer over {ndata} members in the implicit "
                    f"mode: {why}, which the members' split batch would "
                    "compute per member (the JAX trainer computes it over "
                    "the global batch)")
            self._row_reductions, self._global_heads = reds, glob
        self._setup_tp(shape_of, {n: (s[0] // self.grad_accum,) + tuple(s[1:])
                                  for n, s in input_shapes.items()})
        self._make_groups()
        self._threaded = (self._sync_nodes or bool(self._row_reductions)
                          or any(lay.gathers
                                 for lay in self._pieces.values())
                          or (self._tp_plan is not None
                              and self._tp_plan.tp > 1)
                          or bool(self._dup_axes))

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
        self._shapes = {n: tuple(shape_of[n]) for n in self._param_names}
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
        plans = {n: self._zero_plan(shape_of[n], n)
                 for n in self._param_names}
        self._zero_specs = {n: p[0] for n, p in plans.items()}
        self._zero_flat = {n: p[1] for n, p in plans.items()}
        if self.shard_optimizer:
            flat = [n for n, (_, fl) in plans.items() if fl is not None]
            self.logger.info(
                "ZeRO: %d params dim-sharded, %d flatten-pad-sharded, "
                "%d TP-rule-sharded, 0 replicated",
                len(self._param_names) - len(flat) - len(self._pieces),
                len(flat), len(self._pieces))
        self._setup_fused(shape_of)
        if self._fused:
            self._layout_fused(host)
        else:
            self._params = {n: self._piece(host[n], n, 0).to(self.device)
                            .requires_grad_(True) for n in self._param_names}
            self._opt_state = ({} if self.shard_optimizer else {
                n: opt.state_zeros_like(self._params[n].detach())
                for n in self._param_names if n not in self._pieces})
        self._layout_members(host)
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        # step scalars, refilled in place each step (a fill launches a
        # kernel; it never copies from the host or waits for the card)
        self._lr_dev = torch.zeros((), **f32)
        self._t_dev = torch.zeros((), **f32)
        self._c_one = torch.ones((), **f32)
        self._c_tiny = torch.full((), 1e-12, **f32)
        # SGLD's noise: a generator on the trainer's device
        self._step_rng = (torch.Generator(device=dev).manual_seed(
            int(self._generator.initial_seed()))
            if opt._needs_rng else None)
        if self._resil is not None:
            self._guard_state = resilience.init_state(self._resil, dev)
            clip = self._resil.clip_global_norm
            self._c_clip = (None if clip is None
                            else torch.full((), clip, **f32))
        self._aot.clear()
        self._bound = True
        return self

    def _setup_tp(self, shape_of, micro_shapes) -> None:
        """The rule-sharded parameters (``_pieces``: how the members hold
        each, :class:`_PieceLayout`) and, where the rules cut parameters
        over a model axis, the plan that computes them (``_tp_plan``:
        split where the graph has Megatron's partition, else gather),
        recorded in ``compile_info``.  Over an expert axis each member
        holds its experts and the MoE op reads its pieces as they are; a
        cut over any other axis is gathered where the graph reads it.
        The JAX package's gate: ``grad_compression`` refuses sharded
        parameters."""
        self._pieces: Dict[str, _PieceLayout] = {}
        self._tp_plan: Optional[tp_mod.TPPlan] = None
        specs = {}
        for n in self._param_names:
            spec = self.rules.spec_for(n)
            named = _spec_axes(spec)
            if not named:
                continue
            for ax in named:
                if ax not in self.mesh.axis_names:
                    raise MXNetError(f"rules shard {n} over {ax!r}, which "
                                     f"the mesh {self.mesh.shape} lacks")
            if len(set(named)) < len(named):
                raise MXNetError(f"spec {spec} for {n} names an axis twice")
            NamedSharding(self.mesh, spec).shard_shape(shape_of[n])
            specs[n] = spec
        if not specs:
            return
        if self.grad_compression is not None:
            sharded = list(specs)
            raise MXNetError(
                "grad_compression runs the backward in a manual region with "
                f"replicated params; tensor-parallel rules shard "
                f"{sharded[:3]}... — use the implicit path for TP models")
        model_cut = {n: tp_mod.sharded_dim(spec, MODEL_AXIS)
                     for n, spec in specs.items()
                     if self.model_axis is not None
                     and MODEL_AXIS in _spec_axes(spec)}
        if model_cut:
            ntp = self.mesh.shape[MODEL_AXIS]
            rewrites, why = tp_mod.split_pass(
                self.symbol, self._topo, model_cut,
                {n: specs[n] for n in model_cut}, MODEL_AXIS, ntp,
                micro_shapes)
            self._tp_plan = tp_mod.TPPlan(
                "split" if rewrites is not None else "gather", MODEL_AXIS,
                ntp, model_cut, rewrites, why)
            self.compile_info.append(self._tp_plan.info())
            self.logger.info("tensor parallelism over %d: %s plan for %d "
                             "params%s", ntp, self._tp_plan.plan,
                             len(model_cut), f" ({why})" if why else "")
        split = self._tp_plan is not None and self._tp_plan.plan == "split"
        experts = _moe_expert_params(self._topo)
        for n, spec in specs.items():
            self._pieces[n] = _PieceLayout(
                self, spec, shape_of[n], split, experts.get(n))
        held = [n for n in specs if experts.get(n) in _spec_axes(specs[n])]
        if held:
            self.logger.info("expert parallelism: %d params cut over the "
                             "expert axis", len(held))

    def _make_groups(self) -> None:
        """Over processes, the process groups the step meets in: every
        line along every axis, and every set of processes that holds a
        piece of a rule-sharded parameter together.  ``new_group`` is a
        collective of every process, so each makes every group, its own
        or not, in the same order."""
        if self._procs is None:
            return
        from . import dist
        sets = {tuple(sorted(line)) for ax in self._axis_of.values()
                if ax is not None for line in self._procs.lines(ax)}
        sets.update(r for lay in self._pieces.values() for r in lay.gholders)
        for ranks in sorted(sets):
            if len(ranks) > 1:
                dist.subgroup(ranks)

    def _piece(self, value: torch.Tensor, name: str, member: int):
        """Member ``member``'s piece of parameter ``name``'s full value:
        the value itself unless the rules shard it."""
        lay = self._pieces.get(name)
        if lay is None:
            return value
        return value[lay.sharding.index(self._gidx[member],
                                        tuple(value.shape))]

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
        if self.shard_optimizer:
            why.append("shard_optimizer (ZeRO state layout)")
        if self._pieces:
            why.append("tensor-parallel param sharding")
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
            if self._pieces:
                self.compile_info.append({"kind": "fused_update",
                                          "fused": False,
                                          "reason": "; ".join(why)})
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
        # the hopper form's work list on the device now, not at a step's
        # first launch (a host copy inside the step)
        self._chunk_plan.device_chunks(self.device)
        # the plan buckets each gradient lies in: the auditor's tags
        self._bucket_labels: Dict[str, List[str]] = {}
        for i, segs in enumerate(plan.buckets):
            for n, _, _ in segs:
                self._bucket_labels.setdefault(n, []).append(
                    f"gradbucket:{i}")
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

    def _zero_plan(self, shape: Tuple[int, ...], name: str = ""
                   ) -> Tuple[PartitionSpec, Optional[int]]:
        """The JAX trainer's ZeRO placement of one parameter's optimizer
        state: ``(spec, flat_padded_len)``.  Without ZeRO, the rule's
        spec.  With it, a rule-sharded parameter keeps its rule's spec
        (its state is already cut over the rule's axes); for the others
        the first dimension the data-axis size divides is cut over the
        data axis, and a parameter with none (biases, BN scales) keeps its
        state flattened and padded to a multiple of that size."""
        if name in self._pieces:
            return self.rules.spec_for(name), None
        if not self.shard_optimizer:
            return PartitionSpec(), None
        if self.data_axis is None:
            # one data member holds the whole state (the JAX trainer
            # replicates it); a 0-d parameter's is kept flat
            return PartitionSpec(), (None if len(shape) else 1)
        n = self._ndata
        for dim, size in enumerate(shape):
            if size % n == 0 and size > 0:
                spec = [None] * len(shape)
                spec[dim] = self.data_axis
                return PartitionSpec(*spec), None
        numel = int(np.prod(shape)) if shape else 1
        return PartitionSpec(self.data_axis), -(-numel // n) * n

    def _zero_dim(self, name: str) -> int:
        """The dimension a parameter's ZeRO state is cut along (0 for
        the flattened layout)."""
        spec = self._zero_specs[name]
        if self._zero_flat[name] is not None or self.data_axis not in spec:
            return 0
        return list(spec).index(self.data_axis)

    def _zero_view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` (parameter-shaped) in the layout its ZeRO state is cut
        in: as it is, or flattened and zero-padded."""
        flat_len = self._zero_flat[name]
        if flat_len is None:
            return t
        flat = t.reshape(-1)
        return torch.nn.functional.pad(flat, (0, flat_len - flat.numel()))

    def _layout_members(self, host: Dict[str, torch.Tensor]) -> None:
        """The other members' replicas of the parameters and aux states
        (the lead's are ``_params``/``_aux``), the ZeRO state slices and
        the error-feedback residuals, each on its member's device."""
        self._replicas: List[Dict[str, Any]] = []
        for dev in self._devices[1:]:
            rep: Dict[str, Any] = {"aux": {n: v.to(dev, copy=True)
                                           for n, v in self._aux.items()}}
            i = len(self._replicas) + 1
            if self._fused:
                flat = self._flat_w.detach().to(dev, copy=True)
                offs, plan = self._fused_plan.offsets, self._fused_plan
                rep["flat_w"] = flat
                rep["params"] = {n: flat[offs[n]:offs[n] + int(
                    np.prod(plan.shapes[n]))].view(plan.shapes[n])
                    .requires_grad_(True) for n in self._param_names}
            else:
                rep["params"] = {n: self._piece(host[n], n, i).detach()
                                 .to(dev, copy=True).requires_grad_(True)
                                 for n in self._param_names}
            self._replicas.append(rep)
        opt = self.optimizer
        # each piece's lead holds the optimizer state of that piece of a
        # rule-sharded parameter
        self._piece_state: Dict[str, List[Any]] = {
            n: [opt.state_zeros_like(self._member_params(j)[n].detach())
                for j in lay.leads] for n, lay in self._pieces.items()}
        self._zero_state: List[Dict[str, Any]] = []
        if self.shard_optimizer:
            # each data member of this process holds the slice of its
            # global data coordinate
            for i, dev in zip(self._col0, self._data_devices):
                states = {}
                for n in self._param_names:
                    if n in self._pieces:
                        continue
                    full = self._zero_view(n, host[n].detach())
                    piece = full.chunk(self._ndata,
                                       self._zero_dim(n))[self._dcoord[i]]
                    states[n] = opt.state_zeros_like(
                        torch.zeros(piece.shape, dtype=piece.dtype,
                                    device=dev))
                self._zero_state.append(states)
        self._ef_res: List[List[torch.Tensor]] = []
        if self.error_feedback:
            lens = self._grad_bucket_lens()
            self._ef_res = [[torch.zeros(n, dtype=torch.float32, device=dev)
                             for n in lens] for dev in self._data_devices]

    def _grad_bucket_lens(self) -> List[int]:
        """Element count of every gradient bucket of the explicit
        reduction, in its order (reversed parameters, greedy fill): the
        error-feedback residuals' sizes."""
        counts = [int(np.prod(self._params[n].shape))
                  for n in reversed(self._param_names)]
        counts = [c for c in counts if c > 0]
        plan = plan_buckets(counts, 4, self.grad_bucket_bytes)
        return [sum(s1 - s0 for _, s0, s1 in b) for b in plan]

    def _member_params(self, i: int) -> Dict[str, torch.Tensor]:
        return self._params if i == 0 else self._replicas[i - 1]["params"]

    def _member_aux(self, i: int) -> Dict[str, torch.Tensor]:
        return self._aux if i == 0 else self._replicas[i - 1]["aux"]

    def _broadcast(self) -> None:
        """The lead's parameters and aux states into every other member's
        replica, in place; a rule-sharded parameter's piece from that
        piece's lead."""
        with torch.no_grad():
            for i, rep in enumerate(self._replicas, 1):
                if self._fused:
                    rep["flat_w"].copy_(self._flat_w)
                else:
                    for n, p in rep["params"].items():
                        lay = self._pieces.get(n)
                        if lay is None:
                            p.copy_(self._params[n])
                            continue
                        lead = lay.leads[lay.of[i]]
                        if lead != i:
                            p.copy_(self._member_params(lead)[n])
                for n, v in rep["aux"].items():
                    v.copy_(self._aux[n])

    def optimizer_state_bytes_per_device(self) -> int:
        """Bytes of optimizer state the lead member holds (the ZeRO
        savings gauge): its state slices under ZeRO, else the whole
        state, with the weight-decay vector and its error-feedback
        residuals."""
        if self.shard_optimizer:
            trees = list(self._zero_state[0].values())
            trees += [st[0] for st in self._piece_state.values()]
        elif self._fused:
            trees = list(self._flat_state) + (
                [self._flat_wd] if self._flat_wd is not None else [])
        else:
            trees = list(self._opt_state.values())
            trees += [st[0] for st in self._piece_state.values()]
        trees += self._ef_res[0] if self._ef_res else []
        total = 0
        for t in _leaves(trees):
            total += t.numel() * t.element_size()
        return total

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def place_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Copy a batch (dict, DataBatch or list aligned with the input
        names; numpy arrays, tensors or NDArrays) onto the device once;
        passing the result to :meth:`step` skips the copy.  Host tensors
        go to the card from pinned memory with ``non_blocking=True``, on
        the caller's current stream (``fit``'s prefetcher: its side
        stream).  Over several members the result also holds each
        member's rows on its device (``shards``, :meth:`_shard_batch`).
        Over a mesh that spans processes the batch is this process's
        rows: those of the data coordinates its members hold (the global
        batch viewed as ``[grad_accum, data, rows]``, this process's
        range of the data axis), as ``jax.make_array_from_process_local_
        data`` takes them; the whole batch when the data axis lies
        inside each process."""
        return self._place(batch, split=len(self._devices) > 1)

    def _place(self, batch, split: bool) -> Dict[str, torch.Tensor]:
        """:meth:`place_batch`, with each member's rows (``shards``) when
        ``split``."""
        if not self._bound:
            raise MXNetError("call bind() before placing or stepping a "
                             "batch")
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
                # on the CPU a copy into torch's (64-byte aligned)
                # memory: a CPU convolution's rounding follows its input's
                # alignment, and a program's static buffers are aligned
                v = (torch.as_tensor(np.asarray(v))
                     if self.device.type == "cuda"
                     else torch.tensor(np.asarray(v)))
            out[n] = _host_to(v, self.device)
        if split:
            out.shards = self._shard_batch(out)
        return out

    def _shard_batch(self, batch) -> List[Dict[str, torch.Tensor]]:
        """Each member's rows of a placed batch, on its device: the batch
        viewed as ``[grad_accum, data members, rows, ...]``, member ``i``
        taking ``[:, d]`` for its data coordinate ``d``, so that every
        microbatch is split over the data axis as the JAX trainer splits
        it and the members of a model group hold the same rows."""
        n, k = self._shard_n, self.grad_accum
        if len(self._devices) == 1:
            return [dict(batch)]
        shards: List[Dict[str, torch.Tensor]] = [{} for _ in self._devices]
        for name, v in batch.items():
            rest = tuple(v.shape[1:])
            b = v.shape[0] // (k * n)
            parts = v.reshape((k, n, b) + rest)
            for i, dev in enumerate(self._devices):
                piece = parts[:, self._shard_coord[i]].reshape(
                    (k * b,) + rest)
                shards[i][name] = (piece.to(dev, copy=True)
                                   if dev.type == "cpu"
                                   else piece.to(dev, non_blocking=True))
        return shards

    def _cast_params(self, params=None) -> Dict[str, torch.Tensor]:
        """The parameters (default the lead's) as the forward sees them:
        float32 ones cast to ``compute_dtype`` (a differentiable cast),
        the rest as they are."""
        params = self._params if params is None else params
        cdt = self.compute_dtype
        if cdt is None:
            return dict(params)
        return {n: (p.to(cdt) if p.dtype == torch.float32 else p)
                for n, p in params.items()}

    def step(self, batch) -> List[torch.Tensor]:
        """Run one training step; returns the head outputs.  ``batch`` may
        be host data or the result of :meth:`place_batch`."""
        return self._train(self.place_batch(batch))

    def _device_step(self, placed) -> Tuple[torch.Tensor, ...]:
        """The device work of one training step (a program's body):
        forward, backward and update for the update number and rate
        already in ``_t_dev``/``_lr_dev``; returns the heads."""
        # mesh-aware ops (RingAttention, MoEFFN) see the trainer's mesh
        with matmul_precision_scope(self.matmul_precision), \
                default_mesh(self.mesh):
            heads, grads, auxu, sq, new_ef = self._forward_backward(placed)
            self._finish_step(grads, auxu, sq, new_ef)
        return heads

    def _train(self, placed, carry=None):
        """One step, replayed or eager; with ``carry`` (``fit``'s accuracy
        fold) returns ``(heads, new carry)``."""
        kind = "train" if carry is None else "train_acc"
        with self._step_lock:
            self._in_step = True
            try:
                self._num_update += 1
                self._fill_step_scalars()
                prog = self._program_for(kind, placed)
                if prog is not None:
                    outs = self._replay(prog, placed, carry)
                    heads = outs if carry is None else outs[0]
                    carry = None if carry is None else outs[1]
                else:
                    heads = self._device_step(placed)
                    if carry is not None:
                        carry = _acc_fold(
                            carry, heads,
                            [placed[ln] for ln in self._label_names])
            finally:
                self._in_step = False
        if self._deferred_save is not None:
            self._run_deferred_save()
        return list(heads) if carry is None else (list(heads), carry)

    def _fill_step_scalars(self) -> None:
        """The step's host scalars into their 0-d tensors (a fill kernel
        each: no copy, no wait), outside any program."""
        self._lr_dev.fill_(self._lr_now())
        self._t_dev.fill_(float(self._num_update))

    def _run_deferred_save(self) -> None:
        """The save a signal asked for mid-step, now that the step is
        whole.  Under ``fit`` with the same (preempted) manager the batch
        boundary's forced save takes it instead, with the metric's
        carry."""
        args, self._deferred_save = self._deferred_save, None
        manager = args[0]
        if manager is self._fit_manager and manager.preempted:
            return
        self.save_state(*args)
        manager.deferred_save_done()

    def _step_acc(self, batch, carry: torch.Tensor):
        """:meth:`step`, then the ``Accuracy`` fold of each labelled head
        into ``carry`` (a 0-d int32 tensor on the device): ``fit``'s
        metric path, with no read back to the host."""
        return self._train(self.place_batch(batch), carry)

    def _lr_now(self) -> float:
        """The rate of update number ``self._num_update``: the schedule's
        (or the optimizer's) times the sentinel's backoff."""
        opt = self.optimizer
        return float(opt.lr_scheduler(self._num_update) if opt.lr_scheduler
                     else opt.lr) * self._lr_scale

    def _apply_update(self, grads: Optional[Dict[str, torch.Tensor]],
                      auxu: Dict[str, torch.Tensor], sq=None,
                      buckets=None):
        """The update half of the JAX ``train_step`` for update number
        ``self._num_update``: guard scalars, then the fused, unfused or
        ZeRO optimizer step, then the aux states.  The explicit mode
        passes the guard's square sum ``sq`` taken over its reduced
        buckets, and with the fused update the buckets themselves
        (``grads`` None).  Returns the guard's verdict (None without
        the guard)."""
        resil = self._resil
        if not self._fused and grads is not None:
            # the program auditor's anchors (identity; no op)
            grads = mark_grads(grads)
        with torch.no_grad():
            ok = mult = eff_norm = None
            if resil is not None:
                if sq is None:
                    sq = resilience.tree_sq_sum(self._whole_grads(grads))
                ok = torch.isfinite(sq)
                eff_norm = torch.sqrt(sq) * float(
                    abs(self._rescale_grad) or 1.0)
                if resil.scaling:
                    # the unscale folds into the one combined multiplier
                    inv_scale = self._c_one / self._guard_state["scale"]
                    eff_norm = eff_norm * inv_scale
                    mult = inv_scale
                if resil.clip_global_norm is not None:
                    coef = torch.minimum(
                        self._c_one,
                        self._c_clip / torch.maximum(eff_norm,
                                                     self._c_tiny))
                    mult = coef if mult is None else mult * coef
                if mult is not None and not self._fused:
                    grads = {n: _tree_scale(g, mult)
                             for n, g in grads.items()}
            if self._fused:
                self._fused_apply(grads, mult, ok, buckets)
            elif self.shard_optimizer:
                self._zero_apply(grads, ok)
            else:
                self._unfused_apply(grads, ok)
            # state is written in place: a captured step reads and
            # writes the storage it was captured over
            if resil is not None:
                for k, v in auxu.items():
                    self._aux[k].copy_(torch.where(ok, v, self._aux[k]))
                _copy_tree(self._guard_state, resilience.state_update(
                    self._guard_state, ok, eff_norm, resil))
            else:
                for k, v in auxu.items():
                    self._aux[k].copy_(v)
        return ok

    def _fused_apply(self, grads, mult, ok, buckets=None) -> None:
        """The hopper form: one kernel launch a step over the gradients
        in plan order; the bucket form: a gather into one flat gradient
        and one launch per bucket, or with ``buckets`` (the explicit
        mode's reduced flat buckets, in plan order) a launch per bucket
        over them as they are.  The scalar chain mirrors the unfused step
        op for op, so the result is bitwise the same."""
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
        if buckets is None and self._fused_route == "hopper":
            # the program auditor's anchors: each gradient tagged with
            # the plan buckets it lies in (identity; no op)
            for n in order:
                for label in self._bucket_labels[n]:
                    tag(grads[n], label)
            fu.fused_update_params([grads[n] for n in order], self._flat_w,
                                   self._flat_state, self._chunk_plan,
                                   scalars, wd_vec=self._flat_wd, **common)
            return
        if buckets is None:
            g_flat = torch.cat([grads[n].reshape(-1) for n in order])
            buckets = [g_flat[b0:b1_] for b0, b1_ in self._bucket_bounds]
        for i, (g, (b0, b1_)) in enumerate(zip(buckets,
                                               self._bucket_bounds)):
            tag(g, f"gradbucket:{i}")
            fu.fused_update(
                g, self._flat_w[b0:b1_],
                tuple(s[b0:b1_] for s in self._flat_state), scalars,
                wd_vec=(None if self._flat_wd is None
                        else self._flat_wd[b0:b1_]),
                form="bucket", **common)

    def _whole_grads(self, grads) -> Dict[str, torch.Tensor]:
        """``grads`` with each rule-sharded parameter's pieces end to end
        on the lead's device (the guard's square sum is the whole
        gradient's)."""
        out = dict(grads)
        out.update(self._wholes({n: g for n, g in grads.items()
                                 if not isinstance(g, torch.Tensor)}))
        return out

    def _tp_apply(self, grads, ok) -> None:
        """The rule-sharded parameters' update: each piece's lead runs
        ``optimizer._functional_step`` on its piece with its piece of
        the state (elementwise: the pieces of the whole update), gated
        by ``ok``."""
        if not self._pieces:
            return
        opt = self.optimizer
        hyper = opt._hyper()
        hyper["rescale_grad"] = self._rescale_grad
        step_fn = type(opt)._functional_step
        scalars: Dict[torch.device, Tuple] = {}
        for n, lay in self._pieces.items():
            for t, j in enumerate(lay.leads):
                dev = self._devices[j]
                if dev not in scalars:
                    scalars[dev] = (self._lr_dev.to(dev),
                                    self._t_dev.to(dev),
                                    None if ok is None else ok.to(dev))
                lr, tt, okd = scalars[dev]
                p, state = self._member_params(j)[n], self._piece_state[n][t]
                w2, s2 = step_fn(hyper, p, grads[n][t].to(dev), state,
                                 lr * float(self._lr_mult[n]),
                                 opt.wd * self._wd_mult[n], tt,
                                 self._step_rng)
                if okd is not None:
                    w2 = torch.where(okd, w2, p)
                    s2 = _gate(okd, s2, state)
                p.copy_(w2)
                _copy_tree(state, s2)

    def _unfused_apply(self, grads, ok) -> None:
        """Per parameter: ``optimizer._functional_step``, gated by
        ``where(ok, new, old)``, written back in place."""
        opt = self.optimizer
        hyper = opt._hyper()
        hyper["rescale_grad"] = self._rescale_grad
        step_fn = type(opt)._functional_step
        lrs: Dict[float, torch.Tensor] = {}
        self._tp_apply(grads, ok)
        for n in self._param_names:
            if n in self._pieces:
                continue
            p = self._params[n]
            m = float(self._lr_mult[n])
            if m not in lrs:
                lrs[m] = self._lr_dev * m
            w2, s2 = step_fn(hyper, p, grads[n], self._opt_state[n], lrs[m],
                             opt.wd * self._wd_mult[n], self._t_dev,
                             self._step_rng)
            if ok is not None:
                w2 = torch.where(ok, w2, p)
                s2 = _gate(ok, s2, self._opt_state[n])
            p.copy_(w2)
            _copy_tree(self._opt_state[n], s2)

    # ------------------------------------------------------------------
    # The step over the mesh members: forward, backward, reductions, ZeRO
    # ------------------------------------------------------------------

    def _forward_backward(self, placed):
        """Training forward and backward over the mesh members (the JAX
        ``train_step``, with its manual region in explicit mode): per
        microbatch, every member's forward and backward on its rows, the
        gradients reduced over the members and summed over microbatches.
        Each head's cotangent is ones, or the loss scale.  Returns
        ``(heads, grads, aux updates, square sum, new residuals)``: the
        heads in the batch's row order on the lead's device; ``grads``
        per parameter, or with :meth:`_bucket_out` the reduced flat
        buckets in plan order; the guard's square sum over the reduced
        buckets (explicit mode without ``grad_accum``, else None); the
        members' new error-feedback residuals (or None).  One member runs
        in this thread, and its step can be captured as a graph."""
        shards = placed.shards if getattr(placed, "shards", None) \
            else self._shard_batch(placed)
        n, k = len(self._devices), self.grad_accum
        explicit = self.grad_compression is not None
        ef = bool(self._ef_res)
        bucket_out = self._bucket_out()
        scale = (self._guard_state["scale"]
                 if self._resil is not None and self._resil.scaling
                 else None)
        step_key = mix(self._seed, self._num_update)
        auxs = [dict(self._member_aux(i)) for i in range(n)]
        heads_k: List[List[Tuple[torch.Tensor, ...]]] = []
        grads = sq = new_ef = None
        auxu: Dict[str, torch.Tensor] = {}
        for j in range(k):
            if k == 1:
                mbs, key = shards, step_key
            else:
                mbs = [{nm: v.reshape((k, v.shape[0] // k) + v.shape[1:])[j]
                        for nm, v in sh.items()} for sh in shards]
                key = mix(step_key, 0xACC, j)
            heads_j, aux_j, member_grads = self._run_members(
                mbs, auxs, key, scale, local=explicit)
            heads_k.append(heads_j)
            if explicit:
                red, sq_j, new_ef = self._reduce_explicit(
                    [member_grads[i] for i in self._col0],
                    self._ef_res if ef else None, bucket_out)
                if k == 1:
                    sq = sq_j
            else:
                red = self._reduce_implicit(member_grads)
            if grads is None:
                grads = red
            else:
                grads = {nm: _tree_add(grads[nm], red[nm]) for nm in grads}
            # the next microbatch sees this one's aux updates
            auxu.update(aux_j)
            for i in range(n):
                auxs[i].update({nm: v.to(self._devices[i])
                                for nm, v in aux_j.items()})
        heads = []
        for q in range(len(heads_k[0][0])):
            # a head of the global batch (a reduction over its rows, or a
            # 0-d value) is the same on every data member: the lead's
            scalar = heads_k[0][self._col0[0]][q].dim() == 0
            rows = ([self._col0[0]] if (q in self._global_heads or scalar)
                    and not explicit else self._col0)
            pieces = [hs[i][q] for hs in heads_k for i in rows]
            # microbatches' 0-d values stack into one a microbatch, as
            # the JAX trainer's scan stacks them
            join = torch.stack if scalar else torch.cat
            heads.append(pieces[0] if len(pieces) == 1 else
                         join([p.to(self.device) for p in pieces]))
        return tuple(heads), grads, auxu, sq, new_ef

    def _reduce_implicit(self, member_grads):
        """The members' gradients summed: a replicated parameter's over
        every member of model coordinate 0 (each model coordinate computes
        the whole sum; each data member the part of its rows, and each
        member of a seq, expert or pipe group a part of its group's: its
        share of the op's work, and member 0 the rest); a rule-sharded
        parameter's piece by piece, each over the members its
        :class:`_PieceLayout` names, on the piece's lead.  Over processes
        each process sums its own members (zeros where it has none) and
        the sums meet over the processes that hold the value: every
        process for a replicated parameter, a piece's holders for a
        piece (one all-reduce a set of processes, the sets in the same
        order everywhere)."""
        red: Dict[str, Any] = {}
        for nm in self._param_names:
            lay = self._pieces.get(nm)
            if lay is not None:
                red[nm] = [_sum_or_zeros([member_grads[i][nm] for i in grp],
                                         member_grads[lead][nm])
                           for grp, lead in zip(lay.contrib, lay.leads)]
            else:
                red[nm] = _sum_or_zeros([member_grads[i][nm]
                                         for i in self._rep_members],
                                        member_grads[0][nm])
        if self._procs is None:
            return red
        from . import dist
        jobs: Dict[Tuple[int, ...], list] = {}
        every = tuple(range(dist.process_count()))
        for nm in self._param_names:
            lay = self._pieces.get(nm)
            if lay is None:
                jobs.setdefault(every, []).append((nm, None))
            else:
                for t, holders in enumerate(lay.holders):
                    jobs.setdefault(holders, []).append((nm, t))
        for ranks in sorted(jobs):
            if len(ranks) < 2:
                continue
            keys = jobs[ranks]
            vals = [red[nm] if t is None else red[nm][t] for nm, t in keys]
            summed = collectives.allreduce_processes(
                vals, self.grad_bucket_bytes, axis=self._across(ranks),
                ranks=None if ranks == every else ranks)
            for (nm, t), v in zip(keys, summed):
                if t is None:
                    red[nm] = v
                else:
                    red[nm][t] = v
        return red

    def _across(self, ranks: Sequence[int]) -> str:
        """The mesh axes along which the boxes of processes ``ranks``
        differ, joined by ``+``: the axis a reduction over them crosses
        (``count_collectives``' ``axis``)."""
        boxes = [self._procs.boxes[q] for q in ranks]
        return "+".join(ax for k, ax in enumerate(self._procs.axes)
                        if len({b[k] for b in boxes}) > 1)

    def _bucket_out(self) -> bool:
        """Whether the explicit reduction hands its flat buckets straight
        to the fused update (K2's bucket form, no scatter back)."""
        return (self.grad_compression is not None and self._fused
                and self.grad_accum == 1)

    def _finish_step(self, grads, auxu, sq=None, new_ef=None) -> None:
        """The update from :meth:`_forward_backward`'s results: the lead's
        optimizer step and aux states, the error-feedback residuals, and
        the new state copied to the other members."""
        bucket_out = self._bucket_out()
        with torch.no_grad():
            ok = self._apply_update(None if bucket_out else grads, auxu,
                                    sq, grads if bucket_out else None)
            if new_ef is not None and self._ef_res:
                # a bad step keeps the old residual: the new one came from
                # non-finite gradients
                for i, (old, new) in enumerate(zip(self._ef_res, new_ef)):
                    okd = None if ok is None else ok.to(
                        self._data_devices[i])
                    for o, nw in zip(old, new):
                        o.copy_(nw if okd is None else torch.where(okd, nw, o))
            self._broadcast()

    def _run_members(self, mbs, auxs, key, scale, local: bool):
        """Forward and backward of every member on its rows ``mbs[i]``
        with aux states ``auxs[i]``.  ``local`` (explicit mode): each
        member's statistics are its own and its key is folded with its
        index; else (implicit mode) members whose graph has a cross-row
        statistic run in threads that meet there.  One backward over all
        members' heads.  Returns the heads per member, the aux updates
        (implicit: the lead's, which every member computed alike;
        explicit: their mean over members) and each member's gradients."""
        n = len(self._devices)
        for i in range(n):
            for p in self._member_params(i).values():
                p.grad = None
        # the members of a model group hold the same rows and draw alike
        fold = local or self._ndata > 1
        keys = [GraphKey(mix(key, self._dcoord[i]) if fold else key, dev,
                         self._member_generators(i))
                for i, dev in enumerate(self._devices)]
        plan = self._tp_plan
        gathers = {nm: lay.gathers for nm, lay in self._pieces.items()
                   if lay.gathers}

        def forward(i, sync):
            args = self._cast_params(self._member_params(i))
            tp_mod.gather_params(args, gathers, sync)
            args.update(mbs[i])
            return eval_symbol(
                self.symbol, args, auxs[i], keys[i], True, topo=self._topo,
                sync=sync, local=(plan if plan is not None
                                  and plan.plan == "split" else None))

        chain = None
        if local or not self._threaded or (n == 1 and not self._bridges):
            outs = [forward(i, None) for i in range(n)]
        else:
            # one token chain for every axis's cross-process meetings
            chain = TokenChain()
            bridges = {key: ProcessBridge(key, offset, size, line, chain)
                       for key, (offset, size, line)
                       in self._bridges.items()}
            outs = run_synced(forward, self._devices, self._groups,
                              self._row_reductions, bridges)
        live, cots = [], []
        if chain is not None and chain.token.grad_fn is not None:
            # every process runs the backward of every cross-process
            # link, in the links' order (members.ProcessBridge)
            live.append(chain.token)
            cots.append(torch.zeros_like(chain.token))
        for i, (heads, _) in enumerate(outs):
            sc = None if scale is None else scale.to(self._devices[i])
            if self._dupcoord[i] != 0:
                # a seq or expert group's members compute the same heads:
                # member 0's are differentiated, and the gradient reaches
                # the others through the op's gathered output
                continue
            for q, h in enumerate(heads):
                # a head of the global batch is differentiated once a
                # data group: its value depends on every member's rows
                if not local and q in self._global_heads \
                        and self._dcoord[i] != 0:
                    continue
                if h.requires_grad:
                    live.append(h)
                    cots.append(torch.ones_like(h) if sc is None
                                else sc.to(h.dtype).expand(h.shape))
        if live:
            # a process whose members differentiate no head (the seq or
            # expert coordinates past 0) still runs its links' backward
            torch.autograd.backward(live, cots)
        member_grads = []
        for i in range(n):
            g = {}
            for nm, p in self._member_params(i).items():
                g[nm] = (p.grad if p.grad is not None
                         else torch.zeros_like(p, requires_grad=False))
                p.grad = None
            member_grads.append(g)
        heads = [tuple(h.detach() for h in o[0]) for o in outs]
        gather = self._data_gather() if local else None
        if local and (n > 1 or gather is not None):
            # pmean of the aux updates over the data members, in order
            col = [outs[i] for i in self._col0]
            every = gather or (lambda parts: parts)
            auxu = {nm: psum(every([o[1][nm].detach() for o in col]))[0]
                    / self._ndata for nm in outs[0][1]}
        else:
            auxu = {nm: v.detach() for nm, v in outs[0][1].items()}
        return heads, auxu, member_grads

    def _member_generators(self, i: int) -> Dict[int, torch.Generator]:
        """Member ``i``'s cache of sampling generators (one a node)."""
        if i == 0:
            return self._node_generators
        gens = getattr(self, "_member_gens", None)
        if gens is None:
            gens = self._member_gens = {}
        return gens.setdefault(i, {})

    def _reduce_explicit(self, member_grads, ef_res, bucket_out: bool):
        """The JAX trainer's ``reduce_grads``: gradients in
        ``reversed(param_names)`` order, grouped by dtype, cut into flat
        buckets, each reduced by ``psum_compressed`` (with the members'
        residuals under error feedback); the guard's square sum over the
        reduced buckets.  Returns ``(per-parameter gradients or, with
        bucket_out, the reduced flat buckets in plan order, square sum,
        new residuals per member)``."""
        comp = self.grad_compression
        gather = self._data_gather()
        grads0 = member_grads[0]
        order = [nm for nm in reversed(self._param_names) if nm in grads0]
        by_dtype: Dict[Any, List[str]] = {}
        for nm in order:
            by_dtype.setdefault(grads0[nm].dtype, []).append(nm)
        out = dict(grads0)
        flat_buckets: List[torch.Tensor] = []
        new_ef: List[List[torch.Tensor]] = [[] for _ in member_grads]
        bidx = 0
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for dtype, names in by_dtype.items():
            names = [nm for nm in names if grads0[nm].numel() > 0]
            if not names:
                continue
            counts = [grads0[nm].numel() for nm in names]
            plan = plan_buckets(counts, grads0[names[0]].element_size(),
                                self.grad_bucket_bytes)
            pieces: Dict[str, List[torch.Tensor]] = {nm: [] for nm in names}
            for bucket in plan:
                flats = []
                for g in member_grads:
                    segs = [g[names[pi]].reshape(-1)[s0:s1]
                            for pi, s0, s1 in bucket]
                    flats.append(segs[0] if len(segs) == 1
                                 else torch.cat(segs))
                if ef_res is not None:
                    reds, nres = psum_compressed(
                        flats, comp, residuals=[r[bidx] for r in ef_res],
                        gather=gather)
                    for i, r in enumerate(nres):
                        new_ef[i].append(r)
                else:
                    reds = psum_compressed(flats, comp, gather=gather)
                bidx += 1
                red = reds[0]
                if self._resil is not None:
                    sq = sq + torch.sum(torch.square(red.to(torch.float32)))
                if bucket_out:
                    flat_buckets.append(red)
                    continue
                off = 0
                for pi, s0, s1 in bucket:
                    pieces[names[pi]].append(red[off:off + (s1 - s0)])
                    off += s1 - s0
            if bucket_out:
                continue
            for nm in names:
                ps = pieces[nm]
                flat = ps[0] if len(ps) == 1 else torch.cat(ps)
                out[nm] = flat.reshape(grads0[nm].shape)
        return (flat_buckets if bucket_out else out), \
            (sq if self._resil is not None else None), new_ef

    def _data_gather(self):
        """Over a data axis that spans processes, the explicit mode's
        meeting with the other processes of this process's data line: a
        function from this process's data members' tensors (one a member,
        one shape) to every data member's in data order, on the first
        tensor's device.  Each process sends its members' tensors in the
        wire format they come in (int8 payloads, fp8 as bytes, bf16).
        None when the data axis lies inside this process."""
        spec = self._bridges.get(DATA_AXIS)
        if spec is None:
            return None
        from . import dist
        line = spec[2]
        k = self._procs.axes.index(self.data_axis)
        extent = {q: self._procs.boxes[q][k][1] - self._procs.boxes[q][k][0]
                  for q in line}

        def gather(parts):
            one = (tuple(parts[0].shape), parts[0].dtype)
            got = dist.gather_tensors(
                parts, {q: [one] * extent[q] for q in line}, line,
                axis=self.data_axis, device=parts[0].device)
            return [t for q in line for t in got[q]]
        return gather

    def _zero_apply(self, grads, ok) -> None:
        """ZeRO: each member runs ``optimizer._functional_step`` on its
        slice of every parameter (flattened and padded where no dimension
        divides), with its state slice, gated by ``ok``; the updated
        slices are gathered into the lead's parameter."""
        opt = self.optimizer
        hyper = opt._hyper()
        hyper["rescale_grad"] = self._rescale_grad
        step_fn = type(opt)._functional_step
        n = self._ndata
        per_dev = [(self._lr_dev.to(d), self._t_dev.to(d),
                    None if ok is None else ok.to(d))
                   for d in self._data_devices]
        self._tp_apply(grads, ok)
        new: Dict[Tuple[str, int], torch.Tensor] = {}
        for nm in self._param_names:
            if nm in self._pieces:
                continue
            p = self._params[nm]
            dim = self._zero_dim(nm)
            ws = self._zero_view(nm, p.detach()).chunk(n, dim)
            gs = self._zero_view(nm, grads[nm]).chunk(n, dim)
            for j, (i, dev) in enumerate(zip(self._col0,
                                             self._data_devices)):
                d = self._dcoord[i]
                lr, t, okd = per_dev[j]
                w, g = ws[d].to(dev), gs[d].to(dev)
                state = self._zero_state[j][nm]
                w2, s2 = step_fn(hyper, w, g, state,
                                 lr * float(self._lr_mult[nm]),
                                 opt.wd * self._wd_mult[nm], t,
                                 self._step_rng)
                if okd is not None:
                    w2 = torch.where(okd, w2, w)
                    s2 = _gate(okd, s2, state)
                _copy_tree(state, s2)
                new[(nm, d)] = w2.to(self.device)
        # the other processes' slices: each from the first process that
        # holds its data coordinate
        new = self._collect(self._zero_items(
            lambda nm, d: new.get((nm, d)),
            lambda nm: self._zero_view(nm, self._params[nm].detach())),
            self.data_axis)
        for nm in self._param_names:
            if nm in self._pieces:
                continue
            p = self._params[nm]
            full = torch.cat([new[(nm, d)] for d in range(n)],
                             self._zero_dim(nm))
            if self._zero_flat[nm] is not None:
                full = full[:p.numel()].reshape(p.shape)
            p.copy_(full)

    def _zero_items(self, value, like, names=None) -> list:
        """:meth:`_collect`'s items for the slices of every ZeRO
        parameter (or of ``names``): ``(name, d)`` for data coordinate
        ``d``, held by the processes that hold that coordinate;
        ``value(name, d)`` is this process's slice (None where it holds
        none), ``like(name)`` a tensor of the cut layout's shape and
        type."""
        items = []
        for nm in (self._param_names if names is None else names):
            if nm in self._pieces:
                continue
            ref = like(nm)
            dim = self._zero_dim(nm)
            for d, piece in enumerate(ref.chunk(self._ndata, dim)):
                holders = (self._procs.holders(self.data_axis, d)
                           if self._procs is not None else (0,))
                items.append(((nm, d), holders, tuple(piece.shape),
                              ref.dtype, value(nm, d)))
        return items

    def forward(self, batch) -> List[torch.Tensor]:
        """Inference forward (moving statistics, no aux update)."""
        if not self._bound:
            raise MXNetError("call bind() before forward()")
        placed = self._place(batch, split=False)
        with self._step_lock:
            self._eval_count += 1
            prog = self._program_for("eval", placed)
            if prog is not None:
                return list(self._replay(prog, placed))
            return self._eval_forward(placed)

    def _eval_forward(self, placed) -> List[torch.Tensor]:
        """The device work of an inference forward (a program's body)."""
        key = GraphKey(mix(self._seed, 0x5EED, self._eval_count),
                       self.device, self._node_generators)
        k = self.grad_accum
        # a symbol built for the microbatch evaluates a microbatch at a
        # time, every one with the eval's key
        micro = ([placed] if k == 1 else
                 [{n: v.reshape((k, v.shape[0] // k) + v.shape[1:])[i]
                   for n, v in placed.items()} for i in range(k)])
        outs = []
        with torch.no_grad(), matmul_precision_scope(self.matmul_precision), \
                default_mesh(self.mesh):
            args = self._cast_params(self._whole_params())
            for mb in micro:
                args.update(mb)
                heads, _ = eval_symbol(self.symbol, args, self._aux, key,
                                       False, topo=self._topo)
                outs.append(heads)
        return [torch.cat(hs) if k > 1 else hs[0] for hs in zip(*outs)]

    # ------------------------------------------------------------------
    # Programs: captured steps (the JAX trainer's ahead-of-time compile)
    # ------------------------------------------------------------------

    def _batch_signature(self, batch) -> Tuple:
        return tuple((n, tuple(batch[n].shape), batch[n].dtype)
                     for n in self._input_names)

    def _program_for(self, kind: str, placed):
        """The installed program of ``kind`` when ``placed`` has its batch
        signature; a mismatch drops it (once) and the step runs eagerly,
        as the JAX trainer falls back to jit."""
        ent = self._aot.get(kind)
        if ent is None:
            return None
        prog, sig = ent
        if self._batch_signature(placed) == sig:
            return prog
        self._aot.pop(kind, None)
        self.aot_stats["fallbacks"] += 1
        telemetry.counter("trainer.aot_fallbacks").inc()
        self.logger.warning(
            "program %r does not match this batch (%s against %s); "
            "running eagerly", kind, self._batch_signature(placed), sig)
        return None

    def _replay(self, prog, placed, carry=None):
        """Stage the batch (and the carry) into the program's static
        buffers, run it, and clone what it returns: the next replay
        overwrites the static outputs."""
        prog.stage({n: placed[n] for n in self._input_names})
        if carry is not None:
            prog.stage({"_carry": carry})
        outs = prog()
        self.aot_stats["hits"] += 1
        telemetry.counter("trainer.aot_hits").inc()
        return _clone_tree(outs)

    def _state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes: weights, optimizer state (ZeRO's
        slices), error-feedback residuals, aux, guard state, the step
        scalars."""
        if self._fused:
            ts = [self._flat_w, *self._flat_state]
        else:
            ts = [p.detach() for p in self._params.values()]
            ts += _leaves(self._zero_state if self.shard_optimizer
                          else self._opt_state)
        ts += _leaves(self._piece_state)
        ts += _leaves(self._ef_res)
        ts += list(self._aux.values())
        if self._guard_state is not None:
            ts += list(self._guard_state.values())
        return ts + [self._lr_dev, self._t_dev]

    def _written_tensors(self) -> List[torch.Tensor]:
        """What a step body writes: :meth:`_state_tensors` and the other
        members' replicas (which the step broadcasts into)."""
        ts = self._state_tensors()
        for rep in self._replicas:
            ts += ([rep["flat_w"]] if self._fused else
                   [p.detach() for p in rep["params"].values()])
            ts += list(rep["aux"].values())
        return ts

    def _owned_tensors(self) -> List[torch.Tensor]:
        """Every tensor of this trainer a step body reads or writes: what
        a program's trace declares as its state (the rest it reads are
        captured constants)."""
        ts = self._written_tensors()
        ts += [p.detach() for p in self._params.values()]
        ts += [self._c_one, self._c_tiny]
        if self._resil is not None and self._c_clip is not None:
            ts.append(self._c_clip)
        if self._fused:
            if self._flat_wd is not None:
                ts.append(self._flat_wd)
            ts.append(self._chunk_plan.device_chunks(self.device))
        return ts

    def _uncapturable(self) -> Optional[str]:
        if self._procs is not None:
            return ("a mesh that spans processes runs eagerly: over gloo "
                    "its meetings and reductions run on the host, which a "
                    "CUDA graph cannot hold; over NCCL (one card a "
                    "process) a graph could hold them, which is not "
                    "ported (it needs two cards)")
        if len(self._devices) > 1:
            return ("a mesh path over several members runs eagerly (a CUDA "
                    "graph holds one device's work; the members' threads "
                    "meet on the host)")
        why = cc.graph_uncapturable(self._topo)
        if why is None and self.optimizer._needs_rng:
            why = (f"optimizer {type(self.optimizer).__name__} draws noise "
                   "from a generator each step; a replay would repeat it")
        return why

    def _program_key(self, kind: str, batch_avals) -> cc.CacheKey:
        """Key of one step program: graph fingerprint, the state's and the
        batch's avals, every trainer setting that changes the step, and
        this trainer's token (a graph reads this trainer's storage)."""
        from ..graph_eval import graph_fingerprint
        if self._graph_fp is None:
            self._graph_fp = graph_fingerprint(self.symbol, topo=self._topo)
        extra = {
            "kind": kind,
            "owner": cc.owner_token(self),
            "optimizer": type(self.optimizer).__name__,
            "hyper": sorted(self.optimizer._hyper().items()),
            "rescale_grad": self._rescale_grad,
            "lr_mult": sorted(self._lr_mult.items()),
            "wd_mult": sorted(self._wd_mult.items()),
            "grad_accum": self.grad_accum,
            "compute_dtype": str(self.compute_dtype),
            "matmul_precision": self.matmul_precision,
            "grad_bucket_bytes": self.grad_bucket_bytes,
            "fused": self._fused_kind if self._fused else None,
            "fused_wd_vec": bool(self._fused and not self._fused_wd_uniform),
            "fused_route": self._fused_route if self._fused else None,
            "data_axis": self.data_axis,
            "shard_optimizer": self.shard_optimizer,
            "grad_compression": self.grad_compression,
            "error_feedback": self.error_feedback,
            "rules": sorted((n, str(self.rules.spec_for(n)))
                            for n in self._param_names),
            "tp_plan": (self._tp_plan.plan if self._tp_plan is not None
                        else None),
            "resilience": (self._resil.describe()
                           if self._resil is not None else None),
        }
        avals = {"state": self._state_tensors(), "batch": batch_avals}
        donate = () if kind == "eval" else (0, 1, 2)
        return cc.program_key(self._graph_fp, avals, donate=donate,
                              backend=cc.backend_of(self.device),
                              mesh=self.mesh, extra=extra)

    def _norm_batch_spec(self, spec) -> Dict[str, Tuple[Tuple, Any]]:
        """One batch spec -> ``{input: (shape, torch dtype)}``: each value
        a shape, ``(shape, dtype)`` or an example array (float32 when no
        dtype is given)."""
        out = {}
        for n in self._input_names:
            if n not in spec:
                raise MXNetError(f"batch_spec missing input {n!r}")
            v = spec[n]
            if isinstance(v, tuple) and len(v) == 2 \
                    and isinstance(v[0], (tuple, list)):
                shape, dtype = tuple(v[0]), v[1]
            elif hasattr(v, "shape") and hasattr(v, "dtype"):
                shape, dtype = tuple(v.shape), v.dtype
            else:
                shape, dtype = tuple(v), torch.float32
            if not isinstance(dtype, torch.dtype):
                dtype = torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
            out[n] = (shape, dtype)
        return out

    def _program_body(self, kind: str, b_spec):
        """The static input buffers (zeros of ``b_spec``'s shapes; and
        ``train_acc``'s int32 carry) and the body of a ``kind`` program:
        the device work of one step (``train``), the step and the
        accuracy fold (``train_acc``) or the inference forward
        (``eval``)."""
        dev = self.device
        static = {n: torch.zeros(s, dtype=dt, device=dev)
                  for n, (s, dt) in b_spec.items()}
        batch = dict(static)
        if kind == "train":
            def body():
                return self._device_step(batch)
        elif kind == "train_acc":
            static["_carry"] = torch.zeros((), dtype=torch.int32, device=dev)

            def body():
                heads = self._device_step(batch)
                return heads, _acc_fold(
                    static["_carry"], heads,
                    [batch[ln] for ln in self._label_names])
        elif kind == "eval":
            def body():
                return tuple(self._eval_forward(batch))
        else:
            raise MXNetError(f"unknown program kind {kind!r} "
                             "(train/train_acc/eval)")
        return static, body

    def trace_program(self, kind: str = "train", batch_spec=None):
        """Record one run of a step program's body for the program
        auditor (:func:`mxnet_tpu_torch.analysis.audit_trainer`): the body
        :meth:`compile` captures, run once on the trainer's device over
        zero batches of ``batch_spec``'s shapes (default: the bound
        ones) under the step lock.  Every tensor the body writes and the
        random state are restored afterwards, so the trainer is left
        bitwise as it was; the kernels it launches are counted.  Returns
        ``(trace, batch spec)``: the
        :class:`~mxnet_tpu_torch.analysis.program.ProgramTrace` and the
        normalized ``{input: (shape, dtype)}``."""
        if not self._bound:
            raise MXNetError("call bind() before trace_program()")
        spec = batch_spec if batch_spec is not None else self._input_shapes
        b_spec = self._norm_batch_spec(spec)
        static, body = self._program_body(kind, b_spec)
        with self._step_lock:
            trace = record_program(
                f"trainer.{kind}", body, self.device, inputs=static,
                state=self._owned_tensors(),
                preserve=lambda: cc.snapshot_state(self._written_tensors()))
        return trace, b_spec

    def compile(self, batch_spec=None, programs=("train",),
                background: bool = False):
        """Capture the step programs for known batch shapes, each resolved
        through the global :class:`~mxnet_tpu_torch.compile_cache.
        ProgramCache`.

        ``batch_spec``: ``{input name: shape | (shape, dtype) | example
        array}`` (default: the bound shapes at float32), or a list of
        such dicts.  ``programs`` from ``train``, ``train_acc`` (``fit``'s
        accuracy fold) and ``eval``.  The last program resolved per kind
        is installed: :meth:`step`, ``fit`` and :meth:`forward` replay
        it for batches of its signature.  Returns the per-program infos
        (``kind``, ``source``, ``seconds``, ``digest``, and ``reason``
        for an eager program), also kept in ``compile_info``; with
        ``background=True`` the captures run on a daemon thread (steps
        wait while it captures) and the started thread is returned.  The state is left
        bitwise as it was."""
        if not self._bound:
            raise MXNetError("call bind() before compile()")
        specs = batch_spec if batch_spec is not None else self._input_shapes
        if isinstance(specs, dict):
            specs = [specs]
        work = []
        for spec in specs:
            b_spec = self._norm_batch_spec(spec)
            for kind in programs:
                if kind not in ("train", "train_acc", "eval"):
                    raise MXNetError(f"unknown program kind {kind!r} "
                                     "(train/train_acc/eval)")
                work.append((kind, b_spec))

        def compile_one(kind, b_spec):
            dev = self.device
            key = self._program_key(kind, {
                n: torch.empty(s, dtype=dt, device="meta")
                for n, (s, dt) in b_spec.items()})

            def build():
                static, body = self._program_body(kind, b_spec)
                if self._graph_pool is None and dev.type == "cuda":
                    self._graph_pool = torch.cuda.graph_pool_handle()
                prog = cc.CapturedProgram(
                    f"trainer.{kind}", body, dev,
                    preserve=lambda: cc.snapshot_state(
                        self._written_tensors()),
                    pool=self._graph_pool, reason=self._uncapturable(),
                    inputs=static, state=self._owned_tensors)
                with self._step_lock:
                    return prog.build()

            prog, info = cc.get_cache().get_or_compile(
                key, build, label=f"trainer.{kind}")
            self._aot[kind] = (prog, tuple(
                (n, tuple(b_spec[n][0]), b_spec[n][1])
                for n in self._input_names))
            info = dict(info, kind=kind)
            self.compile_info.append(info)
            return info

        if background:
            def run():
                for kind, b_spec in work:
                    try:
                        compile_one(kind, b_spec)
                    except Exception:
                        self.logger.exception(
                            "background compile of %r failed", kind)
            th = threading.Thread(target=run, daemon=True,
                                  name="mxnet-tpu-torch-compile")
            th.start()
            return th
        return [compile_one(kind, b_spec) for kind, b_spec in work]

    # ------------------------------------------------------------------
    # Param access
    # ------------------------------------------------------------------

    def _collect(self, items, axis: Optional[str] = None
                 ) -> Dict[Any, torch.Tensor]:
        """Values that some processes hold, on every process.  ``items``
        lists ``(key, holders, shape, dtype, tensor)`` in the same order
        on every process (``tensor`` this process's copy, None where it
        holds none); a value every process holds stays as it is, any
        other is sent by the first of its holders, as a tensor (every
        process knows every size: one all-gather a dtype), and comes
        back on this trainer's device.  ``axis`` labels the records
        (``count_collectives``; default the axes the processes' boxes
        differ along)."""
        out = {it[0]: it[4] for it in items}
        if self._procs is None:
            return out
        from . import dist
        me, nproc = self._procs.me, dist.process_count()
        axis = axis or self._across(range(nproc))
        by_dtype: Dict[torch.dtype, list] = {}
        for it in items:
            if len(it[1]) < nproc:
                by_dtype.setdefault(it[3], []).append(it)
        for its in by_dtype.values():
            specs = {q: [(tuple(it[2]), it[3]) for it in its
                         if it[1][0] == q] for q in range(nproc)}
            got = dist.gather_tensors(
                [it[4].detach().to(self.device, copy=True) for it in its
                 if it[1][0] == me], specs, axis=axis, device=self.device)
            for q, vals in got.items():
                for it, v in zip([it for it in its if it[1][0] == q], vals):
                    out[it[0]] = v
        return out

    def _wholes(self, named: Dict[str, list]) -> Dict[str, torch.Tensor]:
        """Rule-sharded parameters (or state leaves), each given as this
        process's pieces (one a slot), put together on the lead's device;
        pieces held by other processes come through :meth:`_collect`."""
        items = []
        for name, pieces in named.items():
            lay = self._pieces[name]
            for p, holders in enumerate(lay.gholders):
                t = (pieces[lay.number.index(p)] if p in lay.number
                     else None)
                shape = lay.sharding.shard_shape(self._shapes[name])
                items.append(((name, p), holders, shape,
                              pieces[0].dtype, t))
        got = self._collect(items)
        out = {}
        for name, pieces in named.items():
            lay = self._pieces[name]
            shape = self._shapes[name]
            if len(lay.gholders) == 1:
                out[name] = pieces[0]
                continue
            whole = pieces[0].new_empty(shape, device=self.device)
            for p, g in enumerate(lay.gfirst):
                whole[lay.sharding.index(g, shape)] = \
                    got[(name, p)].detach().to(self.device)
            out[name] = whole
        return out

    def _whole(self, name: str, pieces) -> torch.Tensor:
        """A rule-sharded parameter's (or state leaf's) pieces, one a
        slot, put together on the lead's device."""
        return self._wholes({name: pieces})[name]

    def _whole_params(self) -> Dict[str, torch.Tensor]:
        """The lead's parameters with every rule-sharded one whole."""
        out = dict(self._params)
        out.update(self._wholes({
            n: [self._member_params(j)[n] for j in lay.leads]
            for n, lay in self._pieces.items()}))
        return out

    def get_params(self) -> Tuple[Dict[str, NDArray], Dict[str, NDArray]]:
        """Host copies (NDArrays on the CPU) of parameters and aux
        states, rule-sharded parameters gathered whole."""
        arg = {n: nd_array(v.detach(), ctx=cpu())
               for n, v in self._whole_params().items()}
        aux = {n: nd_array(v, ctx=cpu()) for n, v in self._aux.items()}
        return arg, aux

    def set_params(self, arg_params, aux_params=None) -> None:
        """Copy values (numpy, tensors or NDArrays) into the parameters
        and aux states of the same names, in place."""
        with torch.no_grad():
            for n, v in (arg_params or {}).items():
                if n in self._pieces:
                    full = torch.from_numpy(np.ascontiguousarray(
                        v.asnumpy() if isinstance(v, NDArray)
                        else np.asarray(v)))
                    self._scatter_param(n, full)
                elif n in self._params:
                    NDArray(self._params[n].detach())[:] = v
            for n, v in (aux_params or {}).items():
                if n in self._aux:
                    NDArray(self._aux[n])[:] = v
        self._broadcast()

    def opt_state_by_param(self) -> Dict[str, Tuple[torch.Tensor, ...]]:
        """Optimizer state per parameter name, as a tuple of tensors in
        the optimizer's state order, whatever the layout (flat buckets on
        the fused path)."""
        out = {n: tuple(self._whole(n, [_leaves(st)[li] for st in states])
                        for li in range(len(_leaves(states[0]))))
               for n, states in self._piece_state.items()}
        if self.shard_optimizer:
            out.update({n: tuple(self._zero_gather(n, li) for li in range(
                len(_leaves(self._zero_state[0][n]))))
                for n in self._param_names if n not in self._pieces})
            return {n: out[n] for n in self._param_names}
        if not self._fused:
            for n, s in self._opt_state.items():
                if s is None:
                    out[n] = ()
                elif isinstance(s, torch.Tensor):
                    out[n] = (s,)
                else:
                    out[n] = tuple(s)
            return {n: out[n] for n in self._param_names}
        plan = self._fused_plan
        offs = plan.offsets
        return {n: tuple(s[offs[n]:offs[n] + int(np.prod(plan.shapes[n]))]
                         .view(plan.shapes[n]) for s in self._flat_state)
                for n in self._param_names}

    def _zero_gather(self, name: str, leaf: int,
                     padded: bool = False) -> torch.Tensor:
        """Leaf ``leaf`` of a parameter's ZeRO state, the data members'
        slices end to end on the lead's device (the other processes'
        through :meth:`_collect`): parameter-shaped, or with ``padded``
        in its cut layout (flat and padded where it is)."""
        mine = {self._dcoord[i]: _leaves(st[name])[leaf]
                for i, st in zip(self._col0, self._zero_state)}
        ref = self._zero_view(name, self._params[name].detach())
        got = self._collect(self._zero_items(
            lambda nm, d: mine.get(d), lambda nm: ref, [name]),
            self.data_axis)
        full = torch.cat([got[(name, d)].to(self.device)
                          for d in range(self._ndata)], self._zero_dim(name))
        if padded or self._zero_flat[name] is None:
            return full
        shape = self._params[name].shape
        return full[:int(np.prod(shape))].reshape(shape)

    # ------------------------------------------------------------------
    # Checkpoints: params, aux, optimizer state, update count, guard
    # ------------------------------------------------------------------

    def _opt_arrays(self) -> Dict[str, torch.Tensor]:
        """The optimizer state under the JAX trainer's names: unfused,
        ``opt:<param>:<leaf>``; fused, ``opt:fused:<bucket>:<leaf>``, each
        bucket a slice of the flat state buffers (the per-element weight
        decay vector is bind-time configuration, never saved)."""
        if self.shard_optimizer:
            # the JAX package's global arrays: the slices end to end
            out = {f"opt:{n}:{i}": self._zero_gather(n, i, padded=True)
                   for n in self._param_names if n not in self._pieces
                   for i in range(len(_leaves(self._zero_state[0][n])))}
            out.update({f"opt:{n}:{i}": leaf
                        for n, leaves in self.opt_state_by_param().items()
                        if n in self._pieces
                        for i, leaf in enumerate(leaves)})
        elif not self._fused:
            out = {f"opt:{n}:{i}": leaf
                   for n, leaves in self.opt_state_by_param().items()
                   for i, leaf in enumerate(leaves)}
        else:
            out = {f"opt:fused:{b}:{i}": flat[b0:b1]
                   for b, (b0, b1) in enumerate(self._bucket_bounds)
                   for i, flat in enumerate(self._flat_state)}
        # each data member's error-feedback residual of bucket b, end to
        # end (the other processes' through _collect)
        for b in range(len(self._ef_res[0]) if self._ef_res else 0):
            got = self._collect(self._efres_items(b), self.data_axis)
            out[f"opt:efres:{b}:0"] = torch.cat(
                [got[(b, d)].to(self.device) for d in range(self._ndata)])
        return out

    def _efres_items(self, b: int) -> list:
        """:meth:`_collect`'s items for bucket ``b``'s error-feedback
        residuals: ``(b, d)`` for data coordinate ``d``."""
        mine = {self._dcoord[i]: r[b] for i, r in zip(self._col0,
                                                      self._ef_res)}
        ref = self._ef_res[0][b]
        return [((b, d), (self._procs.holders(self.data_axis, d)
                          if self._procs is not None else (0,)),
                 tuple(ref.shape), ref.dtype, mine.get(d))
                for d in range(self._ndata)]

    def _scatter_opt_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Write restored ZeRO slices and residuals back to their
        members (the other optimizer arrays are views of live state)."""
        n = self._ndata
        dcoords = [self._dcoord[i] for i in self._col0]
        with torch.no_grad():
            for name in self._pieces:
                self._scatter_param(name, torch.from_numpy(
                    np.ascontiguousarray(arrays[f"param:{name}"])))
                for li in range(len(_leaves(self._piece_state[name][0]))):
                    full = torch.from_numpy(np.ascontiguousarray(
                        arrays[f"opt:{name}:{li}"]))
                    leads = self._pieces[name].leads
                    for j, st in zip(leads, self._piece_state[name]):
                        _leaves(st)[li].copy_(self._piece(full, name, j))
            for name in self._param_names if self.shard_optimizer else ():
                if name in self._pieces:
                    continue
                dim = self._zero_dim(name)
                for li in range(len(_leaves(self._zero_state[0][name]))):
                    full = torch.from_numpy(np.ascontiguousarray(
                        arrays[f"opt:{name}:{li}"]))
                    pieces = full.chunk(n, dim)
                    for st, d in zip(self._zero_state, dcoords):
                        _leaves(st[name])[li].copy_(pieces[d])
            for b in range(len(self._ef_res[0]) if self._ef_res else 0):
                key = f"opt:efres:{b}:0"
                if key not in arrays:
                    continue
                pieces = torch.from_numpy(
                    np.ascontiguousarray(arrays[key])).chunk(n)
                for res, d in zip(self._ef_res, dcoords):
                    res[b].copy_(pieces[d])

    def _scatter_param(self, name: str, full: torch.Tensor) -> None:
        """Write a rule-sharded parameter's whole value into its pieces'
        leads (:meth:`_broadcast` copies them on)."""
        for j in self._pieces[name].leads:
            self._member_params(j)[name].detach().copy_(
                self._piece(full, name, j))

    def _state_arrays(self) -> Dict[str, torch.Tensor]:
        """The full trainer state as ``{name: tensor}``: ``param:<n>``,
        ``aux:<n>`` and the optimizer's ``opt:`` arrays (views of the live
        buffers: :meth:`save_state` snapshots them at once)."""
        if not self._bound:
            raise MXNetError("call bind() before save_state/restore_state")
        whole = self._whole_params()
        arrays = {f"param:{n}": whole[n].detach()
                  for n in self._param_names}
        arrays.update({f"aux:{n}": self._aux[n] for n in self._aux_names})
        arrays.update(self._opt_arrays())
        return arrays

    def _state_meta(self, extra_meta=None, device_meta=None):
        """The checkpoint's meta, as a zero-argument function: the update
        count, the optimizer, the port's sampling seed (``torch_seed``:
        the JAX package's threefry ``rng_key`` has no use here), with the
        guard its six counters (windowed ones cumulative: host base plus
        the card's window), and ``device_meta``'s integer scalars.  The
        scalars on the card are queued for the host here in one copy,
        without waiting; the snapshot's one synchronize lands them before
        the manager calls the function."""
        meta = {"state": "sharded_trainer",
                "num_update": int(self._num_update),
                "optimizer": type(self.optimizer).__name__,
                "torch_seed": int(self._seed),
                "data_axis_size": self._ndata}
        if extra_meta:
            meta.update(extra_meta)
        keys, vals = [], []
        guarded = self._guard_state is not None
        if guarded:
            keys = list(resilience.STATE_KEYS)
            vals = [self._guard_state[k] for k in keys]
        for k, v in (device_meta or {}).items():
            keys.append(k)
            vals.append(v)
        if not vals:
            return lambda: meta
        vals = torch.stack([v.double().reshape(()) for v in vals])
        if vals.device.type == "cuda":
            host = torch.empty(vals.shape, dtype=vals.dtype,
                               pin_memory=True)
            host.copy_(vals, non_blocking=True)
        else:
            host = vals.clone()
        base = dict(self._resil_base)

        def finish():
            got = dict(zip(keys, host.tolist()))
            if guarded:
                meta["resilience"] = {
                    k: (int(got[k]) if k in resilience._INT_KEYS
                        else float(got[k])) + base.get(k, 0)
                    for k in resilience.STATE_KEYS}
            for k in (device_meta or {}):
                meta[k] = int(got[k])
            return meta

        return finish

    def save_state(self, manager, step: Optional[int] = None,
                   blocking: Optional[bool] = None,
                   extra_meta: Optional[Dict[str, Any]] = None) -> str:
        """Checkpoint the full trainer state (params, aux, optimizer
        state, update count, sampling seed, guard state) through a
        :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager`.  The copy
        from the card completes before this returns (the fused update
        writes its buffers in place, so the next step could overwrite
        them); the files are written on the manager's thread unless
        ``blocking``.

        Called mid-step (from a preemption hook: a signal handler runs
        between any two bytecodes), it saves nothing yet: the update
        count has moved and the weights may be half updated.  The save
        runs when the step ends, at the same update count.

        Over a mesh that spans processes every process calls it at the
        same update: each writes the values it is the first to hold and
        process 0 commits the manifest, on this thread, before it
        returns (:meth:`_save_processes`).  A preemption hook's call
        under :meth:`fit` with the same manager leaves the save to the
        next batch boundary, where the processes agree to save together
        (a signal reaches each process on its own)."""
        if self._procs is not None and manager is self._fit_manager \
                and manager.preempted:
            defer = getattr(manager, "defer_save", None)
            if defer is not None:
                defer()
            return manager.step_path(self._num_update)
        if self._in_step:
            self._deferred_save = (manager, step, blocking, extra_meta)
            defer = getattr(manager, "defer_save", None)
            if defer is not None:
                defer()
            self.logger.warning(
                "save_state: asked for inside update %d; deferred to the "
                "step's end", self._num_update)
            return manager.step_path(self._num_update if step is None
                                     else int(step))
        step = self._num_update if step is None else int(step)
        if self._procs is not None:
            return self._save_processes(manager, step,
                                        self._state_meta(extra_meta))
        return manager.save(step, self._state_arrays(),
                            meta=self._state_meta(extra_meta),
                            blocking=blocking)

    def _save_processes(self, manager, step: int, meta) -> str:
        """:meth:`save_state` over a mesh that spans processes: every
        process writes the pieces of the state that it is the first to
        hold, and process 0 commits the manifest of them all
        (``CheckpointManager.save_shards``); on the calling thread, every
        process at once."""
        from . import dist
        return manager.save_shards(
            step, self._state_shards(), meta=meta,
            exchange=dist.all_gather_object,
            process_index=self._procs.me,
            process_count=dist.process_count())

    def _state_shards(self) -> Dict[str, Tuple[Tuple[int, ...], list]]:
        """This process's share of the checkpoint over processes:
        ``{name: (global shape, [(index, tensor)])}`` for every array of
        :meth:`_state_arrays`, ``index`` the region (``[[start, stop],
        ...]``, None for all of it).  A value several processes hold is
        written by the first of them: a replicated array by process 0, a
        piece by the first of its holders, a ZeRO slice or a residual of
        data coordinate ``d`` by the first process that holds ``d``."""
        from ..checkpoint.layout import normalize_index
        me = self._procs.me
        out: Dict[str, Tuple[Tuple[int, ...], list]] = {}

        def whole(name, t):
            out[name] = (tuple(t.shape), [(None, t.detach())] if me == 0
                         else [])

        def pieces(name, pname, values):
            lay, shape = self._pieces[pname], self._shapes[pname]
            out[name] = (shape, [
                (normalize_index(lay.sharding.index(self._gidx[j], shape),
                                 shape), values[t].detach())
                for t, j in enumerate(lay.leads) if lay.holders[t][0] == me])

        def by_data(name, shape, dim, values):
            # values: {data coordinate: this process's slice}
            parts = []
            for d, t in sorted(values.items()):
                if self._procs.holders(self.data_axis, d)[0] != me:
                    continue
                index = [[0, int(x)] for x in shape]
                n = shape[dim] // self._ndata
                index[dim] = [d * n, (d + 1) * n]
                parts.append((index, t.detach()))
            out[name] = (tuple(shape), parts)

        for n in self._param_names:
            if n in self._pieces:
                pieces(f"param:{n}", n, [self._member_params(j)[n]
                                          for j in self._pieces[n].leads])
            else:
                whole(f"param:{n}", self._params[n])
        for n in self._aux_names:
            whole(f"aux:{n}", self._aux[n])
        for n, states in self._piece_state.items():
            for li in range(len(_leaves(states[0]))):
                pieces(f"opt:{n}:{li}", n, [_leaves(st)[li]
                                            for st in states])
        dcoords = [self._dcoord[i] for i in self._col0]
        if self.shard_optimizer:
            for n in self._param_names:
                if n in self._pieces:
                    continue
                shape = tuple(self._zero_view(
                    n, self._params[n].detach()).shape)
                for li in range(len(_leaves(self._zero_state[0][n]))):
                    by_data(f"opt:{n}:{li}", shape, self._zero_dim(n),
                            {d: _leaves(st[n])[li] for d, st in
                             zip(dcoords, self._zero_state)})
        elif self._fused:
            for b, (b0, b1) in enumerate(self._bucket_bounds):
                for i, flat in enumerate(self._flat_state):
                    whole(f"opt:fused:{b}:{i}", flat[b0:b1])
        else:
            for n, st in self._opt_state.items():
                for li, leaf in enumerate(_leaves(st)):
                    whole(f"opt:{n}:{li}", leaf)
        for b in range(len(self._ef_res[0]) if self._ef_res else 0):
            ln = self._ef_res[0][b].numel()
            by_data(f"opt:efres:{b}:0", (ln * self._ndata,), 0,
                    {d: r[b] for d, r in zip(dcoords, self._ef_res)})
        return out

    def restore_state(self, manager, step: Optional[int] = None
                      ) -> Tuple[Dict[str, Any], int]:
        """Restore the trainer state from ``manager`` (default: its newest
        step).  Returns ``(meta, step)``; the next :meth:`step` continues
        the saved run bitwise.  Every array this trainer holds must be in
        the checkpoint with its shape: a missing name (a fused checkpoint
        into an unfused trainer, another optimizer, another model) raises
        naming them, before anything is changed."""
        if not self._bound:
            raise MXNetError("call bind() before restore_state")
        from ..checkpoint import layout
        # over processes: the arrays' shapes (every process reads every
        # array it holds a part of and keeps its part)
        mine = (self._state_arrays() if self._procs is None
                else {n: torch.empty(shape) for n, (shape, _)
                      in self._state_shards().items()})
        manager.wait_until_finished()
        if step is None:
            step = manager.latest_step()
            if step is None:
                raise MXNetError(f"no committed checkpoint under "
                                 f"{manager.directory!r}")
        saved = layout.read_manifest(manager.step_path(step))["arrays"]
        missing = sorted(n for n in mine if n not in saved)
        if missing and all(n.startswith("opt:efres:") for n in missing):
            # a checkpoint from before error feedback: the residuals
            # stay at their bind-time zeros
            self.logger.warning(
                "restore_state: checkpoint has no error-feedback "
                "residuals; starting them at zero")
            mine = {n: v for n, v in mine.items() if n not in missing}
            missing = []
        if missing:
            raise MXNetError(
                f"restore_state: checkpoint step {step} lacks "
                f"{len(missing)} of this trainer's arrays: {missing[:8]} "
                "(a fused and an unfused trainer, another optimizer or "
                "another model do not share a layout)")
        arrays, meta, step = manager.restore(
            step=step, names=list(mine),
            target_shapes={n: tuple(v.shape) for n, v in mine.items()})
        if self._procs is None:
            with torch.no_grad():
                for n, dst in mine.items():
                    dst.copy_(torch.from_numpy(
                        np.ascontiguousarray(arrays[n])))
        else:
            self._restore_replicated(arrays)
        self._scatter_opt_arrays(arrays)
        self._broadcast()
        self._num_update = int(meta.get("num_update", step))
        if "torch_seed" in meta:
            self._seed = int(meta["torch_seed"])
        else:
            self.logger.warning(
                "restore_state: the checkpoint holds no torch_seed (it was "
                "written by the JAX package); sampling ops draw from this "
                "trainer's seed %d: their streams do not carry across "
                "packages", self._seed)
        if self._resil is not None and "resilience" in meta:
            # cumulative counters land in the host base; the card's
            # windows restart at zero, the scale and streak stay live
            base = resilience.init_state(self._resil, self.device)
            rs = meta["resilience"]
            self._resil_base = {k: 0 for k in resilience.WINDOW_KEYS}
            for k in resilience.STATE_KEYS:
                if k not in rs:
                    continue
                if k in resilience.WINDOW_KEYS:
                    self._resil_base[k] = (float(rs[k]) if k == "norm_sum"
                                           else int(rs[k]))
                else:
                    base[k].fill_(rs[k])
            _copy_tree(self._guard_state, base)
        self.logger.info("restore_state: resumed at update %d from %s",
                         self._num_update, manager.step_path(step))
        return meta, step

    def _restore_replicated(self, arrays: Dict[str, np.ndarray]) -> None:
        """Over processes: the restored arrays every process holds whole
        (replicated parameters, aux states, the unsharded optimizer
        state) into this process's copies; :meth:`_scatter_opt_arrays`
        writes the pieces and slices."""
        def put(dst, name):
            if name in arrays:
                dst.copy_(torch.from_numpy(
                    np.ascontiguousarray(arrays[name])))
        with torch.no_grad():
            for n in self._param_names:
                if n not in self._pieces:
                    put(self._params[n].detach(), f"param:{n}")
            for n in self._aux_names:
                put(self._aux[n], f"aux:{n}")
            if self._fused:
                for b, (b0, b1) in enumerate(self._bucket_bounds):
                    for i, flat in enumerate(self._flat_state):
                        put(flat[b0:b1], f"opt:fused:{b}:{i}")
            elif not self.shard_optimizer:
                for n, st in self._opt_state.items():
                    for li, leaf in enumerate(_leaves(st)):
                        put(leaf, f"opt:{n}:{li}")

    def restore_or_initialize(self, manager) -> Optional[int]:
        """Restore the manager's newest checkpoint if it has one (returning
        its step), else leave the bound state as it is and return None."""
        return manager.restore_or_initialize(
            lambda step: self.restore_state(manager, step=step)[1])

    # ------------------------------------------------------------------
    # Resilience: counter drain + divergence sentinel
    # ------------------------------------------------------------------

    def resilience_stats(self) -> Dict[str, Any]:
        """One-fetch snapshot of the guard counters (empty when the guard
        is off): the host-side base folded off the card by past sentinel
        drains plus the current on-card window, in one device-to-host
        copy.  Reading never resets anything."""
        if self._guard_state is None:
            return {}
        keys = resilience.STATE_KEYS
        with telemetry.span("guard.drain"):  # the one periodic device wait
            vals = dict(zip(keys, torch.stack(
                [self._guard_state[k].double() for k in keys]).cpu()
                .tolist()))
        base = self._resil_base
        stats = {
            "skipped_steps": base["skipped"] + int(vals["skipped"]),
            "overflow_steps": base["overflows"] + int(vals["overflows"]),
            "good_steps": int(vals["good"]),
            "loss_scale": float(vals["scale"]),
            "norm_sum": base["norm_sum"] + vals["norm_sum"],
            "norm_steps": base["norm_cnt"] + int(vals["norm_cnt"]),
            "lr_scale": self._lr_scale,
            "rollbacks": self._rollbacks,
            "num_update": self._num_update,
        }
        g = telemetry.gauge
        g("resilience.loss_scale").set(stats["loss_scale"])
        g("resilience.lr_scale").set(stats["lr_scale"])
        g("resilience.skipped_steps").set(stats["skipped_steps"])
        g("resilience.overflow_steps").set(stats["overflow_steps"])
        if stats["norm_steps"] > 0:
            g("resilience.grad_norm_mean").set(
                stats["norm_sum"] / stats["norm_steps"])
        return stats

    def _fold_guard_counters(self, stats: Dict[str, Any]) -> None:
        """Fold the on-card window counters into the host-side base (the
        snapshot ``stats`` already is base + window) and zero them on the
        card, so the float32 ``norm_sum`` never holds more than one
        window."""
        self._resil_base = {"skipped": stats["skipped_steps"],
                            "overflows": stats["overflow_steps"],
                            "norm_sum": stats["norm_sum"],
                            "norm_cnt": stats["norm_steps"]}
        for k in resilience.WINDOW_KEYS:
            self._guard_state[k].zero_()

    def _sentinel_poll(self, manager=None) -> Optional[str]:
        """Drain the guard counters and feed the divergence sentinel;
        ``fit`` calls it every ``GuardConfig.check_every`` batches.  On an
        anomaly the learning rate is backed off host-side; on a
        ``"rollback"`` with a checkpoint manager that holds a step, the
        trainer restores that step (without one it stays a backoff, as
        in the JAX trainer)."""
        stats = self.resilience_stats()
        if not stats:
            return None
        self._fold_guard_counters(stats)
        last, self._resil_drained = self._resil_drained, stats
        if not last:
            return None  # the first drain only baselines the counters
        steps = stats["num_update"] - last["num_update"]
        if steps <= 0:
            return None
        skipped = stats["skipped_steps"] - last["skipped_steps"]
        cnt = stats["norm_steps"] - last["norm_steps"]
        total = stats["norm_sum"] - last["norm_sum"]
        norm_mean = (total / cnt) if cnt > 0 else None
        if self._sentinel is None:
            self._sentinel = resilience.DivergenceSentinel(
                self._resil, logger=self.logger)
        action = self._sentinel.observe(norm_mean, skipped, steps)
        if action is None:
            return None
        self._lr_scale = max(self._lr_scale * self._resil.lr_backoff,
                             self._resil.min_lr_scale)
        if action == "rollback" and manager is not None \
                and manager.latest_step() is not None:
            if self._rollback_hook is not None:
                self._rollback_hook()
            restoring = getattr(manager, "restoring", None)
            with (restoring() if restoring is not None
                  else contextlib.nullcontext()):
                _, step = self.restore_state(manager)
            self._rollbacks += 1
            telemetry.counter("resilience.rollbacks").inc()
            telemetry.dump_flight(
                "divergence-rollback",
                extra={"restored_step": step, "lr_scale": self._lr_scale,
                       "norm_mean": norm_mean})
            # the guard counters rolled back with the state
            self._resil_drained = self.resilience_stats()
            self.logger.warning(
                "Resilience: rolled back to checkpoint at update %d, "
                "lr-scale=%g", step, self._lr_scale)
        else:
            telemetry.counter("resilience.backoffs").inc()
            self.logger.warning(
                "Resilience: LR backed off, lr-scale=%g", self._lr_scale)
        return action

    # ------------------------------------------------------------------
    # Training loop
    # ------------------------------------------------------------------

    def score(self, eval_data, eval_metric):
        """Run ``eval_data`` through :meth:`forward` into ``eval_metric``
        (a name or an EvalMetric, reset first); returns the metric."""
        from ..metric import create as metric_create
        if isinstance(eval_metric, str):
            eval_metric = metric_create(eval_metric)
        eval_metric.reset()
        eval_data.reset()
        for batch in eval_data:
            eval_metric.update(batch.label, self.forward(batch))
        return eval_metric

    def _fit_checkpoint(self, manager, am, epoch: int, nbatch: int) -> None:
        """:meth:`fit`'s per-batch checkpoint hook: a policy-gated (or
        preemption-forced) :meth:`save_state`, with the fused metric's
        carry in the meta so a resumed epoch's running metric is not
        zero."""

        def meta_fn():
            extra = {"epoch": epoch, "nbatch": nbatch}
            carry = None
            if am._dev_sum is not None:
                # the carry rides the guard counters' copy to the host
                extra["metric_num"] = int(am._dev_num)
                carry = {"metric_sum": am._dev_sum}
            return self._state_meta(extra, carry)

        if self._procs is not None:
            # every process writes its share at the same update, or none
            # does: a clock policy and a preemption signal are each
            # process's own, so one process's yes is every process's, and
            # a preemption stops them all at this batch
            from . import dist
            flags = dist.transport(torch.tensor(
                [manager.should_save(self._num_update), manager.preempted],
                dtype=torch.int32))
            save, preempted = (bool(v) for v in
                               collectives.allreduce_processes([flags])[0]
                               .tolist())
            manager.preempted = preempted
            if save:
                self._save_processes(manager, self._num_update, meta_fn())
        else:
            manager.maybe_save(self._num_update,
                               lambda: (self._state_arrays(), meta_fn()))
        if manager.preempted:
            manager.deferred_save_done()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            num_epoch: int = 1, begin_epoch: int = 0,
            batch_end_callback=None, epoch_end_callback=None,
            checkpoint_manager=None) -> None:
        """The JAX trainer's training loop: one step a batch, no host
        sync a batch.

        ``begin_epoch`` resumes the epoch numbering and advances the
        update count (the schedule's clock) past the epochs done, by
        ``train_data.steps_per_epoch`` (else ``ceil(num_data /
        batch_size)``).  With ``MXNET_TPU_CHAOS`` set, a ``ChaosIter``
        wraps ``train_data`` upstream of the prefetcher.  Each epoch logs
        ``Epoch[%d] Mesh-Train-<metric>=%f``, ``Step-total``, with the
        guard a ``Resilience:`` line, and with ``eval_data``
        ``Mesh-Validation-<metric>``; ``epoch_end_callback(epoch, symbol,
        arg_params, aux_params)`` gets host copies of the parameters.

        ``checkpoint_manager`` checkpoints inside the loop: after each
        step the manager's save policy may trigger a full
        :meth:`save_state` (the snapshot on this thread, the writes on the
        manager's), and a preemption (``manager.preempted``, set by its
        SIGTERM hook) forces a blocking save and stops the loop at the
        batch boundary; the sentinel's rollbacks restore from it."""
        from .. import chaos as chaos_mod
        from ..io import DevicePrefetchIter
        from ..metric import create as metric_create
        from ..model import BatchEndParam
        if isinstance(eval_metric, str):
            eval_metric = metric_create(eval_metric)
        if begin_epoch and self._num_update == self.optimizer.begin_num_update:
            # resume: advance the schedule's clock past the epochs done
            batches = getattr(train_data, "steps_per_epoch", None)
            if batches is None:
                nd_ = getattr(train_data, "num_data", None)
                bs = getattr(train_data, "batch_size", None)
                if nd_ and bs:
                    batches = -(-nd_ // bs)
            if batches is not None:
                self._num_update += begin_epoch * int(batches)
            else:
                self.logger.warning(
                    "fit(begin_epoch=%d): train_data has no steps_per_epoch"
                    " attribute, lr-schedule clock not advanced (set "
                    "optimizer.begin_num_update for exact resume)",
                    begin_epoch)
        am = _AsyncMetric(eval_metric, self.device)
        # chaos wraps upstream of the prefetch thread, so an injected
        # crash goes through the real retry path
        train_data = chaos_mod.maybe_wrap(train_data, logger=self.logger)
        prefetch = DevicePrefetchIter(train_data, place_fn=self.place_batch,
                                      device=self.device)
        check_every = (self._resil.check_every if self._resil is not None
                       else 0)
        # host cadence between step returns, with no device fetch
        t_last = time.perf_counter()
        self._fit_manager = checkpoint_manager
        try:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                am.reset()
                nbatch = 0
                prefetch.reset()
                fused = am.supports_fused and bool(self._label_names)
                nheads = len(self.symbol.list_outputs())
                ninst_names = self._label_names[:nheads]
                for cur in prefetch:
                    if fused:
                        outs, carry = self._step_acc(cur, am.take_carry())
                        am.put_carry(carry, sum(
                            int(np.prod(cur[n].shape)) for n in ninst_names))
                    else:
                        outs = self.step(cur)
                        lbls = ([cur[n] for n in self._label_names]
                                if self._label_names
                                else prefetch.current_source.label)
                        am.update_async(lbls, outs)
                    nbatch += 1
                    t_now = time.perf_counter()
                    drained = self._resil_drained
                    telemetry.record_step({
                        "step": self._num_update, "epoch": epoch,
                        "nbatch": nbatch,
                        "host_ms": (t_now - t_last) * 1e3,
                        "lr_scale": self._lr_scale,
                        "loss_scale": drained.get("loss_scale"),
                        "skipped_steps": drained.get("skipped_steps"),
                        "grad_norm_mean": (
                            drained["norm_sum"] / drained["norm_steps"]
                            if drained.get("norm_steps") else None),
                        "rollbacks": self._rollbacks,
                        "aot_hits": self.aot_stats["hits"],
                    })
                    t_last = t_now
                    if batch_end_callback is not None:
                        batch_end_callback(BatchEndParam(
                            epoch=epoch, nbatch=nbatch, eval_metric=am,
                            locals=locals()))
                    if checkpoint_manager is not None:
                        self._fit_checkpoint(checkpoint_manager, am, epoch,
                                             nbatch)
                        if checkpoint_manager.preempted:
                            self.logger.warning(
                                "fit: preemption signal received; state "
                                "saved at update %d, stopping "
                                "(restore_or_initialize resumes on "
                                "restart)", self._num_update)
                            checkpoint_manager.wait_until_finished()
                            return
                    if check_every and nbatch % check_every == 0:
                        self._sentinel_poll(checkpoint_manager)
                name, value = am.get()
                names = name if isinstance(name, list) else [name]
                values = value if isinstance(value, list) else [value]
                for n_, v_ in zip(names, values):
                    self.logger.info("Epoch[%d] Mesh-Train-%s=%f",
                                     epoch, n_, v_)
                self.logger.info("Epoch[%d] Step-total=%d Elapsed=%.3fs",
                                 epoch, nbatch, time.time() - tic)
                if self._resil is not None:
                    rs = self.resilience_stats()
                    # one line per epoch, grep-stable for tools/parse_log
                    self.logger.info(
                        "Epoch[%d] Resilience: skipped=%d overflows=%d "
                        "rollbacks=%d loss-scale=%g lr-scale=%g",
                        epoch, rs["skipped_steps"], rs["overflow_steps"],
                        rs["rollbacks"], rs["loss_scale"], rs["lr_scale"])
                    telemetry.emit("resilience", {"epoch": epoch, **rs})
                telemetry.flush_metrics()
                if epoch_end_callback is not None:
                    arg_p, aux_p = self.get_params()
                    epoch_end_callback(epoch, self.symbol, arg_p, aux_p)
                if eval_data is not None:
                    m = self.score(eval_data, eval_metric)
                    for name, value in [m.get()]:
                        self.logger.info("Epoch[%d] Mesh-Validation-%s=%s",
                                         epoch, name, value)
        except Exception:
            # the ring holds the steps leading into the failure
            telemetry.dump_flight("step-exception")
            raise
        finally:
            self._fit_manager = None
            # an abandoned epoch must not leave the prefetch thread alive
            # holding staged device buffers
            prefetch.close()


def _spec_axes(spec) -> List[str]:
    """The mesh axes a PartitionSpec names, in order."""
    return [a for ax in spec if ax is not None
            for a in ((ax,) if isinstance(ax, str) else tuple(ax))]


def _moe_expert_params(topo) -> Dict[str, str]:
    """``{parameter name: expert axis}`` for the expert weights and
    biases of every ``MoEFFN`` node, which the op reads as each member's
    own experts when they are cut over that axis."""
    out: Dict[str, str] = {}
    for node in topo:
        if node.is_variable or node.op.name != "MoEFFN":
            continue
        axis = node.parsed_params()["expert_axis"]
        for src, _ in node.inputs[2:6]:
            if src.is_variable:
                out[src.name] = axis
    return out


class _PieceLayout:
    """How the members of a trainer's mesh hold one rule-sharded
    parameter (its ``spec``, a :class:`NamedSharding` over the mesh):

    * ``of[i]``: the slot of member ``i``'s piece among this process's
      pieces; pieces are numbered over the whole mesh by the first member
      that holds each (``number[t]`` is slot ``t``'s);
    * ``contrib[t]``: this process's members whose gradients of piece
      ``t`` are summed: every member that holds it, of model coordinate 0
      when the spec does not cut over the model axis (each model
      coordinate computes the same function, so the same gradient; a
      data, seq, expert or pipe coordinate computes a part of it);
    * ``leads[t]``: the member that holds piece ``t``'s optimizer state
      and updates it (the first of this process's members that hold it:
      in one process the first of the contributors);
    * ``holders[t]``: the processes that hold piece ``t`` (each updates
      it alike from the sum over every process's contributors);
      ``gholders[p]`` and ``gfirst[p]`` are piece number ``p``'s holders
      and first member over the whole mesh;
    * ``gathers``: ``(dim, axis, to_owner)`` steps that give a member the
      value the graph reads, minor axis first within a dimension: a cut
      over the model axis is gathered with the others' pieces detached
      (the model group computes alike), a cut over any other axis with
      each piece differentiable into its owner (the group's members
      compute parts, so every part's gradient reaches the owner).  A cut
      the graph reads in pieces stays: the model axis under the split
      plan, and the expert axis on an ``MoEFFN`` expert weight's first
      dimension (the op runs each member's experts)."""

    __slots__ = ("spec", "sharding", "of", "number", "contrib", "leads",
                 "holders", "gholders", "gfirst", "gathers")

    def __init__(self, trainer, spec, shape, split: bool,
                 expert_axis: Optional[str]):
        mesh = trainer.mesh
        self.spec = spec
        self.sharding = NamedSharding(mesh, spec)
        keys = [tuple((sl.start, sl.stop)
                      for sl in self.sharding.index(g, tuple(shape)))
                for g in range(mesh.size)]
        number = {k: p for p, k in enumerate(dict.fromkeys(keys))}
        gof = [number[k] for k in keys]
        named = _spec_axes(spec)
        copies = trainer.model_axis is not None \
            and MODEL_AXIS not in named
        gm = (np.unravel_index(np.arange(mesh.size), mesh.devices.shape)
              [mesh.axis_names.index(MODEL_AXIS)]
              if MODEL_AXIS in mesh.axis_names else np.zeros(mesh.size))
        gproc = (trainer._procs.gproc if trainer._procs is not None
                 else [0] * mesh.size)
        local = trainer._gidx
        self.number = sorted({gof[g] for g in local})
        self.of = [self.number.index(gof[g]) for g in local]
        self.contrib = [[i for i, g in enumerate(local) if gof[g] == p
                         and not (copies and gm[g] != 0)]
                        for p in self.number]
        self.leads = [self.of.index(t) for t in range(len(self.number))]
        self.gholders = [tuple(sorted({gproc[g] for g in range(mesh.size)
                                       if gof[g] == p}))
                         for p in range(len(number))]
        self.gfirst = [gof.index(p) for p in range(len(number))]
        self.holders = [self.gholders[p] for p in self.number]
        self.gathers: List[Tuple[int, str, bool]] = []
        for d, ax in enumerate(spec):
            axes = () if ax is None else ((ax,) if isinstance(ax, str)
                                          else tuple(ax))
            for j in reversed(range(len(axes))):
                a = axes[j]
                if j == 0 and ((d == 0 and a == expert_axis)
                               or (split and a == MODEL_AXIS)):
                    break
                if mesh.shape[a] > 1:
                    self.gathers.append(
                        (d, DATA_AXIS if a == trainer.data_axis else a,
                         a != MODEL_AXIS))


def _synced_statistic(node) -> bool:
    """Whether an op node takes a statistic over the batch's rows that
    the implicit mode's members meet to compute (``OpContext.sync``):
    BatchNorm's moments, a normalized softmax loss's count, the KL
    sparseness penalty's batch mean."""
    name = node.op.name
    if name == "BatchNorm":
        return not node.parsed_params()["use_global_stats"]
    if name in ("SoftmaxOutput", "Softmax"):
        return node.parsed_params()["normalization"] != "null"
    return name == "IdentityAttachKLSparseReg"


# whole-array results: every row of the batch goes into one value
_WHOLE_ARRAY_OPS = ("sum", "max", "min", "norm", "softmax_cross_entropy")
# reductions over the axes named by their ``axis`` parameter
_AXIS_REDUCE_OPS = ("sum_axis", "max_axis", "min_axis")
# user code, whose rows the trainer cannot see
_OPAQUE_OPS = ("Custom", "_PythonOp")


def _batch_layout(sym, topo, input_shapes):
    """How the implicit mode evaluates ``topo`` over members that split
    the batch's rows (axis 0 of the tensors that depend on the inputs,
    shaped ``input_shapes``): ``(refusal, reductions, global heads,
    row_split)``, ``row_split(node, i)`` telling whether output ``i`` of
    a node is cut by rows.

    A whole-array reduction, or a reduction over the rows (``sum_axis``
    and its kin over axis 0), of a row-split value meets the other
    members (``reductions``: those nodes' names) and gives the global
    batch's value on every member; a head computed from such values only
    is one of the ``global heads`` (indices).  ``MoEFFN`` is such a node
    too: its routing (capacity and arrival order) is the global batch's,
    its output stays row-split and its aux loss (output 1) is a global
    value.  An op that moves rows (a transpose or reshape of them, a
    concat or slice along them, a product contracting over them) or user
    code over them has no member-by-member form: ``refusal`` describes
    the first, else it is None.  Tensors that
    do not depend on the batch (parameters) are the same on every
    member."""
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape_partial(**input_shapes)
    shape_of = {(id(n), i): s for (n, i), s in zip(internals._heads, outs)}
    rows = {id(n) for n in topo if n.is_variable and n.name in input_shapes}
    whole: set = set()
    # single outputs of the global batch: (node id, output index)
    whole_outs: set = set()
    reductions = set()

    def row_split(src, i) -> bool:
        return id(src) in rows and (id(src), i) not in whole_outs

    def global_value(src, i) -> bool:
        return id(src) in whole or (id(src), i) in whole_outs

    def leading(axes, node) -> bool:
        """Whether ``axes`` (an int or a tuple, negative from the end)
        name axis 0 of the node's first input (any negative axis when its
        rank is unknown)."""
        axes = (axes,) if isinstance(axes, int) else tuple(axes)
        shape = shape_of.get((id(node.inputs[0][0]), node.inputs[0][1]))
        return any(a == 0 or (a < 0 and (shape is None or a == -len(shape)))
                   for a in axes)

    for node in topo:
        if node.is_variable:
            continue
        deps = [row_split(src, i) for src, i in node.inputs]
        if not any(deps):
            if any(global_value(src, i) for src, i in node.inputs):
                whole.add(id(node))
            continue
        name = node.op.name
        p = node.parsed_params()
        what = None
        if name in _WHOLE_ARRAY_OPS or (name in _AXIS_REDUCE_OPS
                                        and leading(p["axis"], node)):
            whole.add(id(node))
            reductions.add(node.name)
            continue
        if name == "MoEFFN":
            reductions.add(node.name)
            rows.add(id(node))
            if p["aux_loss"]:
                whole_outs.add((id(node), 1))
            continue
        if name in _OPAQUE_OPS:
            what = "is user code over the whole batch"
        elif name == "Concat" and leading(p["dim"], node):
            what = f"concatenates along dim {p['dim']}"
        elif name in ("slice_axis", "SliceChannel", "flip", "broadcast_axis") \
                and leading(p["axis"], node):
            what = f"works along axis {p['axis']}"
        elif name == "expand_dims" and p["axis"] == 0:
            what = "puts a new axis before the rows"
        elif name == "SwapAxis" and p["dim1"] != p["dim2"] \
                and leading((p["dim1"], p["dim2"]), node):
            what = f"swaps axes {p['dim1']} and {p['dim2']}"
        elif name == "transpose" and (not p["axes"] or p["axes"][0] != 0):
            what = f"moves axis 0 (axes {p['axes'] or 'reversed'})"
        elif name == "Reshape":
            tgt = p["target_shape"] or p["shape"]
            if tgt and tgt[0] not in (0, -1):
                what = f"fixes the leading dimension ({tuple(tgt)})"
        elif name == "dot" and deps[1]:
            what = "contracts over a batch-dependent right operand"
        if what is not None:
            return f"op {name} ({node.name}) {what}", None, None, None
        rows.add(id(node))
    heads = frozenset(q for q, (n, i) in enumerate(sym._heads)
                      if global_value(n, i))
    return None, frozenset(reductions), heads, row_split


def _sum_or_zeros(parts: List[torch.Tensor], like: torch.Tensor):
    """:func:`~.collectives.psum` of ``parts`` (on the first part's
    device), or zeros like ``like`` when there are none (a process that
    holds no member of the group contributes zeros)."""
    if not parts:
        return torch.zeros_like(like)
    return psum(parts)[0]


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


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a state tree (tensors, None, sequences, dicts)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [leaf for t in tree for leaf in _leaves(t)]


def _tree_add(a, b):
    """``a + b`` over a gradient or a list of pieces."""
    if isinstance(a, torch.Tensor):
        return a + b
    return [x + y for x, y in zip(a, b)]


def _tree_scale(g, mult):
    """``g * mult`` over a gradient or a list of pieces."""
    if isinstance(g, torch.Tensor):
        return g * mult
    return [p * mult.to(p.device) for p in g]


def _clone_tree(t):
    """A tensor tree with every tensor cloned."""
    if isinstance(t, torch.Tensor):
        return t.clone()
    return type(t)(_clone_tree(x) for x in t)


def _copy_tree(dst, src) -> None:
    """Copy a state tree (a tensor, a dict or sequence of them, or None)
    into the storage of ``dst``, leaf by leaf."""
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            if dst[k] is not src[k]:
                dst[k].copy_(src[k])
    else:
        for a, b in zip(dst, src):
            _copy_tree(a, b)


def _gate(ok, new, old):
    """``where(ok, new, old)`` over matching state trees."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    return type(new)(_gate(ok, a, b) for a, b in zip(new, old))


# ---------------------------------------------------------------------------
# Metric accumulation of fit()'s loop
# ---------------------------------------------------------------------------

def _acc_fold(carry: torch.Tensor, preds, labels) -> torch.Tensor:
    """The JAX trainer's ``_fold_acc``: ``Accuracy.update`` for each
    (pred, label) pair folded into the int32 correct-count carry on the
    device (argmax over axis 1 of a pred with more than one dimension,
    int32 casts, the count of matches)."""
    with torch.no_grad():
        for pred, label in zip(preds, labels):
            if pred.ndim > 1:
                pred = torch.argmax(pred, dim=1)
            hit = (pred.to(torch.int32).reshape(-1)
                   == label.to(torch.int32).reshape(-1))
            carry = carry + hit.sum(dtype=torch.int32)
    return carry


class _AsyncMetric:
    """Metric facade of ``fit`` that never syncs a batch.

    ``Accuracy`` folds into a 0-d int32 carry on the device (inside
    :meth:`ShardedTrainer._step_acc`, or through :func:`_acc_fold` over
    the heads when the symbol has no labels); any other metric buffers head references
    and replays them into the wrapped metric every ``period`` batches,
    ``max(1, min(32, 64 MB // head bytes))``.  ``get``,
    ``get_name_value`` and ``get_metric`` drain first, so a callback reads
    exact values and the loop pays the sync only then.
    """

    _MAX_BUFFER_BYTES = 64 << 20

    def __init__(self, inner, device):
        from ..metric import Accuracy
        self.inner = inner
        self.device = device
        self._on_device = type(inner) is Accuracy
        self._dev_sum: Optional[torch.Tensor] = None   # the carry
        self._dev_num = 0                              # instance count
        self._buf: List[Tuple[Any, Any]] = []
        self._period: Optional[int] = None

    # -- fused path (the fold runs inside the train step) --------------

    @property
    def supports_fused(self):
        return self._on_device

    def take_carry(self) -> torch.Tensor:
        c = self._dev_sum
        if c is None:
            c = torch.zeros((), dtype=torch.int32, device=self.device)
        self._dev_sum = None
        return c

    def put_carry(self, carry: torch.Tensor, ninst: int):
        self._dev_sum = carry
        self._dev_num += ninst

    # -- EvalMetric surface ---------------------------------------------

    @property
    def name(self):
        return self.inner.name

    def reset(self):
        self.inner.reset()
        self._dev_sum = None
        self._dev_num = 0
        self._buf.clear()

    def update(self, labels, preds):  # direct use falls through
        self.inner.update(labels, preds)

    def get(self):
        self._drain()
        return self.inner.get()

    def get_name_value(self):
        self._drain()
        return self.inner.get_name_value()

    def get_metric(self, index):
        self._drain()
        return self.inner.get_metric(index)

    # -- deferred accumulation -------------------------------------------

    def update_async(self, labels, outs):
        labels = (list(labels) if isinstance(labels, (list, tuple))
                  else [labels])
        labels = [l.data if isinstance(l, NDArray) else l for l in labels]
        if self._period is None:
            nbytes = sum(o.numel() * o.element_size() for o in outs) or 1
            self._period = max(1, min(32, self._MAX_BUFFER_BYTES // nbytes))
        if self._on_device:
            lvs = [_host_to(torch.as_tensor(label), pred.device)
                   for label, pred in zip(labels, outs)]
            self.put_carry(_acc_fold(self.take_carry(), outs, lvs),
                           sum(lv.numel() for lv in lvs))
            return
        # keep references (a host copy here would sync every batch)
        self._buf.append((labels, list(outs)))
        if len(self._buf) >= self._period:
            self._drain()

    def _drain(self):
        if self._on_device:
            if self._dev_sum is not None:
                with telemetry.span("metric.drain", fused=True):
                    self.inner.sum_metric += int(self._dev_sum)
                self.inner.num_inst += self._dev_num
                self._dev_sum = None
                self._dev_num = 0
            return
        if not self._buf:
            return
        with telemetry.span("metric.drain", batches=len(self._buf)):
            for labels, outs in self._buf:
                self.inner.update(labels, outs)
            self._buf.clear()
