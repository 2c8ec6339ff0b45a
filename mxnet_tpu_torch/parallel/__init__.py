"""Parallel execution of the port: meshes, collectives and the trainer.

Counterpart of ``mxnet_tpu/parallel/__init__.py``, with the same names:

* :mod:`.mesh` / :mod:`.collectives` -- named meshes of contexts and the
  bucketed, optionally compressed reductions over their members (NCCL
  between distinct cards);
* :mod:`.members` -- where the members of a mesh meet inside a step
  (one thread a member);
* :mod:`.ring_attention` -- attention on one shard and ring attention
  over a ``seq`` axis (kernels K3/K4 as the ring's per-step body);
* :mod:`.moe` -- the mixture-of-experts programs, dense and expert
  parallel over an ``expert`` axis;
* :mod:`.trainer` -- :class:`ShardedTrainer`: data, tensor, sequence and
  expert parallelism over a mesh of one process or several (implicit
  and compressed modes, error feedback, ZeRO, :class:`ShardingRules` and
  :func:`megatron_rules` over a ``model`` axis, computed by the plans of
  :mod:`.tensor_parallel`; rules over an ``expert`` axis; a ``pipe``
  axis replicates the step), the fused update (K2) and flash attention
  (K3, K4);
* :mod:`.pipeline` -- :func:`pipeline_apply`: the GPipe schedule of a
  stage function over a ``pipe`` axis (one member thread a stage);
* :mod:`.pipeline_trainer` -- :class:`PipelineTrainer`: a Symbol cut
  into stages on their own contexts (repeats allowed), the host-driven
  1F1B step with rematerialized stage backwards, ``data_parallel``
  columns;
* :mod:`.pipeline_spmd` -- :class:`SpmdPipelineTrainer`: the same stages
  over a ``(data, pipe)`` mesh of distinct contexts, the step one run of
  the members over the static timetable :func:`~.pipeline_spmd.
  schedule_1f1b`.

* :mod:`.dist` -- :func:`~.dist.init_distributed`: the process group
  (NCCL or gloo by layout) after which meshes span every process's
  contexts, the trainer running this process's members, and the groups
  of some of the processes (:func:`~.dist.subgroup`);
* :mod:`.process_mesh` -- :class:`~.process_mesh.ProcessLayout`: a mesh
  that spans processes seen from one of them (its box, the lines along
  each axis, who holds a coordinate);
* :mod:`.dist_kvstore` -- the parameter server (``dist_sync``,
  ``dist_async``): scheduler, servers, the worker store and the
  scheduler's membership views (:class:`~.dist_kvstore.
  MembershipClient`);
* :mod:`.launch` -- ``launch_local``, ``launch_ssh`` and ``submit``;
* :mod:`.watchdog` -- :class:`~.watchdog.Watchdog`: the collective
  tier's heartbeat failure detector (``init_distributed(watchdog=True)``
  or ``MXTPU_WATCHDOG``), which aborts every survivor of a lost peer;
* :mod:`.elastic` -- :class:`ElasticTrainer`: a ``ShardedTrainer`` that
  resizes its data mesh when the membership view changes (drain,
  snapshot, reshard restore, warm restart), with
  :func:`default_mesh_size`, :func:`pow2_floor` and
  :func:`wire_watchdog`.

As in the JAX package, ``parallel.ring_attention`` is the function (the
import below shadows the submodule, which
``sys.modules["mxnet_tpu_torch.parallel.ring_attention"]`` still holds).
"""
from . import (collectives, dist, dist_kvstore, elastic, flash_attention,
               launch, members, mesh, moe, pipeline, pipeline_spmd,
               pipeline_trainer, process_mesh, ring_attention,
               tensor_parallel, trainer, watchdog)
from .collectives import allreduce_mean, allreduce_sum
from .elastic import (ElasticTrainer, default_mesh_size, pow2_floor,
                      wire_watchdog)
from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                   Mesh, NamedSharding, PartitionSpec, batch_sharding,
                   current_mesh, data_parallel_mesh, default_mesh,
                   make_mesh, param_sharding, replicated)
from .moe import load_balance_loss, moe_ffn, moe_ffn_ep, switch_ffn
from .pipeline import pipeline_apply
from .pipeline_spmd import SpmdPipelineTrainer
from .pipeline_trainer import PipelineTrainer
from .ring_attention import (blockwise_attention, local_attention,
                             ring_attention, ring_self_attention)
from .trainer import ShardedTrainer, ShardingRules, megatron_rules


__all__ = [
    "Mesh", "NamedSharding", "PartitionSpec",
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "EXPERT_AXIS",
    "make_mesh", "data_parallel_mesh", "default_mesh", "current_mesh",
    "batch_sharding", "param_sharding", "replicated",
    "allreduce_sum", "allreduce_mean",
    "ShardedTrainer", "ShardingRules", "megatron_rules",
    "ElasticTrainer", "default_mesh_size", "pow2_floor", "wire_watchdog",
    "ring_attention", "ring_self_attention", "local_attention",
    "switch_ffn", "moe_ffn", "moe_ffn_ep", "load_balance_loss",
    "pipeline_apply", "PipelineTrainer", "SpmdPipelineTrainer",
    "collectives", "flash_attention", "mesh", "trainer",
    "tensor_parallel", "members", "moe", "pipeline", "pipeline_trainer",
    "pipeline_spmd", "dist", "dist_kvstore", "launch", "elastic",
    "watchdog", "blockwise_attention",
]
