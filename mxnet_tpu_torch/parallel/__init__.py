"""Parallel execution of the port: meshes, collectives and the trainer.

Counterpart of ``mxnet_tpu/parallel/__init__.py``, with the same names:

* :mod:`.mesh` / :mod:`.collectives` -- named meshes of contexts and the
  bucketed, optionally compressed reductions over their members (NCCL
  between distinct cards);
* :mod:`.trainer` -- :class:`ShardedTrainer`: data and tensor
  parallelism over a mesh in one process (implicit and compressed modes,
  error feedback, ZeRO, :class:`ShardingRules` and :func:`megatron_rules`
  over a ``model`` axis, computed by the plans of
  :mod:`.tensor_parallel`), the fused update (K2) and flash attention
  (K3, K4).

The ring functions, MoE, pipelines and the multi-process tier
(``ElasticTrainer`` and its helpers) are not ported yet: those names
raise when called (ROADMAP.md).
"""
from ..base import not_ported
from . import (collectives, flash_attention, mesh, ring_attention,
               tensor_parallel, trainer)
from .collectives import allreduce_mean, allreduce_sum
from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                   Mesh, NamedSharding, PartitionSpec, batch_sharding,
                   current_mesh, data_parallel_mesh, default_mesh,
                   make_mesh, param_sharding, replicated)
# ``parallel.ring_attention`` stays the module (its ring functions raise)
from .ring_attention import (blockwise_attention, local_attention,
                             ring_self_attention)
from .trainer import ShardedTrainer, ShardingRules, megatron_rules


def _unported(name: str, what: str):
    def raiser(*args, **kwargs):
        raise not_ported(f"parallel.{name} ({what})")
    raiser.__name__ = name
    raiser.__qualname__ = name
    return raiser


_MODEL = "model parallelism"
_MULTIPROC = "the multi-process tier"
switch_ffn = _unported("switch_ffn", _MODEL)
moe_ffn = _unported("moe_ffn", _MODEL)
moe_ffn_ep = _unported("moe_ffn_ep", _MODEL)
load_balance_loss = _unported("load_balance_loss", _MODEL)
pipeline_apply = _unported("pipeline_apply", _MODEL)
PipelineTrainer = _unported("PipelineTrainer", _MODEL)
SpmdPipelineTrainer = _unported("SpmdPipelineTrainer", _MODEL)
ElasticTrainer = _unported("ElasticTrainer", _MULTIPROC)
default_mesh_size = _unported("default_mesh_size", _MULTIPROC)
pow2_floor = _unported("pow2_floor", _MULTIPROC)
wire_watchdog = _unported("wire_watchdog", _MULTIPROC)

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
    "collectives", "flash_attention", "mesh", "ring_attention", "trainer",
    "tensor_parallel",
    "blockwise_attention",
]
