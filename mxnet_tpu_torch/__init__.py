"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for one NVIDIA H100.

The JAX package ``mxnet_tpu`` stays the reference; this package imports
torch and never jax, nor anything of ``mxnet_tpu``.  Each Pallas kernel of
the JAX package on a ported path becomes a CUDA kernel written by hand for
Hopper (``csrc/``, built with nvcc at first use by :mod:`._build`).

Ported so far: serving ``transformer_lm`` parameter dicts
(:mod:`mxnet_tpu_torch.serve`, with its control plane: router, autoscaler,
traffic simulator, serve chaos and the :mod:`~mxnet_tpu_torch.telemetry`
plane), training symbol graphs such as
ResNet-50 on one device (``symbol``, ``models.get_symbol``,
``parallel.ShardedTrainer`` with its ``fit`` loop over ``io`` iterators,
``metric``, ``lr_scheduler``, ``callback`` and ``model`` checkpoints),
the whole model zoo and the legacy training API (``FeedForward``,
``mod.Module`` and its relatives, ``Monitor``), and the imperative and
executor API
(``nd``, ``random``, ``Symbol.simple_bind``, ``optimizer.get_updater``,
custom ops in ``operator`` and user CUDA kernels in ``rtc``), long
training runs (fp8 linears in ``quant``, recompute scopes, loss scaling,
gradient accumulation) with durable ``checkpoint``s, and serving or
post-training from them (``predictor.load_weights``, ``online``), and
data parallelism in one process (``parallel`` meshes and collectives,
``kvstore``, ``ShardedTrainer`` over a mesh, the legacy API over several
contexts), input records (``recordio``, ``image_io``'s
``ImageRecordIter``) and the deployment predictor (``predictor.create``,
``Predictor``, ``export_model``), and the analysis tooling (``analysis``:
the source linter, the concurrency sanitizer and the schedule fuzzer;
``visualization``, also ``viz``).  Entry
points run on the card unless the caller passes ``device="cpu"`` (or
works under ``with mx.cpu():``).
"""
from . import (analysis, attribute, base, callback, chaos, checkpoint,
               compile_cache, context, executor, executor_manager,
               graph_eval, image_io, initializer, io, kvstore, lr_scheduler,
               metric, model, models, module, monitor, name, ndarray, online,
               operator, ops, optimizer, parallel, predictor, profiler, quant,
               random, recordio, resilience, rtc, serve, stream, symbol,
               telemetry, visualization)
from .attribute import AttrScope
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, resolve_device
from .executor import Executor
from .image_io import ImageRecordIter
from .model import FeedForward, load_checkpoint, save_checkpoint
from .monitor import Monitor
from .parallel import ShardedTrainer
from .serve import Engine, EngineConfig, ServeError, kvcache
from .symbol import Group

sym = symbol
nd = ndarray
mod = module
viz = visualization

__all__ = ["AttrScope", "MXNetError", "Context", "cpu", "gpu", "current_context",
           "resolve_device", "Engine", "EngineConfig", "Executor",
           "FeedForward", "Group", "ImageRecordIter", "Monitor", "ServeError",
           "ShardedTrainer", "kvcache", "analysis", "attribute", "base",
           "callback",
           "chaos", "compile_cache", "context", "executor",
           "executor_manager", "graph_eval", "image_io", "initializer", "io",
           "kvstore", "load_checkpoint", "lr_scheduler", "metric", "mod",
           "model", "models", "module", "monitor", "name", "nd", "ndarray",
           "online", "operator", "ops", "optimizer", "parallel", "predictor",
           "profiler", "quant", "random", "recordio", "resilience", "rtc",
           "save_checkpoint", "serve", "stream", "sym", "symbol",
           "telemetry", "visualization", "viz"]
