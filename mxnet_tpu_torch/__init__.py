"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for one NVIDIA H100.

The JAX package ``mxnet_tpu`` stays the reference; this package imports
torch and never jax, nor anything of ``mxnet_tpu``.  Each Pallas kernel of
the JAX package on a ported path becomes a CUDA kernel written by hand for
Hopper (``csrc/``, built with nvcc at first use by :mod:`._build`).

Ported so far: serving ``transformer_lm`` parameter dicts
(:mod:`mxnet_tpu_torch.serve`) and training symbol graphs such as
ResNet-50 on one device (``symbol``, ``models.get_symbol``,
``parallel.ShardedTrainer``).  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
from . import (attribute, base, compile_cache, context, graph_eval,
               initializer, models, name, ndarray, ops, optimizer, parallel,
               resilience, serve, symbol)
from .base import MXNetError
from .context import cpu, gpu, resolve_device
from .parallel import ShardedTrainer
from .serve import Engine, EngineConfig, ServeError, kvcache

sym = symbol
nd = ndarray

__all__ = ["MXNetError", "cpu", "gpu", "resolve_device", "Engine",
           "EngineConfig", "ServeError", "ShardedTrainer", "kvcache",
           "attribute", "base", "compile_cache", "context", "graph_eval",
           "initializer", "models", "name", "nd", "ndarray", "ops",
           "optimizer", "parallel", "resilience", "serve", "sym", "symbol"]
