"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for one NVIDIA H100.

The JAX package ``mxnet_tpu`` stays the reference; this package imports
torch and never jax, nor anything of ``mxnet_tpu``.  Each Pallas kernel of
the JAX package on a ported path becomes a CUDA kernel written by hand for
Hopper (``csrc/``, built with nvcc at first use by :mod:`._build`).

This slice serves ``transformer_lm`` parameter dicts: see
:mod:`mxnet_tpu_torch.serve`.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
from . import base, compile_cache, context, models, parallel, serve
from .base import MXNetError
from .context import cpu, gpu, resolve_device
from .serve import Engine, EngineConfig, ServeError, kvcache

__all__ = ["MXNetError", "cpu", "gpu", "resolve_device", "Engine",
           "EngineConfig", "ServeError", "kvcache", "base", "compile_cache",
           "context", "models", "parallel", "serve"]
