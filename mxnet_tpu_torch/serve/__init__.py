"""Serving tier of the PyTorch port: continuous batching over a paged KV
cache, with paged decode attention in a CUDA kernel on the card.

Counterpart of ``mxnet_tpu/serve``.  This slice carries the engine, its
scheduler, the KV cache and the flash-decode kernel; the router,
autoscaler, traffic simulator and speculative decoding come later
(ROADMAP.md).
"""
from . import engine, flash_decode, kvcache, scheduler
from .engine import Engine, EngineConfig
from .kvcache import BlockAllocator
from .scheduler import Request, Scheduler, ServeError

__all__ = ["Engine", "EngineConfig", "BlockAllocator", "Request",
           "Scheduler", "ServeError", "engine", "flash_decode", "kvcache",
           "scheduler"]
