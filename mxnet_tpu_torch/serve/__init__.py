"""Serving tier of the PyTorch port: continuous batching over a paged KV
cache, with paged decode attention in a CUDA kernel on the card.

Counterpart of ``mxnet_tpu/serve``.  It carries the engine (speculative
decoding included: :mod:`.speculate`'s n-gram and model drafters feed the
engine's verify step), its scheduler, the KV cache and the flash-decode
kernel; the router, autoscaler and traffic simulator come later
(ROADMAP.md).
"""
from . import engine, flash_decode, kvcache, scheduler, speculate
from .engine import Engine, EngineConfig
from .kvcache import BlockAllocator
from .scheduler import Request, Scheduler, ServeError
from .speculate import Drafter, ModelDrafter, NGramDrafter, make_drafter

__all__ = ["Engine", "EngineConfig", "BlockAllocator", "Request",
           "Scheduler", "ServeError", "Drafter", "ModelDrafter",
           "NGramDrafter", "make_drafter", "engine", "flash_decode",
           "kvcache", "scheduler", "speculate"]
