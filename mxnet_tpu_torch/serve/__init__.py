"""Serving tier of the PyTorch port: continuous batching over a paged KV
cache, with paged decode attention in a CUDA kernel on the card, and the
control plane over it.

Counterpart of ``mxnet_tpu/serve``, with its exports:

* :mod:`.engine` — the engine (speculative decoding included:
  :mod:`.speculate`'s n-gram and model drafters feed its verify step),
  with :mod:`.scheduler`, :mod:`.kvcache` and the flash-decode kernel
  (:mod:`.flash_decode`);
* :mod:`.router` — N engine replicas behind heartbeat health checks,
  mid-stream failover, deadlines, load shedding, graceful drain and
  rolling weight and draft swaps;
* :mod:`.traffic` — seeded, replay-exact traffic traces replayed in
  virtual time by ``LoadGen``;
* :mod:`.autoscale` — an ``Autoscaler`` that polls the telemetry gauges
  and actuates ``Router.scale_to`` with hysteresis.
"""
from . import (autoscale, engine, flash_decode, kvcache, router, scheduler,
               speculate, traffic)
from .autoscale import AutoscaleConfig, Autoscaler
from .engine import Engine, EngineConfig
from .kvcache import BlockAllocator
from .router import Router, RouterConfig
from .scheduler import Request, Scheduler, ServeError
from .speculate import Drafter, ModelDrafter, NGramDrafter, make_drafter
from .traffic import (LoadGen, Trace, TraceConfig, VirtualClock,
                      generate_trace)

__all__ = ["Engine", "EngineConfig", "BlockAllocator", "Request",
           "Router", "RouterConfig", "Scheduler", "ServeError",
           "Drafter", "ModelDrafter", "NGramDrafter", "make_drafter",
           "AutoscaleConfig", "Autoscaler", "LoadGen", "Trace",
           "TraceConfig", "VirtualClock", "generate_trace",
           "autoscale", "engine", "flash_decode", "kvcache", "router",
           "scheduler", "speculate", "traffic"]
