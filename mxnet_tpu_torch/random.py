"""Random sampling API.

Counterpart of ``mxnet_tpu/random.py``.  The reference keeps one seeded
generator per device and ``seed`` reseeds all of them; here each device
has one ``torch.Generator``, made on first use from the last ``seed``
(0 until one is given).  Streams replay within the port; they cannot
equal the JAX package's PRNG bits (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .context import Context, as_context, resolve_device
from .ndarray import NDArray, imperative_invoke

__all__ = ["seed", "uniform", "normal", "randn", "generator"]

_state = {"seed": 0}
_generators: Dict[torch.device, torch.Generator] = {}


def seed(seed_state: int) -> None:
    """Reseed the generator of every device (``MXRandomSeed``)."""
    _state["seed"] = int(seed_state)
    for g in _generators.values():
        g.manual_seed(_state["seed"])


def generator(ctx: Optional[Context] = None) -> torch.Generator:
    """The generator of ``ctx``'s device (default: the current context)."""
    dev = resolve_device(as_context(ctx))
    g = _generators.get(dev)
    if g is None:
        g = _generators[dev] = torch.Generator(device=dev)
        g.manual_seed(_state["seed"])
    return g


def _sample(opname, params, shape, ctx, out):
    if out is not None and shape is None:
        shape = out.shape
    if isinstance(shape, int):
        shape = (shape,)
    if ctx is None and out is not None:
        ctx = out.context
    return imperative_invoke(opname, [], dict(params, shape=shape), out=out,
                             ctx=ctx)


def uniform(low: float = 0.0, high: float = 1.0, shape=None,
            ctx: Optional[Context] = None,
            out: Optional[NDArray] = None) -> NDArray:
    return _sample("_sample_uniform", {"low": low, "high": high}, shape, ctx,
                   out)


def normal(loc: float = 0.0, scale: float = 1.0, shape=None,
           ctx: Optional[Context] = None,
           out: Optional[NDArray] = None) -> NDArray:
    return _sample("_sample_normal", {"loc": loc, "scale": scale}, shape, ctx,
                   out)


def randn(*shape, loc: float = 0.0, scale: float = 1.0, ctx=None) -> NDArray:
    return normal(loc=loc, scale=scale, shape=tuple(shape), ctx=ctx)
