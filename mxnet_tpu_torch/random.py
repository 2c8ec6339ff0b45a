"""Random sampling API.

Counterpart of ``mxnet_tpu/random.py``.  The reference keeps one seeded
generator per device and ``seed`` reseeds all of them; here each device
has one ``torch.Generator``, made on first use from the last ``seed``
(0 until one is given).  Streams replay within the port; they cannot
equal the JAX package's PRNG bits (ROADMAP.md, Queue 3).

A graph's sampling ops (``_sample_*``, ``Dropout``, ``LeakyReLU(rrelu)``)
draw from a :class:`GraphKey` instead: one 64-bit key per evaluation
(the trainer's ``(seed, step)``, the executor's :func:`next_key`), and
for each node its own generator seeded with ``mix(key, node index)``, as
the JAX package folds the node's index into the step's key.  A node's
draws then depend on the key and its own index only: a replay with the
same key draws the same masks, and adding a node moves no other node's
draws.  Seeding a generator sets its state on the host, so keying a
step costs the card no synchronisation.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .context import Context, as_context, resolve_device
from .ndarray import NDArray, imperative_invoke

__all__ = ["seed", "uniform", "normal", "randn", "generator", "mix",
           "GraphKey", "next_key"]

_state = {"seed": 0, "keys": 0}
_generators: Dict[torch.device, torch.Generator] = {}
_node_generators: Dict[torch.device, Dict[int, torch.Generator]] = {}
_MASK64 = (1 << 64) - 1


def seed(seed_state: int) -> None:
    """Reseed the generator of every device (``MXRandomSeed``) and restart
    the executors' key sequence (:func:`next_key`)."""
    _state["seed"] = int(seed_state)
    _state["keys"] = 0
    for g in _generators.values():
        g.manual_seed(_state["seed"])


def mix(*vals: int) -> int:
    """splitmix64 chained over integers: a 64-bit seed for a tuple of keys
    (a seed, a step, a node index, a position, a salt)."""
    h = 0
    for v in vals:
        z = ((h ^ (int(v) & _MASK64)) + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        h = z ^ (z >> 31)
    return h


class GraphKey:
    """The key of one evaluation of a symbol graph on ``device``.

    :meth:`generator` gives node ``index`` (its position in the graph's
    topological order) a generator seeded with ``mix(value, index)``.
    ``cache`` (a dict the key's owner keeps) reuses the generator objects
    from one evaluation to the next: reseeding one sets its seed and
    offset on the host, and a kernel launched before takes its state by
    value."""

    __slots__ = ("value", "device", "_cache")

    def __init__(self, value: int, device, cache=None):
        self.value = int(value) & _MASK64
        self.device = torch.device(device)
        self._cache = {} if cache is None else cache

    def generator(self, index: int) -> torch.Generator:
        g = self._cache.get(index)
        if g is None:
            g = self._cache[index] = torch.Generator(device=self.device)
        g.manual_seed(mix(self.value, index))
        return g


def next_key(ctx: Optional[Context] = None) -> GraphKey:
    """The next key of the executors' sequence on ``ctx``'s device:
    ``mix(seed, n)`` for the n-th key since the last :func:`seed` (the
    JAX package's ``_next_key``, which splits its global key)."""
    dev = resolve_device(as_context(ctx))
    _state["keys"] += 1
    return GraphKey(mix(_state["seed"], _state["keys"]), dev,
                    _node_generators.setdefault(dev, {}))


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
