"""Automatic symbol naming.

Counterpart of ``mxnet_tpu/name.py``: ops composed without ``name=`` get
``<op>N`` names from a per-scope counter (``convolution0``,
``batchnorm3``, ...), exactly as in the JAX package, so parameter names
-- and the weights keyed by them -- carry across the two packages.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    """Scope-based auto-namer."""

    _current: "NameManager"

    def __init__(self):
        self._counter: Dict[str, int] = {}
        self._old: Optional[NameManager] = None

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = f"{hint}{self._counter[hint]}"
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old = NameManager._current
        NameManager._current = self
        return self

    def __exit__(self, *exc):
        NameManager._current = self._old


class Prefix(NameManager):
    """Prefix every auto-generated name."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


NameManager._current = NameManager()


def current() -> NameManager:
    return NameManager._current
