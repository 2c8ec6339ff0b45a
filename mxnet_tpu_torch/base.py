"""Base utilities of the PyTorch port: the error type and the registry.

Counterpart of ``mxnet_tpu/base.py``.  The port keeps its own copy so that
it never imports the JAX package.
"""
from __future__ import annotations

from typing import Dict, Generic, List, Optional, TypeVar

__all__ = ["MXNetError", "not_ported", "Registry"]


class MXNetError(RuntimeError):
    """Error raised by the framework (same name as the JAX package's)."""


def not_ported(what: str) -> MXNetError:
    """The error for a feature the JAX package has and this port does not
    carry yet (ROADMAP.md lists the order in which they come)."""
    return MXNetError(f"{what} is not ported yet to mxnet_tpu_torch "
                      "(see ROADMAP.md)")


T = TypeVar("T")


class Registry(Generic[T]):
    """A named registry (``dmlc::Registry``).  Lookup is case-sensitive
    first, then case-insensitive, as in the JAX package."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, T] = {}

    def register(self, entry: T, name: Optional[str] = None,
                 aliases: Optional[List[str]] = None) -> T:
        key = name if name is not None else getattr(entry, "__name__", None)
        if key is None:
            raise ValueError("registry entry needs a name")
        if key in self._entries:
            raise ValueError(f"{self.name} registry already has an entry "
                             f"'{key}'")
        self._entries[key] = entry
        for a in aliases or []:
            self._entries[a] = entry
        return entry

    def get(self, name: str) -> T:
        if name in self._entries:
            return self._entries[name]
        lowered = {k.lower(): v for k, v in self._entries.items()}
        if name.lower() in lowered:
            return lowered[name.lower()]
        raise KeyError(f"{self.name} registry has no entry '{name}'. "
                       f"Known: {sorted(self._entries)}")

    def __contains__(self, name: str) -> bool:
        try:
            self.get(name)
            return True
        except KeyError:
            return False

    def list(self) -> List[str]:
        return sorted(self._entries)

    def items(self):
        return self._entries.items()
