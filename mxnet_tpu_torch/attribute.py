"""Attribute scoping for symbols.

Counterpart of ``mxnet_tpu/attribute.py``: an :class:`AttrScope` ``with``
block attaches its attributes (``lr_mult``, ``wd_mult``, ``ctx_group``,
...) to every symbol created inside it.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["AttrScope", "current"]


class AttrScope:
    _current: "AttrScope"

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("AttrScope attribute values must be strings")
        self._attr = kwargs
        self._old: Optional[AttrScope] = None

    def get(self, attr: Optional[Dict[str, str]]) -> Dict[str, str]:
        """Merge scope attrs with explicit attrs (explicit wins)."""
        if self._attr:
            ret = dict(self._attr)
            if attr:
                ret.update(attr)
            return ret
        return dict(attr) if attr else {}

    def __enter__(self):
        self._old = AttrScope._current
        merged = dict(self._old._attr)
        merged.update(self._attr)
        self._attr = merged
        AttrScope._current = self
        return self

    def __exit__(self, *exc):
        AttrScope._current = self._old


AttrScope._current = AttrScope()


def current() -> AttrScope:
    return AttrScope._current
