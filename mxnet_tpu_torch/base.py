"""Base utilities of the PyTorch port: the framework's error type.

Counterpart of ``mxnet_tpu/base.py``.  The port keeps its own copy so that
it never imports the JAX package.
"""
from __future__ import annotations

__all__ = ["MXNetError", "not_ported"]


class MXNetError(RuntimeError):
    """Error raised by the framework (same name as the JAX package's)."""


def not_ported(what: str) -> MXNetError:
    """The error for a feature the JAX package has and this port does not
    carry yet (ROADMAP.md lists the order in which they come)."""
    return MXNetError(f"{what} is not ported yet to mxnet_tpu_torch "
                      "(see ROADMAP.md)")
