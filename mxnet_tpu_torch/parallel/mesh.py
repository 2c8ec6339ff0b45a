"""Device meshes: not ported yet (multi-GPU slice).

Counterpart of ``mxnet_tpu/parallel/mesh.py``.  The port runs on one
device: no mesh can be made or activated, so the attention paths always
take their single-device form (no ring attention, no per-shard kernel
wrapping).
"""
from __future__ import annotations

from ..base import not_ported

__all__ = ["make_mesh", "default_mesh"]


def make_mesh(*args, **kwargs):
    raise not_ported("parallel.make_mesh (multi-GPU)")


def default_mesh(*args, **kwargs):
    raise not_ported("parallel.default_mesh (multi-GPU)")
