"""A mesh that spans processes, as one of its processes sees it.

The JAX trainer runs one program over a multi-host mesh: XLA moves each
value between the hosts' devices (``mxnet_tpu/parallel/trainer.py``
``_multiproc``/``_global_put``, ``jax.make_array_from_process_local_data``
in ``place_batch``).  Here each process runs the members of its *box* of
the global mesh, a range of coordinates along every axis, and the
processes meet where a value crosses between boxes.

The boxes must tile the mesh as a grid: along each axis the processes'
ranges are equal or disjoint.  Then the *line* of a process along an axis
-- the processes whose boxes differ from its own only along that axis --
holds every member of every group along that axis that one of its
members belongs to, and each of those processes holds the same groups
(the same coordinates on every other axis).  A meeting along an axis is
one exchange over the line; a value held by several processes (a
replicated parameter, a piece of a rule-sharded one, a data
coordinate's optimizer slice) is written where every holder computes it
alike.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..base import MXNetError
from .mesh import Mesh

__all__ = ["ProcessLayout"]


class ProcessLayout:
    """The boxes of a mesh that spans processes (``mesh.processes``),
    seen from process ``me``: ``boxes[p]`` is process ``p``'s ``(lo,
    hi)`` range along each axis, ``gproc[g]`` the process of global
    member ``g`` (row-major), ``gidx[i]`` the global index of this
    process's member ``i`` (row-major within its box).  A layout whose
    processes do not form boxes, or whose boxes do not tile the mesh as
    a grid, is refused with its reason."""

    def __init__(self, mesh: Mesh, me: int):
        self.axes = tuple(mesh.axis_names)
        self.shape = tuple(mesh.devices.shape)
        grid = np.array(mesh.processes, dtype=np.int64).reshape(self.shape)
        self.gproc = [int(p) for p in grid.flat]
        self.boxes: Dict[int, Tuple[Tuple[int, int], ...]] = {}
        for p in sorted(set(self.gproc)):
            where = np.argwhere(grid == p)
            lo, hi = where.min(axis=0), where.max(axis=0) + 1
            if len(where) != int(np.prod(hi - lo)):
                raise MXNetError(
                    f"mesh {mesh}: process {p}'s {len(where)} members do not "
                    f"form a box of the mesh (they span "
                    f"{tuple((int(a), int(b)) for a, b in zip(lo, hi))}); "
                    "each process's members must hold a range of "
                    "coordinates along every axis")
            self.boxes[p] = tuple((int(a), int(b)) for a, b in zip(lo, hi))
        for k, ax in enumerate(self.axes):
            ranges = sorted({b[k] for b in self.boxes.values()})
            for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
                if b0 < a1:
                    raise MXNetError(
                        f"mesh {mesh}: the processes' ranges along {ax!r} "
                        f"overlap ({a0}-{a1} and {b0}-{b1}); the boxes must "
                        "tile the mesh as a grid")
        cells = int(np.prod([len({b[k] for b in self.boxes.values()})
                             for k in range(len(self.axes))]))
        if cells != len(self.boxes):
            raise MXNetError(f"mesh {mesh}: the processes' boxes do not tile "
                             "the mesh as a grid")
        if me not in self.boxes:
            raise MXNetError(f"mesh {mesh} holds no member of process {me}")
        self.me = me
        self.box = self.boxes[me]
        sl = tuple(slice(a, b) for a, b in self.box)
        self.gidx = [int(g) for g in
                     np.arange(grid.size).reshape(self.shape)[sl].flat]
        self.local_shape = tuple(b - a for a, b in self.box)

    def local_mesh(self, mesh: Mesh) -> Mesh:
        """This process's members as a mesh of the same axes."""
        sl = tuple(slice(a, b) for a, b in self.box)
        return Mesh(mesh.devices[sl], self.axes)

    def spans(self, axis: str) -> bool:
        """Whether this process's box is narrower than the mesh along
        ``axis`` (its meetings along it cross processes)."""
        k = self.axes.index(axis)
        return self.local_shape[k] < self.shape[k]

    def offset(self, axis: str) -> int:
        return self.box[self.axes.index(axis)][0]

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def lines(self, axis: str) -> List[List[int]]:
        """Every line along ``axis``: the processes whose boxes agree on
        every other axis, each line in the order of the boxes' offsets
        along ``axis``; the lines in the order of their first process."""
        k = self.axes.index(axis)
        by: Dict[tuple, List[int]] = {}
        for p, b in self.boxes.items():
            by.setdefault(b[:k] + b[k + 1:], []).append(p)
        lines = [sorted(ps, key=lambda p: self.boxes[p][k][0])
                 for ps in by.values()]
        return sorted(lines, key=min)

    def line(self, axis: str) -> List[int]:
        """This process's line along ``axis``."""
        return next(ln for ln in self.lines(axis) if self.me in ln)

    def holders(self, axis: str, coord: int) -> Tuple[int, ...]:
        """The processes whose boxes hold coordinate ``coord`` of
        ``axis``, in rank order."""
        k = self.axes.index(axis)
        return tuple(p for p, b in self.boxes.items()
                     if b[k][0] <= coord < b[k][1])
