"""Device meshes and placement records.

Counterpart of ``mxnet_tpu/parallel/mesh.py``.  A port :class:`Mesh` is a
named grid of the port's :class:`~mxnet_tpu_torch.context.Context`\\ s,
as a JAX ``Mesh`` is a grid of devices.  After ``dist.init_distributed``
a mesh may span processes: the other processes' members carry their
process (``Context.process``), and each process runs its own.  Its
members are distinct contexts of one device type: ``gpu(0)`` ...
``gpu(n-1)`` (distinct CUDA devices, reduced through NCCL) or ``cpu(0)``
... ``cpu(n-1)`` (distinct contexts of the one host device: the CPU tests'
counterpart of the JAX package's virtual devices, reduced by copies).

Canonical axis names, as in the JAX package:

* ``data``   -- batch / data parallelism (gradients summed over it)
* ``model``  -- tensor parallelism
* ``seq``    -- sequence parallelism (ring attention)
* ``pipe``   -- pipeline stages
* ``expert`` -- MoE expert parallelism

The trainer splits the batch over the data axis and rule-sharded
parameters over the model (or expert) axis; ring attention splits the
sequence over the seq axis, the expert-parallel MoE program its experts
over the expert axis, and ``pipeline_apply`` and ``SpmdPipelineTrainer``
their stages over the pipe axis.  :func:`axis_groups` lists the members
that share every coordinate but one axis's: the groups a collective
along that axis runs over.  :func:`replicated`, :func:`batch_sharding` and
:func:`param_sharding` return :class:`NamedSharding` placement records
that the trainer and the checkpoint reader read: ``place(value)`` cuts a
host value into each member's piece on the member's device.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, as_context, cpu, gpu, num_devices

__all__ = ["Mesh", "PartitionSpec", "NamedSharding", "make_mesh",
           "data_parallel_mesh", "current_mesh", "default_mesh",
           "local_contexts", "replicated", "batch_sharding",
           "param_sharding", "axis_groups", "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS",
           "PIPE_AXIS", "EXPERT_AXIS"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a placement (``None`` = replicated
    along that dimension), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """A named grid of distinct contexts of one device type.

    ``devices`` is a numpy object array of :class:`Context` whose shape
    is the axis sizes; ``shape`` maps axis name to size, ``size`` is the
    member count and ``members`` the contexts in row-major order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = as_context(src[idx])
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise MXNetError(f"Mesh: {arr.ndim}-d devices for axes {names}")
        members = list(arr.flat)
        if len(set(members)) != len(members):
            raise MXNetError(f"Mesh: devices must be distinct, got {members}")
        if len({m.device_type for m in members}) > 1:
            raise MXNetError(f"Mesh: one device type a mesh, got {members}")
        self.devices = arr
        self.axis_names = names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def members(self) -> List[Context]:
        return list(self.devices.flat)

    @property
    def device_type(self) -> str:
        return self.members[0].device_type

    @property
    def processes(self) -> List[int]:
        """Each member's process in row-major order (this process's index
        for a member that carries no process tag)."""
        from . import dist
        me = dist.process_index()
        return [me if m.process is None else m.process
                for m in self.members]

    @property
    def spans_processes(self) -> bool:
        """Whether another process holds some of the members."""
        return any(m.process is not None for m in self.members)

    def __eq__(self, other):
        return (isinstance(other, Mesh) and other.axis_names == self.axis_names
                and other.devices.shape == self.devices.shape
                and other.members == self.members)

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape,
                     tuple(self.members)))

    def __repr__(self):
        return f"Mesh({self.shape}, {self.members})"


class NamedSharding:
    """A placement of arrays on a mesh: dimension ``d`` of an array is cut
    over the mesh axes ``spec[d]`` (a name, a tuple of names or None)."""

    def __init__(self, mesh: Mesh, spec: Optional[PartitionSpec] = None):
        self.mesh = mesh
        self.spec = spec if spec is not None else PartitionSpec()

    def _dim_axes(self, ndim: int) -> List[Tuple[str, ...]]:
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        if len(spec) > ndim:
            raise MXNetError(f"spec {self.spec} has more entries than the "
                             f"array's {ndim} dimensions")
        out = []
        for ax in spec:
            axes = () if ax is None else ((ax,) if isinstance(ax, str)
                                          else tuple(ax))
            for a in axes:
                if a not in self.mesh.axis_names:
                    raise MXNetError(f"spec {self.spec} names axis {a!r}; "
                                     f"mesh axes: {self.mesh.axis_names}")
            out.append(axes)
        return out

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one member's piece of an array of ``shape``."""
        out = []
        for size, axes in zip(shape, self._dim_axes(len(shape))):
            parts = int(np.prod([self.mesh.shape[a] for a in axes]))
            if size % parts:
                raise MXNetError(f"dimension {size} does not split into "
                                 f"{parts} pieces ({self.spec})")
            out.append(size // parts)
        return tuple(out)

    def index(self, member: int, shape: Sequence[int]) -> Tuple[slice, ...]:
        """The region of an array of ``shape`` that member number
        ``member`` (row-major over the mesh) holds."""
        coord = dict(zip(self.mesh.axis_names,
                         np.unravel_index(member, self.mesh.devices.shape)))
        piece = self.shard_shape(shape)
        out = []
        for size, axes in zip(piece, self._dim_axes(len(shape))):
            k = 0
            for a in axes:
                k = k * self.mesh.shape[a] + int(coord[a])
            out.append(slice(k * size, (k + 1) * size))
        return tuple(out)

    def place(self, value) -> List[torch.Tensor]:
        """Each member's piece of ``value`` (numpy or tensor) on the
        member's device, in row-major member order."""
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        return [t[self.index(i, t.shape)].to(m.torch_device, copy=True)
                for i, m in enumerate(self.mesh.members)]

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh == self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __hash__(self):
        return hash((self.mesh, tuple(self.spec)))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def axis_groups(mesh: Mesh, axis: Optional[str]) -> List[Tuple[int, ...]]:
    """The groups of members (row-major indices) that share every mesh
    coordinate but ``axis``'s, each in order along ``axis``; with
    ``axis`` None every member is a group of its own."""
    if axis is None:
        return [(i,) for i in range(mesh.size)]
    idx = np.arange(mesh.size).reshape(mesh.devices.shape)
    ax = mesh.axis_names.index(axis)
    rows = np.moveaxis(idx, ax, -1).reshape(-1, mesh.devices.shape[ax])
    return [tuple(int(i) for i in row) for row in rows]


_mesh_stack: List[Mesh] = []


def local_contexts(device_type: Optional[str] = None,
                   count: Optional[int] = None) -> List[Context]:
    """The contexts a mesh may use: every CUDA device for ``"gpu"`` (the
    default when CUDA is present); for ``"cpu"``, ``cpu(0)`` ...
    ``cpu(count - 1)`` (the one host device under distinct contexts,
    ``count`` default 1)."""
    if device_type is None:
        device_type = "gpu" if num_devices("gpu") else None
        if device_type is None:
            raise MXNetError("no CUDA device: pass CPU contexts (or "
                             "device_type='cpu') to run on the CPU")
    if device_type == "cpu":
        return [cpu(i) for i in range(1 if count is None else int(count))]
    if device_type != "gpu":
        raise MXNetError(f"unknown device type {device_type!r}")
    n = num_devices("gpu")
    if count is not None and count > n:
        raise MXNetError(f"{count} CUDA devices asked for, {n} present")
    return [gpu(i) for i in range(n if count is None else int(count))]


def make_mesh(axes: Union[Dict[str, int], Sequence[Tuple[str, int]]],
              devices: Optional[Sequence] = None) -> Mesh:
    """A named mesh over ``devices`` (contexts, ``torch.device``\\ s or
    strings; default: every CUDA device).  ``axes`` maps axis name to
    size; one size may be ``-1``, meaning everything left."""
    items = list(axes.items()) if isinstance(axes, dict) else list(axes)
    if devices is None:
        from . import dist
        devices = (dist.global_contexts() if dist.is_initialized()
                   else local_contexts())
    devices = list(devices)
    n = len(devices)
    known = 1
    wild = None
    for i, (name, size) in enumerate(items):
        if size == -1:
            if wild is not None:
                raise MXNetError("make_mesh: only one axis may be -1")
            wild = i
        else:
            known *= size
    if wild is not None:
        if n % known:
            raise MXNetError(f"make_mesh: {n} devices not divisible by {known}")
        items[wild] = (items[wild][0], n // known)
        known = n
    if known != n:
        raise MXNetError(f"make_mesh: axes {items} need {known} devices, "
                         f"have {n}")
    shape = tuple(size for _, size in items)
    names = tuple(name for name, _ in items)
    grid = np.empty(n, dtype=object)
    grid[:] = [as_context(d) for d in devices]
    return Mesh(grid.reshape(shape), names)


def data_parallel_mesh(num_devices: Optional[int] = None,
                       axis: str = DATA_AXIS,
                       device_type: Optional[str] = None) -> Mesh:
    """1-D mesh over the first ``num_devices`` local contexts of
    ``device_type`` (:func:`local_contexts`): the counterpart of the
    reference's ``ctx=[gpu(i) for i in range(N)]``.  After
    ``dist.init_distributed`` (and without a ``device_type`` other than
    the processes'), over every process's contexts."""
    from . import dist
    if dist.is_initialized():
        devices = dist.global_contexts()
        if device_type in (None, devices[0].device_type):
            if num_devices is not None:
                devices = devices[:num_devices]
            return make_mesh({axis: len(devices)}, devices)
    if device_type == "cpu":
        devices = local_contexts("cpu", num_devices)
    else:
        devices = local_contexts(device_type)
        if num_devices is not None:
            devices = devices[:num_devices]
    return make_mesh({axis: len(devices)}, devices)


@contextlib.contextmanager
def default_mesh(mesh: Mesh):
    """Scope a default mesh (``with default_mesh(m): ...``)."""
    _mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _mesh_stack.pop()


def current_mesh() -> Optional[Mesh]:
    return _mesh_stack[-1] if _mesh_stack else None


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Dimension 0 (the batch) cut over ``axis``; the rest replicated."""
    return NamedSharding(mesh, PartitionSpec(axis))


def param_sharding(mesh: Mesh,
                   spec: Optional[PartitionSpec]) -> NamedSharding:
    return NamedSharding(mesh, spec if spec is not None else PartitionSpec())
