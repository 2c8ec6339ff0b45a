"""Pipeline parallelism over the ``pipe`` mesh axis (GPipe schedule).

Counterpart of ``mxnet_tpu/parallel/pipeline.py``.  Each member of the
mesh's pipe axis owns one stage's parameters and runs in a thread of its
own (:func:`~.members.run_synced`, on its device); microbatches stream
through the stages one tick at a time, and at the end of every tick each
member hands its activation to the next (``NodeSync.shift``, the
counterpart of ``ppermute``), so stage ``s`` runs microbatch ``t - s`` at
tick ``t``.  The last stage collects the outputs.  The exchanged values
are inputs of the caller's autograd graph, so the result is
differentiable into the stacked parameters and into ``x``, as
:func:`~.ring_attention.ring_attention` is.

Unlike the JAX program (one ``shard_map`` in which every device runs its
stage on every tick and the invalid ticks are masked), a member computes
only the ticks that hold a microbatch; every member still meets the
others once a tick.  The mesh's members are distinct contexts
(:class:`~.mesh.Mesh` refuses repeats): several stages on one device are
:class:`~.pipeline_trainer.PipelineTrainer`'s.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..base import MXNetError
from .members import run_synced
from .mesh import PIPE_AXIS, Mesh, axis_groups

__all__ = ["pipeline_apply"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   mesh: Mesh, *, num_microbatches: int,
                   pipe_axis: str = PIPE_AXIS) -> torch.Tensor:
    """Run ``stage_fn`` S times over pipeline stages.

    Parameters
    ----------
    stage_fn : callable(params_one_stage, x) -> y
        One stage's computation; input and output share shape (GPipe
        layer stacking).
    stage_params : tree (dict, list, tuple) of tensors, each with a
        leading stage dimension S
        Stage ``s`` uses every leaf's ``[s]``.
    x : [batch, ...] global input.
    mesh : a :class:`~.mesh.Mesh` with ``pipe_axis`` of size S; the
        stages run on the members of its first pipe group (the others
        would repeat the same work).
    num_microbatches : int
        The batch splits into this many microbatches (must divide it).

    Returns the ``[batch, ...]`` output of the final stage on ``x``'s
    device.
    """
    if pipe_axis not in mesh.axis_names:
        raise MXNetError(f"mesh has no axis {pipe_axis!r}; axes: "
                         f"{mesh.axis_names}")
    s = mesh.shape[pipe_axis]
    b = x.shape[0]
    m = int(num_microbatches)
    if b % m:
        raise MXNetError(f"batch {b} not divisible by {m} microbatches")
    nstage = _tree_leaves(stage_params)[0].shape[0]
    if nstage != s:
        raise MXNetError(f"stage_params has {nstage} stages, mesh axis "
                         f"{pipe_axis} has {s}")
    group = axis_groups(mesh, pipe_axis)[0]
    members = mesh.members
    devices = [members[i].torch_device for i in group]
    mb = b // m
    ticks = m + s - 1

    def member(idx, handle):
        dev = devices[idx]
        local = _tree_map(lambda p: p[idx].to(dev), stage_params)
        sync = handle.at("pipeline_apply")
        empty = torch.empty(0, dtype=x.dtype, device=dev)
        buf = empty
        outs = []
        for t in range(ticks):
            j = t - idx
            y = empty
            if 0 <= j < m:
                cur = x[j * mb:(j + 1) * mb].to(dev) if idx == 0 else buf
                y = stage_fn(local, cur)
                if idx == s - 1:
                    outs.append(y)
            # the activation ring: stage i -> i + 1, once a tick
            buf, = sync.shift((y,), pipe_axis)
        return outs

    groups = {pipe_axis: [tuple(range(s))]}
    outs = run_synced(member, devices, groups)[s - 1]
    return torch.cat([o.to(x.device) for o in outs], dim=0)
