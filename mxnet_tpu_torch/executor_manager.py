"""Data-parallel executor management for the legacy ``FeedForward`` loop.

Counterpart of ``mxnet_tpu/executor_manager.py``:
:func:`_split_input_slice` (a batch into per-device slices by workload),
:func:`_check_arguments`, :class:`DataParallelExecutorGroup` (the
executors of one symbol, one per context, sharing arrays with another
group's when bucketing) and :class:`DataParallelExecutorManager` (the
bucketing-aware wrapper).  A batch can be staged ahead of its step
(:meth:`DataParallelExecutorManager.stage_data_batch`, the prefetch
thread's hook): its slices are copied to their devices there, and
loading it copies device to device.  Several contexts may name one
device (two executors on ``gpu(0)``), as in the JAX package;
``copy_to`` writes the mean of the devices' copies.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .base import MXNetError
from .context import Context
from .executor import Executor
from .io import DataBatch
from .ndarray import NDArray

__all__ = ["_split_input_slice", "_check_arguments", "StagedBatch",
           "DataParallelExecutorGroup", "DataParallelExecutorManager"]


class StagedBatch(DataBatch):
    """A :class:`DataBatch` whose per-device slices a prefetch thread has
    already copied to their devices.

    ``parts_data``/``parts_label`` hold, for every input, one NDArray per
    device with that device's slice; ``load_data_batch`` then copies them
    into the bound arrays device to device.  The host ``data``/``label``
    lists stay, for the metric and bucketing code that reads
    ``batch.label``/``batch.pad``.
    """

    def __init__(self, batch: DataBatch, group_key, parts_data, parts_label):
        super().__init__(batch.data, batch.label, pad=batch.pad,
                         index=batch.index, bucket_key=batch.bucket_key,
                         provide_data=batch.provide_data,
                         provide_label=batch.provide_label)
        self.group_key = group_key
        self.parts_data = parts_data
        self.parts_label = parts_label


def _split_input_slice(batch_size: int, work_load_list: Sequence[float]) -> List[slice]:
    """Partition a batch into per-device slices proportional to workload:
    every device gets a non-empty contiguous slice and the slices cover
    the batch exactly (from the cumulative workload distribution)."""
    loads = np.asarray(work_load_list, dtype=np.float64)
    if loads.size == 0 or loads.sum() <= 0:
        raise MXNetError("work_load_list must contain positive workloads")
    # cumulative share of the batch after each device, rounded to samples
    bounds = np.rint(np.cumsum(loads) / loads.sum() * batch_size).astype(int)
    bounds[-1] = batch_size
    starts = np.concatenate(([0], bounds[:-1]))
    if np.any(bounds <= starts):
        raise MXNetError(
            f"batch of {batch_size} cannot be split into "
            f"{loads.size} non-empty device slices")
    return [slice(int(b), int(e)) for b, e in zip(starts, bounds)]


def _check_arguments(symbol) -> None:
    """Reject duplicate argument or auxiliary-state names."""
    arg_names = symbol.list_arguments()
    if len(set(arg_names)) != len(arg_names):
        raise MXNetError(f"Find duplicated argument name: {arg_names}")
    aux_names = symbol.list_auxiliary_states()
    if len(set(aux_names)) != len(aux_names):
        raise MXNetError(f"Find duplicated auxiliary param name: {aux_names}")


def _device_mean(block, dst) -> None:
    """The mean of one array's per-device copies, written into ``dst``."""
    dev = dst.data.device
    parts = [w.data.to(dev) for w in block]
    mean = parts[0]
    for p in parts[1:]:
        mean = mean + p.to(mean.dtype)
    dst._write((mean / len(block)).to(dst.data.dtype))


def _load_general(data: List[NDArray], targets, slices=None) -> None:
    """Copy batch data into the per-device bound arrays."""
    for d_src, d_targets in zip(data, targets):
        if isinstance(d_targets, NDArray):
            d_src.copyto(d_targets)
        else:
            for (sl, d_dst) in d_targets:
                d_src.slice(sl.start, sl.stop).copyto(d_dst)


class DataParallelExecutorGroup:
    """A group of per-device executors over one symbol."""

    def __init__(self, sym, arg_names: List[str], param_names: List[str],
                 ctx: List[Context], slices: List[slice], train_data,
                 shared_group: Optional["DataParallelExecutorGroup"] = None):
        _check_arguments(sym)
        self.sym = sym
        self.arg_names = arg_names
        self.param_names = param_names
        self.ctx = ctx
        self.slices = slices
        data_shapes = dict(train_data.provide_data)
        label_shapes = dict(train_data.provide_label)
        self.data_names = list(data_shapes)
        self.label_names = list(label_shapes)
        self.aux_names = sym.list_auxiliary_states()
        self.param_idx = [i for i, name in enumerate(arg_names)
                          if name in param_names]

        self.train_execs: List[Executor] = []
        for i, ctxi in enumerate(ctx):
            batch_slice = slices[i]
            n_i = batch_slice.stop - batch_slice.start
            shapes = {}
            for k, v in list(data_shapes.items()) + list(label_shapes.items()):
                shapes[k] = (n_i,) + tuple(v[1:])
            grad_req = {name: ("write" if name in param_names else "null")
                        for name in arg_names}
            shared_exec = shared_group.train_execs[i] if shared_group else None
            train_exec = sym.simple_bind(ctxi, grad_req=grad_req,
                                         shared_exec=shared_exec, **shapes)
            self.train_execs.append(train_exec)

        # convenience views
        self.data_arrays = [
            [(self.slices[i], e.arg_dict[name])
             for i, e in enumerate(self.train_execs)]
            for name in self.data_names]
        self.label_arrays = [
            [(self.slices[i], e.arg_dict[name])
             for i, e in enumerate(self.train_execs)]
            for name in self.label_names if name in sym.list_arguments()]
        self.param_arrays = [
            [e.arg_arrays[i] for e in self.train_execs]
            for i in self.param_idx]
        self.grad_arrays = [
            [e.grad_arrays[i] for e in self.train_execs]
            for i in self.param_idx]
        self.aux_arrays = [
            [e.aux_arrays[i] for e in self.train_execs]
            for i in range(len(self.aux_names))]

    @property
    def _group_key(self):
        return (tuple((s.start, s.stop) for s in self.slices),
                tuple(str(c) for c in self.ctx))

    def _stage(self, srcs: List[NDArray]) -> List[List[NDArray]]:
        parts = []
        for src in srcs:
            parts.append([src.slice(sl.start, sl.stop).copyto(ctxi)
                          for sl, ctxi in zip(self.slices, self.ctx)])
        return parts

    def stage_data_batch(self, data_batch: DataBatch) -> StagedBatch:
        """Slice a batch and copy the slices to their devices ahead of its
        step (from the prefetch thread; on a CUDA device the copy joins
        the thread's current stream, the default one, so it lands before
        any later work of the loop reads it).  The result feeds
        :meth:`load_data_batch`."""
        if isinstance(data_batch, StagedBatch):
            return data_batch
        return StagedBatch(
            data_batch, self._group_key,
            self._stage(data_batch.data),
            self._stage(data_batch.label or []))

    def load_data_batch(self, data_batch: DataBatch) -> None:
        if (isinstance(data_batch, StagedBatch)
                and data_batch.group_key == self._group_key):
            for parts, d_targets in zip(data_batch.parts_data, self.data_arrays):
                for part, (_sl, d_dst) in zip(parts, d_targets):
                    d_dst._write(part.data)
            for parts, d_targets in zip(data_batch.parts_label, self.label_arrays):
                for part, (_sl, d_dst) in zip(parts, d_targets):
                    d_dst._write(part.data)
            return
        _load_general(data_batch.data, self.data_arrays)
        _load_general(data_batch.label, self.label_arrays)

    def forward(self, is_train: bool = False) -> None:
        for texec in self.train_execs:
            texec.forward(is_train=is_train)

    def backward(self) -> None:
        for texec in self.train_execs:
            texec.backward()

    def update_metric(self, metric, labels) -> None:
        for texec, islice in zip(self.train_execs, self.slices):
            labels_slice = [label.slice(islice.start, islice.stop)
                            for label in labels]
            metric.update(labels_slice, texec.outputs)


class DataParallelExecutorManager:
    """Helper over executor groups with bucketing support."""

    def __init__(self, symbol, ctx: List[Context], train_data,
                 arg_names=None, param_names=None, aux_names=None,
                 work_load_list=None, logger=None, sym_gen=None):
        if logger is None:
            logger = logging
        num_device = len(ctx)
        logger.info("Start training with %s", str(ctx))
        if work_load_list is None:
            work_load_list = [1] * num_device
        if len(work_load_list) != num_device:
            raise MXNetError("Invalid settings for work load.")
        self.slices = _split_input_slice(train_data.batch_size, work_load_list)
        self.arg_names = arg_names if arg_names is not None else symbol.list_arguments()
        self.aux_names = aux_names if aux_names is not None else symbol.list_auxiliary_states()
        if param_names is None:
            data_names = set(k for k, _ in
                             list(train_data.provide_data) + list(train_data.provide_label))
            param_names = [n for n in self.arg_names if n not in data_names]
        self.param_names = list(param_names)
        self.ctx = ctx
        self.sym_gen = sym_gen
        self.symbol = symbol
        self.train_data = train_data
        self.execgrp = DataParallelExecutorGroup(
            symbol, self.arg_names, self.param_names, ctx, self.slices,
            train_data)
        self.execgrp_bucket: Dict[Any, DataParallelExecutorGroup] = {}
        if sym_gen is not None and getattr(train_data, "default_bucket_key", None) is not None:
            self.execgrp_bucket[train_data.default_bucket_key] = self.execgrp
        self.curr_execgrp = self.execgrp

    def install_monitor(self, monitor) -> None:
        if self.sym_gen is not None:
            raise MXNetError("Monitoring is not implemented for bucketing")
        for train_exec in self.execgrp.train_execs:
            monitor.install(train_exec)

    def set_params(self, arg_params, aux_params) -> None:
        for texec in self.execgrp.train_execs:
            texec.copy_params_from(arg_params, aux_params,
                                   allow_extra_params=True)

    def copy_to(self, arg_params, aux_params) -> None:
        """Average params over devices into dicts."""
        for name, block in zip(self.param_names, self.param_arrays):
            _device_mean(block, arg_params[name])
        for name, block in zip(self.aux_names, self.aux_arrays):
            _device_mean(block, aux_params[name])

    @property
    def param_arrays(self):
        return self.execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.execgrp.aux_arrays

    def stage_data_batch(self, data_batch):
        """Prefetch-thread hook: stage the batch for the current group.
        Bucketing models are left unstaged (the target group depends on
        ``bucket_key`` and may not exist yet); ``load_data_batch`` copies
        from the host for them."""
        if self.sym_gen is not None:
            return data_batch
        return self.execgrp.stage_data_batch(data_batch)

    def load_data_batch(self, data_batch) -> None:
        if self.sym_gen is not None and getattr(data_batch, "bucket_key", None) is not None:
            key = data_batch.bucket_key
            if key not in self.execgrp_bucket:
                symbol = self.sym_gen(key)
                self.execgrp_bucket[key] = DataParallelExecutorGroup(
                    symbol, self.arg_names, self.param_names, self.ctx,
                    self.slices, data_batch, shared_group=self.execgrp)
            self.curr_execgrp = self.execgrp_bucket[key]
        else:
            self.curr_execgrp = self.execgrp
        self.curr_execgrp.load_data_batch(data_batch)

    def forward(self, is_train: bool = False) -> None:
        self.curr_execgrp.forward(is_train=is_train)

    def backward(self) -> None:
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels) -> None:
        self.curr_execgrp.update_metric(metric, labels)
