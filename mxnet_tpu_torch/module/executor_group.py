"""The executor group of the Module API.

Counterpart of ``mxnet_tpu/module/executor_group.py``: one executor per
context over one symbol, the batch split over the contexts by workload,
outputs merged along the batch, and binding against a
shared group's arrays for bucketing (``simple_bind(shared_exec=...)``:
the buckets' executors hold the same parameter and gradient NDArrays).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from ..context import Context
from ..executor import Executor
from ..ndarray import NDArray, concatenate as nd_concat

__all__ = ["DataParallelExecutorGroup"]


def _merge_multi_context(outputs: List[List[NDArray]]) -> List[NDArray]:
    """Concatenate per-device outputs along the batch."""
    return [out_group[0] if len(out_group) == 1 else nd_concat(out_group, axis=0)
            for out_group in outputs]


class DataParallelExecutorGroup:
    """Per-device executors over one symbol."""

    def __init__(self, symbol, contexts: List[Context],
                 workload: Sequence[float],
                 data_shapes: List[Tuple[str, Tuple[int, ...]]],
                 label_shapes: Optional[List[Tuple[str, Tuple[int, ...]]]],
                 param_names: List[str], for_training: bool,
                 inputs_need_grad: bool,
                 shared_group: Optional["DataParallelExecutorGroup"] = None,
                 logger=logging, fixed_param_names=None,
                 grad_req: str = "write"):
        self.param_names = list(param_names)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.workload = list(workload)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = set(fixed_param_names or [])
        self.shared_group = shared_group

        self.batch_size: Optional[int] = None
        self.slices: Optional[List[slice]] = None
        self.execs: List[Executor] = []
        self.data_shapes = None
        self.label_shapes = None
        self.data_names = None
        self.label_names = None
        self.output_layouts = None

        # grad req per arg
        if not for_training:
            grad_req = "null"
        data_names = [x[0] for x in data_shapes]
        if isinstance(grad_req, str):
            self.grad_req = {}
            for name in self.arg_names:
                if name in self.param_names:
                    self.grad_req[name] = ("null" if name in self.fixed_param_names
                                           else grad_req)
                elif name in data_names:
                    self.grad_req[name] = grad_req if inputs_need_grad else "null"
                else:
                    self.grad_req[name] = "null"
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {name: "null" for name in self.arg_names}
            self.grad_req.update(grad_req)
        else:
            raise MXNetError("grad_req must be str/list/dict")

        self.bind_exec(data_shapes, label_shapes, shared_group)

    def decide_slices(self, data_shapes) -> int:
        """Batch -> per-device slices by workload."""
        from ..executor_manager import _split_input_slice
        batch_size = data_shapes[0][1][0]
        for _, shape in data_shapes:
            if shape[0] != batch_size:
                raise MXNetError("all data must have the same batch size")
        self.batch_size = batch_size
        self.slices = _split_input_slice(batch_size, self.workload)
        return batch_size

    def bind_exec(self, data_shapes, label_shapes, shared_group=None) -> None:
        self.decide_slices(data_shapes)
        self.data_shapes = list(data_shapes)
        self.label_shapes = list(label_shapes) if label_shapes else None
        self.data_names = [x[0] for x in data_shapes]
        self.label_names = ([x[0] for x in label_shapes]
                            if label_shapes else [])
        self.execs = []
        for i in range(len(self.contexts)):
            self.execs.append(self._bind_ith_exec(i, data_shapes, label_shapes,
                                                  shared_group))
        # convenience views
        self.data_arrays = [
            [(self.slices[i], e.arg_dict[name]) for i, e in enumerate(self.execs)]
            for name in self.data_names]
        self.label_arrays = [
            [(self.slices[i], e.arg_dict[name]) for i, e in enumerate(self.execs)]
            for name in self.label_names
            if name in self.arg_names] if label_shapes else []
        self.param_arrays = [
            [e.arg_arrays[i] for e in self.execs]
            for i, name in enumerate(self.arg_names) if name in self.param_names]
        self.grad_arrays = [
            [e.grad_arrays[i] for e in self.execs]
            for i, name in enumerate(self.arg_names)
            if name in self.param_names] if self.for_training else []
        self.aux_arrays = [
            [e.aux_arrays[i] for e in self.execs]
            for i in range(len(self.aux_names))]
        self.input_grad_arrays = [
            [e.grad_dict.get(name) for e in self.execs]
            for name in self.data_names] if self.inputs_need_grad else []

    def _bind_ith_exec(self, i: int, data_shapes, label_shapes,
                       shared_group) -> Executor:
        shared_exec = shared_group.execs[i] if shared_group is not None else None
        context = self.contexts[i]
        batch_slice = self.slices[i]
        n_i = batch_slice.stop - batch_slice.start
        shapes = {}
        for name, shape in data_shapes:
            shapes[name] = (n_i,) + tuple(shape[1:])
        for name, shape in (label_shapes or []):
            if name in self.arg_names:
                shapes[name] = (n_i,) + tuple(shape[1:])
        return self.symbol.simple_bind(context, grad_req=self.grad_req,
                                       shared_exec=shared_exec, **shapes)

    # ------------------------------------------------------------------

    def warmup(self, fb: Optional[bool] = None) -> List[Dict[str, Any]]:
        """Resolve every executor's programs through the global program
        cache (:meth:`mxnet_tpu_torch.executor.Executor.warmup`); returns
        the infos, each with its ``device``."""
        infos: List[Dict[str, Any]] = []
        for i, exec_ in enumerate(self.execs):
            for info in exec_.warmup(fb=fb):
                infos.append(dict(info, device=str(self.contexts[i])))
        return infos

    def program_cache_size(self) -> int:
        """Programs in the (bucketing-shared) table of the first
        executor: the cross-bucket reuse gauge."""
        return self.execs[0].program_cache_size() if self.execs else 0

    def set_params(self, arg_params, aux_params) -> None:
        for exec_ in self.execs:
            exec_.copy_params_from(arg_params, aux_params,
                                   allow_extra_params=True)

    def get_params(self, arg_params, aux_params) -> None:
        """Average over devices into the given dicts."""
        from ..executor_manager import _device_mean
        for name, block in zip(self.param_names, self.param_arrays):
            _device_mean(block, arg_params[name])
        for name, block in zip(self.aux_names, self.aux_arrays):
            _device_mean(block, aux_params[name])

    @property
    def _group_key(self):
        return (tuple((s.start, s.stop) for s in self.slices),
                tuple(str(c) for c in self.contexts))

    def stage_data_batch(self, data_batch):
        """Copy a batch's per-device slices to their devices ahead of its
        step (the prefetch thread's hook; see
        ``DataParallelExecutorGroup.stage_data_batch`` of
        :mod:`~mxnet_tpu_torch.executor_manager`)."""
        from ..executor_manager import StagedBatch
        if getattr(data_batch, "parts_data", None) is not None:
            return data_batch
        def stage(srcs):
            parts = []
            for src in srcs or []:
                parts.append([src.slice(sl.start, sl.stop).copyto(ctxi)
                              for sl, ctxi in zip(self.slices, self.contexts)])
            return parts
        return StagedBatch(data_batch, self._group_key,
                           stage(data_batch.data), stage(data_batch.label))

    def load_data_batch(self, data_batch) -> None:
        from ..executor_manager import _load_general, StagedBatch
        if (isinstance(data_batch, StagedBatch)
                and data_batch.group_key == self._group_key):
            for parts, d_targets in zip(data_batch.parts_data, self.data_arrays):
                for part, (_sl, d_dst) in zip(parts, d_targets):
                    d_dst._write(part.data)
            if self.label_arrays and data_batch.parts_label:
                for parts, d_targets in zip(data_batch.parts_label,
                                            self.label_arrays):
                    for part, (_sl, d_dst) in zip(parts, d_targets):
                        d_dst._write(part.data)
            return
        _load_general(data_batch.data, self.data_arrays)
        if self.label_arrays and data_batch.label:
            _load_general(data_batch.label, self.label_arrays)

    def forward(self, data_batch=None, is_train: Optional[bool] = None) -> None:
        if data_batch is not None:
            self.load_data_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        for exec_ in self.execs:
            exec_.forward(is_train=is_train)

    def backward(self, out_grads=None) -> None:
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run backward")
        for i, exec_ in enumerate(self.execs):
            if out_grads is not None:
                sl = self.slices[i]
                grads_i = [g.slice(sl.start, sl.stop) if g.shape[0] == self.batch_size
                           else g for g in out_grads]
                exec_.backward(grads_i)
            else:
                exec_.backward()

    def get_outputs(self, merge_multi_context: bool = True):
        outputs = [[exec_.outputs[i] for exec_ in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return _merge_multi_context(outputs)
        return outputs

    def get_input_grads(self, merge_multi_context: bool = True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True to get input grads")
        grads = [[exec_.grad_dict[name] for exec_ in self.execs]
                 for name in self.data_names]
        if merge_multi_context:
            return _merge_multi_context(grads)
        return grads

    def update_metric(self, eval_metric, labels) -> None:
        for texec, islice in zip(self.execs, self.slices):
            labels_slice = [label.slice(islice.start, islice.stop)
                            for label in labels]
            eval_metric.update(labels_slice, texec.outputs)

    def install_monitor(self, mon) -> None:
        for exe in self.execs:
            mon.install(exe)
