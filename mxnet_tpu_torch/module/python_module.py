"""PythonModule / PythonLossModule: modules written in Python.

Counterpart of ``mxnet_tpu/module/python_module.py``: a module with no
parameters whose forward and backward run any Python code (numpy or
torch), to splice such computation (a loss, a metric bridge) into a
``SequentialModule`` chain.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional

from ..initializer import Uniform
from ..ndarray import NDArray, array as nd_array
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A parameterless module; subclasses compute the outputs."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        if isinstance(data_names, tuple):
            data_names = list(data_names)
        if isinstance(label_names, tuple):
            label_names = list(label_names)
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        assert grad_req == "write", "Python module only supports write gradient"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        assert len(data_shapes) == len(self._data_names)
        assert [x[0] for x in data_shapes] == self._data_names
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        if label_shapes is not None:
            assert self._label_names is not None
            assert len(self._label_names) == len(label_shapes)
            assert [x[0] for x in label_shapes] == self._label_names
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self) -> List:
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        pass

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss module: its output is its input scores, and ``grad_func(
    scores, labels)`` gives the scores' gradient."""

    def __init__(self, name: str = "pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func: Optional[Callable] = None):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger=logger)
        self._name = name
        assert len(data_names) == 1
        assert len(label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None:
            assert callable(grad_func)
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "For a loss module, out_grads should be None"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, NDArray):
                grad = nd_array(grad)
            self._scores_grad = grad
        else:
            raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores_grad]
