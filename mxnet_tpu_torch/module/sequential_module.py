"""SequentialModule: a chain of modules.

Counterpart of ``mxnet_tpu/module/sequential_module.py``: each module
takes the previous one's outputs as data; backward feeds the input
gradients back through the chain.
"""
from __future__ import annotations

import logging
from typing import List

from ..initializer import Uniform
from ..io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """Modules chained output to data; ``add(module, take_labels=...,
    auto_wiring=...)`` appends one."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules: List[BaseModule] = []
        self._metas: List[dict] = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = set([getattr(SequentialModule, x)
                               for x in dir(SequentialModule)
                               if x.startswith("META_")])

    def add(self, module: BaseModule, **kwargs) -> "SequentialModule":
        self._modules.append(module)
        for key in kwargs:
            assert key in self._meta_keys, f"Unknown meta {key}"
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        if len(self._modules) > 0:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if len(self._modules) > 0:
            return self._modules[-1].output_names
        return []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params = {}
        aux_params = {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return (arg_params, aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init)

        def _check_name(known_names, new_names, modules, i):
            for name in new_names:
                assert not name in known_names, \
                    f"Duplicated parameter names: name {name} in layer {i}"
                known_names[name] = True

        arg_names = {}
        aux_names = {}
        for i_layer, module in enumerate(self._modules):
            arg_params_, aux_params_ = module.get_params()
            _check_name(arg_names, arg_params_.keys(), self._modules, i_layer)
            _check_name(aux_names, aux_params_.keys(), self._modules, i_layer)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, "Shared module is not supported"
        assert len(self._modules) > 0
        self.binded = True
        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes) if label_shapes else None

        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i_layer, module in enumerate(self._modules):
            meta = self._metas[i_layer]
            if SequentialModule.META_TAKE_LABELS in meta and \
                    meta[SequentialModule.META_TAKE_LABELS]:
                my_label_shapes = label_shapes
                anybody_ever_needs_label = True
            else:
                my_label_shapes = None
            my_inputs_need_grad = bool(for_training and
                                       (inputs_need_grad or i_layer > 0))
            if meta.get(SequentialModule.META_AUTO_WIRING, False):
                data_names = module.data_names
                assert len(data_names) == len(my_data_shapes)
                my_data_shapes = [(new_name, shape) for (new_name, (_, shape))
                                  in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, shared_module=None,
                        grad_req=grad_req)
            # the output of the previous module is the data of the next
            if module.symbol is None:  # PythonModule: shapes known post-bind
                my_data_shapes = list(module.output_shapes)
            else:
                shapes = dict(my_data_shapes)
                if my_label_shapes:
                    label_args = set(module.symbol.list_arguments())
                    shapes.update({k: v for k, v in my_label_shapes
                                   if k in label_args})
                _, out_shapes, _ = module.symbol.infer_shape_partial(**shapes)
                my_data_shapes = [(name, tuple(shape)) for name, shape in
                                  zip(module.output_names, out_shapes)]
        if not anybody_ever_needs_label:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = DataBatch(data=data_batch.data, label=data_batch.label,
                          pad=data_batch.pad, index=data_batch.index)
        for i_layer, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i_layer + 1 == len(self._modules):
                break
            batch = DataBatch(data=module.get_outputs(),
                              label=data_batch.label,
                              pad=data_batch.pad, index=data_batch.index)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i_layer, module in reversed(list(zip(range(len(self._modules)),
                                                 self._modules))):
            module.backward(out_grads=out_grads)
            if i_layer == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if SequentialModule.META_TAKE_LABELS in meta and \
                    meta[SequentialModule.META_TAKE_LABELS]:
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
