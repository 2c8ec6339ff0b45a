"""Module: the concrete single-symbol module.

Counterpart of ``mxnet_tpu/module/module.py``: bind, init_params,
init_optimizer, forward, backward and update over a
:class:`DataParallelExecutorGroup` (one executor a context), the update
(a kvstore's optimizer over the reduced gradients, or the reduction
pulled into each device's gradients and ``optimizer.get_updater`` on
every copy, as ``model._create_kvstore`` decides) behind the
:class:`~mxnet_tpu_torch.resilience.LegacyGuard`, and the checkpoint
files, in the legacy layout or through a CheckpointManager
(``save_to_manager``, ``load_from_manager``).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from .. import optimizer as opt_mod
from .. import resilience
from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import Uniform
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore)
from ..ndarray import zeros
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """A module over one symbol: its data and label names split the
    arguments into inputs and parameters."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None,
                 fixed_param_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = [current_context()]
        if isinstance(context, Context):
            context = [context]
        self._context = context
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        if len(work_load_list) != len(self._context):
            raise MXNetError("Invalid settings for work load.")
        self._work_load_list = work_load_list
        self._symbol = symbol
        data_names = list(data_names) if data_names else []
        label_names = list(label_names) if label_names else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._grad_guard = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._exec_group: Optional[DataParallelExecutorGroup] = None
        self._preload_opt_states = None
        self._preload_opt_blob = None

    @staticmethod
    def load(prefix: str, epoch: int, load_optimizer_states: bool = False,
             **kwargs) -> "Module":
        """A module from ``prefix-symbol.json`` and ``prefix-%04d.params``
        (and ``prefix-%04d.states`` with ``load_optimizer_states``)."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix: str, epoch: int,
                        save_optimizer_states: bool = False) -> None:
        """The files :meth:`load` reads."""
        from ..model import save_checkpoint
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    def save_to_manager(self, manager, epoch: int,
                        save_optimizer_states: bool = False,
                        blocking: Optional[bool] = None) -> str:
        """:meth:`save_checkpoint` through a CheckpointManager: the
        symbol, the parameters and, with ``save_optimizer_states``, the
        updater's states (the ``.states`` pickle as a uint8 array named
        ``opt_states``) in one atomic checkpoint directory."""
        arrays = None
        if save_optimizer_states:
            assert self.optimizer_initialized
            import pickle
            from ..optimizer import states_to_host
            blob = pickle.dumps(states_to_host(self._updater.states))
            arrays = {"opt_states": np.frombuffer(blob, np.uint8)}
        arg_params, aux_params = self.get_params()
        return manager.save_model(epoch, self.symbol, arg_params,
                                  aux_params, extra_arrays=arrays,
                                  blocking=blocking)

    @staticmethod
    def load_from_manager(manager, step: Optional[int] = None,
                          load_optimizer_states: bool = False,
                          **kwargs) -> "Module":
        """:meth:`load` from a CheckpointManager checkpoint (default: the
        newest committed step); saved optimizer states apply at
        ``init_optimizer``, as the ``.states`` file does."""
        sym, args, auxs, step = manager.load_model(step)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            from ..checkpoint import load_arrays
            loaded = load_arrays(manager.step_path(step),
                                 names=["opt_states"])
            mod._preload_opt_blob = loaded["opt_states"].tobytes()
        return mod

    # ------------------------------------------------------------------

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        outputs = self._exec_group.get_outputs()
        return list(zip(self._output_names, [o.shape for o in outputs]))

    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Parameters from ``arg_params``/``aux_params`` where given, else
        from ``initializer``, copied into the executors."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"

        # the module's copies live with the first device's arrays
        if self._arg_params is None:
            self._arg_params = {
                name: zeros(arr[0].shape, ctx=arr[0].context,
                            dtype=arr[0].dtype)
                for name, arr in zip(self._param_names,
                                     self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: zeros(arr[0].shape, ctx=arr[0].context,
                            dtype=arr[0].dtype)
                for name, arr in zip(self._aux_names,
                                     self._exec_group.aux_arrays)}

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    cache_arr = cache[name]
                    if cache_arr is not arr:
                        cache_arr.copyto(arr)
                else:
                    if not allow_missing:
                        raise MXNetError(f"{name} is not presented")
                    if initializer is not None:
                        initializer(name, arr)
            else:
                if initializer is not None:
                    initializer(name, arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor group for ``data_shapes`` and
        ``label_shapes``; ``shared_module`` lends its arrays, parameters
        and optimizer (bucketing)."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        if not for_training:
            assert not inputs_need_grad
        self._data_shapes = [x if isinstance(x, tuple) else tuple(x)
                             for x in data_shapes]
        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes) if label_shapes else None
        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and shared_module.binded \
                and shared_module.params_initialized
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        if shared_module is not None and shared_module.optimizer_initialized:
            self.borrow_optimizer(shared_module)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (a name with ``optimizer_params``, or an
        Optimizer), the kvstore and whether it updates, the updater and
        the guard the optimizer asks for."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        clip_gn = (dict(optimizer_params).get("clip_global_norm")
                   if isinstance(optimizer, str)
                   else getattr(optimizer, "clip_global_norm", None))
        if update_on_kvstore and clip_gn is not None:
            # clipping rescales gradients before the update: a kvstore's
            # optimizer would never see them clipped
            update_on_kvstore = False
        if isinstance(optimizer, str):
            batch_size = self._exec_group.batch_size
            if kvstore and "dist" in kvstore.type:
                batch_size *= kvstore.num_workers
            idx2name = {}
            if update_on_kvstore:
                idx2name.update(enumerate(self._exec_group.param_names))
            else:
                for k in range(len(self._context)):
                    idx2name.update({i * len(self._context) + k: n
                                     for i, n in
                                     enumerate(self._exec_group.param_names)})
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = 1.0 / batch_size
            optimizer = opt_mod.create(optimizer, sym=self.symbol,
                                       param_idx2name=idx2name,
                                       **optimizer_params)
        else:
            assert isinstance(optimizer, opt_mod.Optimizer)

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._exec_group.param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt_mod.get_updater(optimizer)
        # step-level guard (skip non-finite / clip global norm) from the
        # optimizer's clip_global_norm / skip_nonfinite or MXNET_TPU_GUARD
        self._grad_guard = resilience.legacy_guard_for(self._optimizer,
                                                       logger=self.logger)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None
        if self._preload_opt_blob is not None:
            import pickle
            self._apply_host_states(pickle.loads(self._preload_opt_blob))
            self._preload_opt_blob = None

    def borrow_optimizer(self, shared_module: "Module") -> None:
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self._grad_guard = getattr(shared_module, "_grad_guard", None)
        self.optimizer_initialized = True

    def stage_batch(self, data_batch):
        """Stage a batch's per-device slices ahead of its step (the
        :class:`~mxnet_tpu_torch.io.DevicePrefetchIter` hook ``fit``
        uses); the batch as it is until bound."""
        if not self.binded:
            return data_batch
        return self._exec_group.stage_data_batch(data_batch)

    def compile(self, fb=None):
        """Resolve this module's executor programs through the global
        program cache now instead of running the first batch eagerly
        (:meth:`mxnet_tpu_torch.executor.Executor.warmup`).  Returns the
        per-program infos (``source``, ``seconds``)."""
        assert self.binded, "call bind() before compile()"
        return self._exec_group.warmup(fb=fb)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step over the gradients of the last backward."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore, guard=self._grad_guard)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore, guard=self._grad_guard)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def save_optimizer_states(self, fname: str) -> None:
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        import pickle
        from ..optimizer import states_to_host
        with open(fname, "wb") as f:
            f.write(pickle.dumps(states_to_host(self._updater.states)))

    def load_optimizer_states(self, fname: str) -> None:
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        import pickle
        with open(fname, "rb") as f:
            self._apply_host_states(pickle.loads(f.read()))

    def _apply_host_states(self, blob) -> None:
        """Install ``states_to_host``-form optimizer states into the local
        updater, placing each state with its weight's context."""
        from ..optimizer import states_from_host
        num_device = len(self._context)
        param_arrays = self._exec_group.param_arrays

        def ctx_for_key(key):
            # updater keys are param_index * num_device + device_k
            # (model._update_params): states live with their weights
            i, k = divmod(key, num_device) if isinstance(key, int) \
                else (None, None)
            if i is not None and i < len(param_arrays):
                return param_arrays[i][k].context
            return None

        self._updater.states.clear()
        self._updater.states.update(states_from_host(blob, ctx_for_key))

    def install_monitor(self, mon):
        assert self.binded
        self._exec_group.install_monitor(mon)
