"""Checkpoint files, the batch-end record and ``FeedForward``.

Counterpart of the checkpoint half of ``mxnet_tpu/model.py``:
:func:`save_checkpoint` writes ``prefix-symbol.json`` and
``prefix-%04d.params`` (the port's ``nd.save``, whose bytes equal the JAX
package's), :func:`load_checkpoint` reads either package's files, and
:data:`BatchEndParam` is the record ``batch_end_callback`` receives.

:class:`FeedForward` is the legacy estimator: its ``fit`` stages each
batch on a prefetch thread (``io.DevicePrefetchIter``), runs the
executors' forward and backward (one a context, the batch split over
them), and updates behind the
:class:`~mxnet_tpu_torch.resilience.LegacyGuard` (when the optimizer asks
for one): on several contexts through a kvstore (:func:`_create_kvstore`
picks it as the JAX package does), either the kvstore's own optimizer
over the reduced gradients (``update_on_kvstore``) or the reduction
pulled into each device's gradients and ``optimizer.get_updater`` on
every copy; then it buffers the train metric (``metric.AsyncMetric``).
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple
from typing import Dict, Optional, Tuple

import numpy as np

from . import io as mx_io
from . import kvstore as kvs_mod
from . import metric as metric_mod
from . import ndarray as nd
from . import optimizer as opt_mod
from . import resilience
from . import symbol as sym_mod
from .base import MXNetError
from .context import Context, current_context
from .executor_manager import DataParallelExecutorManager, _check_arguments
from .initializer import Initializer, Uniform
from .ndarray import NDArray, zeros

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint",
           "split_param_dict", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device: int, arg_params):
    """``(kvstore, update_on_kvstore)`` as the JAX package decides them:
    None, or a name without ``dist`` on one device, is no kvstore (the
    updater runs locally); ``"local"`` picks ``local_update_cpu`` below
    16M elements in the largest parameter, else ``local_allreduce_cpu``;
    the ``local_allreduce`` kinds update locally after the reduction, the
    others on the kvstore."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs_mod.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            if kvstore == "local":
                max_size = max(int(np.prod(p.shape))
                               for p in arg_params.values())
                kvstore = ("local_update_cpu" if max_size < 1024 * 1024 * 16
                           else "local_allreduce_cpu")
                logging.info("Auto-select kvstore type = %s", kvstore)
            kv = kvs_mod.create(kvstore)
    else:
        raise MXNetError("kvstore must be KVStore, str or None")
    if kv is None or "local_allreduce" in kv.type:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Each parameter into the kvstore under its index; with the update
    on the kvstore, every device's copy pulled from it."""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _guarded(live, guard, allow_clip, shared=False):
    """Run ``guard.prepare`` over the live gradient set; returns whether
    the update should proceed (False = skip this step entirely).
    ``shared``: the gradients are the same on every device (after a
    kvstore pull): device 0's statistics stand for all and its clip
    coefficient is shared."""
    if guard is None or not live:
        return True
    num_device = len(live[0][2])
    if shared:
        ok = guard.prepare([[grad_list[0].data for _, _, grad_list in live]],
                           allow_clip=allow_clip)
        if ok:
            guard.share_coef(num_device)
        return ok
    per_device = [[grad_list[k].data for _, _, grad_list in live]
                  for k in range(num_device)]
    return guard.prepare(per_device, allow_clip=allow_clip)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              guard=None):
    """Every gradient pushed (priority ``-index``), then every parameter
    pulled: the kvstore's updater runs on the reduced gradients.  The
    guard may veto the step; it does not clip here (the optimizer lives
    on the kvstore: a clipping caller updates locally instead)."""
    live = [(i, arg, grad) for i, (arg, grad) in
            enumerate(zip(param_arrays, grad_arrays))
            if grad[0] is not None]
    if not _guarded(live, guard, allow_clip=False):
        return
    for index, _, grad_list in live:
        kvstore.push(index, grad_list, priority=-index)
    for index, arg_list, _ in live:
        kvstore.pull(index, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, guard=None):
    """The updater over every parameter with a gradient, each device's
    copy keyed ``index * num_device + k``, behind the guard's veto and
    clip.  With a kvstore the gradients are first reduced through it
    (push, then pull into each device's gradient) and the guard reads
    the reduced gradients, sharing one clip coefficient."""
    live = [(i, arg, grad) for i, (arg, grad) in
            enumerate(zip(param_arrays, grad_arrays))
            if grad[0] is not None]
    if kvstore:
        for index, _, grad_list in live:
            kvstore.push(index, grad_list, priority=-index)
        for index, _, grad_list in live:
            kvstore.pull(index, grad_list, priority=-index)
        if not _guarded(live, guard, allow_clip=True, shared=True):
            return
    elif not _guarded(live, guard, allow_clip=True):
        return
    for index, arg_list, grad_list in live:
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            if guard is not None:
                g = guard.grad_for(g, k)
            updater(index * num_device + k, g, w)


class _TrainLoop:
    """Epoch/batch driver of ``FeedForward.fit``: the executor group, the
    updater, the guard and the callbacks are fixed at construction;
    :meth:`run` plays epochs."""

    def __init__(self, manager, optimizer, kvstore, update_on_kvstore,
                 arg_params, aux_params, logger, monitor=None):
        self.manager = manager
        self.kvstore = kvstore
        self.update_on_kvstore = update_on_kvstore
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.logger = logger or logging
        self.monitor = monitor
        self.updater = None
        # step-level guard (skip non-finite / clip global norm) from the
        # optimizer's clip_global_norm / skip_nonfinite or MXNET_TPU_GUARD
        self.grad_guard = resilience.legacy_guard_for(optimizer,
                                                      logger=self.logger)
        if update_on_kvstore:
            kvstore.set_optimizer(optimizer)
        else:
            self.updater = opt_mod.get_updater(optimizer)
        if kvstore:
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=manager.param_arrays,
                                arg_params=arg_params,
                                param_names=manager.param_names,
                                update_on_kvstore=update_on_kvstore)

    # -- one optimizer step over all devices ----------------------------
    def _step(self, data_batch, metric):
        m = self.manager
        m.load_data_batch(data_batch)
        if self.monitor is not None:
            self.monitor.tic()
        m.forward(is_train=True)
        m.backward()
        if self.update_on_kvstore:
            _update_params_on_kvstore(m.param_arrays, m.grad_arrays,
                                      self.kvstore, guard=self.grad_guard)
        else:
            _update_params(m.param_arrays, m.grad_arrays,
                           updater=self.updater, num_device=len(m.ctx),
                           kvstore=self.kvstore, guard=self.grad_guard)
        if self.monitor is not None:
            self.monitor.toc_print()
        m.update_metric(metric, data_batch.label)

    def _evaluate(self, epoch, eval_data, metric, eval_batch_end_callback):
        m = self.manager
        metric.reset()
        eval_data.reset()
        for i, batch in enumerate(eval_data):
            m.load_data_batch(batch)
            m.forward(is_train=False)
            m.update_metric(metric, batch.label)
            if eval_batch_end_callback is not None:
                _run_callbacks(eval_batch_end_callback,
                               BatchEndParam(epoch=epoch, nbatch=i,
                                             eval_metric=metric,
                                             locals=locals()))
        for name, value in metric.get_name_value():
            self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name,
                             value)
        eval_data.reset()

    def run(self, symbol, train_data, eval_data, eval_metric, begin_epoch,
            end_epoch, epoch_size, batch_end_callback, epoch_end_callback,
            eval_batch_end_callback):
        # a background thread stages batch k+1 on the devices while step
        # k runs, and the train metric reads device values every K batches
        train_data = mx_io.DevicePrefetchIter(
            train_data, place_fn=self.manager.stage_data_batch)
        eval_metric = metric_mod.AsyncMetric(eval_metric)
        train_data.reset()
        for epoch in range(begin_epoch, end_epoch):
            started = time.time()
            eval_metric.reset()
            nbatch = 0
            epoch_done = False
            while not epoch_done:
                hit_limit = False
                for data_batch in train_data:
                    self._step(data_batch, eval_metric)
                    nbatch += 1
                    if batch_end_callback is not None:
                        _run_callbacks(batch_end_callback,
                                       BatchEndParam(epoch=epoch,
                                                     nbatch=nbatch,
                                                     eval_metric=eval_metric,
                                                     locals=locals()))
                    if epoch_size is not None and nbatch >= epoch_size:
                        hit_limit = True
                        break
                if not hit_limit:
                    # iterator exhausted; with a fixed epoch_size keep
                    # streaming into the next pass, else close the epoch
                    self.logger.info("Epoch[%d] Resetting Data Iterator",
                                     epoch)
                    train_data.reset()
                epoch_done = epoch_size is None or nbatch >= epoch_size
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - started)
            if epoch_end_callback or epoch + 1 == end_epoch:
                self.manager.copy_to(self.arg_params, self.aux_params)
            if epoch_end_callback is not None:
                _run_callbacks(epoch_end_callback, epoch, symbol,
                               self.arg_params, self.aux_params)
            if eval_data:
                self._evaluate(epoch, eval_data, eval_metric,
                               eval_batch_end_callback)


def _train_multi_device(symbol, ctx, arg_names, param_names, aux_names,
                        arg_params, aux_params, begin_epoch, end_epoch,
                        epoch_size, optimizer, kvstore, update_on_kvstore,
                        train_data, eval_data=None, eval_metric=None,
                        epoch_end_callback=None, batch_end_callback=None,
                        logger=None, work_load_list=None, monitor=None,
                        eval_batch_end_callback=None, sym_gen=None):
    """Build the device group, then drive :class:`_TrainLoop`."""
    logger = logger or logging
    manager = DataParallelExecutorManager(
        symbol=symbol, sym_gen=sym_gen, ctx=ctx, train_data=train_data,
        param_names=param_names, arg_names=arg_names, aux_names=aux_names,
        work_load_list=work_load_list, logger=logger)
    if monitor:
        manager.install_monitor(monitor)
    manager.set_params(arg_params, aux_params)
    loop = _TrainLoop(manager, optimizer, kvstore, update_on_kvstore,
                      arg_params, aux_params, logger, monitor=monitor)
    loop.run(symbol, train_data, eval_data, eval_metric, begin_epoch,
             end_epoch, epoch_size, batch_end_callback, epoch_end_callback,
             eval_batch_end_callback)


def _run_callbacks(callbacks, *args):
    if isinstance(callbacks, (list, tuple)):
        for cb in callbacks:
            cb(*args)
    else:
        callbacks(*args)


def save_checkpoint(prefix: str, epoch: int, symbol, arg_params,
                    aux_params=None):
    """``prefix-symbol.json`` and ``prefix-%04d.params``; the params file
    holds ``arg:name`` and ``aux:name`` entries (none of the latter when
    ``aux_params`` is None)."""
    symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def split_param_dict(save_dict):
    """Split a checkpoint dict with ``arg:``/``aux:`` key prefixes into
    ``(arg_params, aux_params)``; unprefixed keys count as args."""
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "aux" and name:
            aux_params[name] = v
        elif tp == "arg" and name:
            arg_params[name] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_checkpoint(prefix: str, epoch: int):
    """``(symbol, arg_params, aux_params)`` from the files
    :func:`save_checkpoint` writes (either package's); the arrays are
    NDArrays on the current context (``with mx.cpu():`` for the host)."""
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = split_param_dict(save_dict)
    return symbol, arg_params, aux_params


class FeedForward:
    """The model estimator: ``fit``, ``predict``, ``score``, ``save``,
    ``load`` and ``create`` over one context or several
    (``ctx=[gpu(0), gpu(1)]``); ``kvstore=None`` or ``"local"`` on one
    device uses no kvstore, as in the JAX package."""

    def __init__(self, symbol, ctx=None, num_epoch: Optional[int] = None,
                 epoch_size: Optional[int] = None, optimizer="sgd",
                 initializer: Initializer = Uniform(0.01),
                 numpy_batch_size: int = 128,
                 arg_params=None, aux_params=None,
                 allow_extra_params: bool = False,
                 begin_epoch: int = 0, **kwargs):
        if isinstance(symbol, sym_mod.Symbol):
            self.symbol = symbol
            self.sym_gen = None
        else:
            assert callable(symbol)
            self.symbol = None
            self.sym_gen = symbol
        self.ctx = ctx if ctx is not None else [current_context()]
        if isinstance(self.ctx, Context):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.argument_checked = False
        if self.sym_gen is None:
            self._check_arguments()
        self.begin_epoch = begin_epoch
        self._pred_exec = None

    def _check_arguments(self):
        if self.argument_checked:
            return
        assert self.symbol is not None
        self.argument_checked = True
        _check_arguments(self.symbol)
        if self.allow_extra_params:
            if self.arg_params:
                arg_names = set(self.symbol.list_arguments())
                self.arg_params = {k: v for k, v in self.arg_params.items()
                                   if k in arg_names}
            if self.aux_params:
                aux_names = set(self.symbol.list_auxiliary_states())
                self.aux_params = {k: v for k, v in self.aux_params.items()
                                   if k in aux_names}

    @staticmethod
    def _is_data_arg(name: str) -> bool:
        return name.endswith("data") or name.endswith("label")

    def _init_params(self, input_shapes: Dict[str, Tuple[int, ...]],
                     overwrite: bool = False):
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        arg_names = self.symbol.list_arguments()
        param_names = [x for x in arg_names if not self._is_data_arg(x)
                       and x not in input_shapes]
        aux_names = self.symbol.list_auxiliary_states()
        param_name_shapes = [x for x in zip(arg_names, arg_shapes)
                             if x[0] in param_names]
        # on the first context (the JAX package's default context is the
        # host; the port's parameters stay on the card)
        ctx = self.ctx[0]
        arg_params = {k: zeros(s, ctx=ctx) for k, s in param_name_shapes}
        aux_params = {k: zeros(s, ctx=ctx)
                      for k, s in zip(aux_names, aux_shapes)}
        for k, v in arg_params.items():
            if self.arg_params and k in self.arg_params and not overwrite:
                arg_params[k][:] = self.arg_params[k].asnumpy()
            else:
                self.initializer(k, v)
        for k, v in aux_params.items():
            if self.aux_params and k in self.aux_params and not overwrite:
                aux_params[k][:] = self.aux_params[k].asnumpy()
            else:
                self.initializer(k, v)
        self.arg_params = arg_params
        self.aux_params = aux_params
        return (arg_names, list(param_names), aux_names)

    # --- prediction ----------------------------------------------------

    def _init_predictor(self, input_shapes: Dict[str, Tuple[int, ...]]):
        if self._pred_exec is not None:
            ok = True
            for name, shape in input_shapes.items():
                if tuple(self._pred_exec.arg_dict[name].shape) != tuple(shape):
                    ok = False
            if ok:
                return
        pred_exec = self.symbol.simple_bind(self.ctx[0], grad_req="null",
                                            **input_shapes)
        pred_exec.copy_params_from(self.arg_params, self.aux_params)
        self._pred_exec = pred_exec

    def _init_iter(self, X, y, is_train: bool) -> mx_io.DataIter:
        if isinstance(X, (np.ndarray, NDArray)):
            if y is None:
                if is_train:
                    raise MXNetError("y must be specified when X is numpy.ndarray")
                y = np.zeros(X.shape[0])
            if isinstance(y, (np.ndarray, NDArray)):
                y = y.asnumpy() if isinstance(y, NDArray) else y
                y = np.asarray(y).ravel()
            batch_size = min(self.numpy_batch_size, X.shape[0])
            return mx_io.NDArrayIter(X, y, batch_size=batch_size,
                                     shuffle=is_train,
                                     last_batch_handle="roll_over"
                                     if is_train else "pad")
        if not isinstance(X, mx_io.DataIter):
            raise MXNetError("X must be DataIter, NDArray or numpy.ndarray")
        return X

    def _init_eval_iter(self, eval_data):
        if eval_data is None:
            return eval_data
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            return self._init_iter(eval_data[0], eval_data[1], is_train=True)
        return eval_data

    def compile(self, input_shapes: Dict[str, Tuple[int, ...]]):
        """Warm the prediction path: bind the predictor executor for
        ``input_shapes`` (e.g. ``{"data": (batch, dims...)}``) and resolve
        its forward program through the global program cache now rather
        than at the first :meth:`predict`.  Needs parameters (train first
        or pass ``arg_params``).  Returns the per-program infos
        (``source``, ``seconds``)."""
        if self.arg_params is None:
            raise MXNetError("compile() needs initialized params: fit "
                             "first or pass arg_params to FeedForward")
        self._init_predictor(dict(input_shapes))
        return self._pred_exec.warmup()

    def predict(self, X, num_batch: Optional[int] = None,
                return_data: bool = False, reset: bool = True):
        """The outputs over ``X`` (a DataIter or a numpy array), as numpy
        arrays without the padding of the last batch."""
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        data_shapes = X.provide_data
        data_names = [x[0] for x in data_shapes]
        self._init_predictor(dict(data_shapes))
        batch_size = X.batch_size
        data_arrays = [self._pred_exec.arg_dict[name] for name in data_names]
        output_list = [[] for _ in range(len(self.symbol.list_outputs()))]
        if return_data:
            data_list = [[] for _ in X.provide_data]
            label_list = [[] for _ in X.provide_label]
        i = 0
        for batch in X:
            _load_data(batch, data_arrays)
            self._pred_exec.forward(is_train=False)
            padded = batch.pad
            real_size = batch_size - padded
            for o_list, o_nd in zip(output_list, self._pred_exec.outputs):
                o_list.append(o_nd.asnumpy()[0:real_size])
            if return_data:
                for j, x in enumerate(batch.data):
                    data_list[j].append(x.asnumpy()[0:real_size])
                for j, x in enumerate(batch.label):
                    label_list[j].append(x.asnumpy()[0:real_size])
            i += 1
            if num_batch is not None and i == num_batch:
                break
        outputs = [np.concatenate(x) for x in output_list]
        if len(outputs) == 1:
            outputs = outputs[0]
        if return_data:
            data = [np.concatenate(x) for x in data_list]
            label = [np.concatenate(x) for x in label_list]
            if len(data) == 1:
                data = data[0]
            if len(label) == 1:
                label = label[0]
            return outputs, data, label
        return outputs

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """``eval_metric``'s value over ``X``."""
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        data_shapes = X.provide_data
        data_names = [x[0] for x in data_shapes]
        self._init_predictor(dict(data_shapes))
        data_arrays = [self._pred_exec.arg_dict[name] for name in data_names]
        eval_metric = metric_mod.create(eval_metric)
        for i, batch in enumerate(X):
            if num_batch is not None and i == num_batch:
                break
            _load_data(batch, data_arrays)
            self._pred_exec.forward(is_train=False)
            eval_metric.update(batch.label, self._pred_exec.outputs)
            if batch_end_callback is not None:
                batch_end_params = BatchEndParam(epoch=0, nbatch=i,
                                                 eval_metric=eval_metric,
                                                 locals=locals())
                _run_callbacks(batch_end_callback, batch_end_params)
        return eval_metric.get()[1]

    # --- training ------------------------------------------------------

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_batch_end_callback=None):
        """Train on ``X`` (a DataIter, or numpy arrays with ``y``)."""
        data = self._init_iter(X, y, is_train=True)
        eval_data = self._init_eval_iter(eval_data)
        if self.sym_gen:
            self.symbol = self.sym_gen(data.default_bucket_key)
            self._check_arguments()
        self.kwargs["sym"] = self.symbol
        input_shapes = dict(data.provide_data + data.provide_label)
        arg_names, param_names, aux_names = self._init_params(input_shapes)
        if eval_metric is not None:
            eval_metric = metric_mod.create(eval_metric)
        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self.ctx), self.arg_params)
        clip_gn = (getattr(self.optimizer, "clip_global_norm", None)
                   if isinstance(self.optimizer, opt_mod.Optimizer)
                   else self.kwargs.get("clip_global_norm"))
        if update_on_kvstore and clip_gn is not None:
            # clipping rescales gradients before the update: a kvstore's
            # optimizer would never see them clipped, so update locally
            update_on_kvstore = False
        param_idx2name = {}
        if update_on_kvstore:
            param_idx2name.update(enumerate(param_names))
        else:
            for i, n in enumerate(param_names):
                for k in range(len(self.ctx)):
                    param_idx2name[i * len(self.ctx) + k] = n
        self.kwargs["param_idx2name"] = param_idx2name
        if isinstance(self.optimizer, str):
            batch_size = data.batch_size
            if kvstore and "dist" in kvstore.type:
                batch_size *= kvstore.num_workers
            optimizer = opt_mod.create(self.optimizer,
                                       rescale_grad=(1.0 / batch_size),
                                       **self.kwargs)
        elif isinstance(self.optimizer, opt_mod.Optimizer):
            optimizer = self.optimizer
        else:
            raise MXNetError("optimizer must be a registered name or Optimizer")
        _train_multi_device(self.symbol, self.ctx, arg_names, param_names,
                            aux_names, self.arg_params, self.aux_params,
                            begin_epoch=self.begin_epoch,
                            end_epoch=self.num_epoch,
                            epoch_size=self.epoch_size,
                            optimizer=optimizer, kvstore=kvstore,
                            update_on_kvstore=update_on_kvstore,
                            train_data=data, eval_data=eval_data,
                            eval_metric=eval_metric,
                            epoch_end_callback=epoch_end_callback,
                            batch_end_callback=batch_end_callback,
                            logger=logger, work_load_list=work_load_list,
                            monitor=monitor,
                            eval_batch_end_callback=eval_batch_end_callback,
                            sym_gen=self.sym_gen)
        return self

    def save(self, prefix: str, epoch: Optional[int] = None):
        """``prefix-symbol.json`` and ``prefix-%04d.params``."""
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    @staticmethod
    def load(prefix: str, epoch: int, ctx=None, **kwargs) -> "FeedForward":
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    def save_to_manager(self, manager, epoch: Optional[int] = None,
                        blocking: Optional[bool] = None) -> str:
        """Checkpoint this model through a
        :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager` (atomic
        commit, async write, retention GC) instead of the legacy
        ``prefix-*.params`` file."""
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        return manager.save_model(epoch, self.symbol, self.arg_params,
                                  self.aux_params, blocking=blocking)

    @staticmethod
    def load_from_manager(manager, step: Optional[int] = None, ctx=None,
                          **kwargs) -> "FeedForward":
        """A model from a CheckpointManager checkpoint (default: the
        newest committed step), as :meth:`load` makes one."""
        symbol, arg_params, aux_params, step = manager.load_model(step)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params or None, begin_epoch=step,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_batch_end_callback=None, **kwargs):
        """Construct and fit in one call."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model


def _load_data(batch, data_arrays):
    for src, dst in zip(batch.data, data_arrays):
        src.copyto(dst)
