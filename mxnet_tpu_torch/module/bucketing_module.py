"""BucketingModule: shape-specialized modules sharing one parameter set.

Counterpart of ``mxnet_tpu/module/bucketing_module.py``:
``sym_gen(bucket_key) -> (symbol, data_names, label_names)``;
:meth:`BucketingModule.switch_bucket` binds a module per bucket whose
executors hold the default bucket's parameter and gradient arrays
(``simple_bind(shared_exec=...)``) and borrow its optimizer.  A
``bucket_policy`` (``compile_cache.BucketPolicy``) rounds integer keys up
its ladder and pads the batch into the chosen bucket.  The JAX package
compiles one program per bucket; here each bucket is an eager graph, so
``compile`` (the AOT program cache) raises until ``compile_cache`` is
ported.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """Modules per bucket key over one parameter set.

    * ``bucket_policy`` (a :class:`mxnet_tpu_torch.compile_cache.
      BucketPolicy`): integer bucket keys round up onto the policy's
      ladder and :meth:`forward` pads the batch into the chosen bucket
      (data with ``policy.pad_value``, labels with ``policy.label_pad``,
      the loss's ``ignore_label`` for a masked loss).
    * ``max_buckets`` (default ``MXNET_TPU_MAX_BUCKETS`` or 16): binding
      more distinct buckets than this logs a warning naming the fix (a
      bucket_policy).
    * :meth:`cache_report` counts the bound buckets and the switches.
    """

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, bucket_policy=None,
                 max_buckets: Optional[int] = None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._buckets: Dict[Any, Module] = {}
        self._curr_module: Optional[Module] = None
        self._bucket_policy = bucket_policy
        if max_buckets is None:
            max_buckets = int(os.environ.get("MXNET_TPU_MAX_BUCKETS", "16"))
        self._max_buckets = int(max_buckets)
        self._switch_count = 0
        self._switch_hits = 0
        self._warned_runaway = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._switch_count = 0
        self._switch_hits = 0
        self._warned_runaway = False

    def _canonical_key(self, bucket_key):
        """Round an integer bucket key up onto the policy ladder; other
        key types (tuples, strings) pass through untouched."""
        if self._bucket_policy is not None \
                and isinstance(bucket_key, (int, np.integer)):
            return self._bucket_policy.bucket_of(int(bucket_key))
        return bucket_key

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _call_sym_gen(self, bucket_key):
        ret = self._sym_gen(bucket_key)
        if isinstance(ret, tuple):
            return ret
        return (ret, ("data",), ("softmax_label",))

    def get_params(self):
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        self._params_dirty = False
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's module."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        symbol, data_names, label_names = self._call_sym_gen(
            self._default_bucket_key)
        module = Module(symbol, data_names, label_names, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._curr_module = module
        self._buckets[self._default_bucket_key] = module

    def _bucket_shapes(self, raw_key, bucket_key, shapes):
        """Rewrite shape descs for a canonicalized key: every dim at the
        policy axis that equals the raw key becomes the bucket size."""
        if shapes is None or self._bucket_policy is None \
                or raw_key == bucket_key:
            return shapes
        axis = self._bucket_policy.axis
        out = []
        for desc in shapes:
            name, shape = desc[0], list(desc[1])
            if axis < len(shape) and shape[axis] == int(raw_key):
                shape[axis] = int(bucket_key)
            out.append((name, tuple(shape)) + tuple(desc[2:]))
        return out

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it against the
        default bucket's arrays on first use.  With a ``bucket_policy``,
        integer keys round onto the policy's ladder first (and the shape
        descs' bucketed axis is rewritten to match)."""
        assert self.binded, "call bind before switching bucket"
        raw_key = bucket_key
        bucket_key = self._canonical_key(bucket_key)
        data_shapes = self._bucket_shapes(raw_key, bucket_key, data_shapes)
        label_shapes = self._bucket_shapes(raw_key, bucket_key, label_shapes)
        self._switch_count += 1
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._call_sym_gen(bucket_key)
            module = Module(symbol, data_names, label_names,
                            logger=self.logger, context=self._context,
                            work_load_list=self._work_load_list)
            module.bind(data_shapes, label_shapes, self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key])
            self._buckets[bucket_key] = module
            if (len(self._buckets) > self._max_buckets
                    and not self._warned_runaway):
                self._warned_runaway = True
                self.logger.warning(
                    "BucketingModule bound %d distinct buckets "
                    "(max_buckets=%d); set a bucket_policy to round "
                    "dynamic shapes onto a small padded ladder",
                    len(self._buckets), self._max_buckets)
        else:
            self._switch_hits += 1
        self._curr_module = self._buckets[bucket_key]

    def cache_report(self) -> Dict[str, int]:
        """Program-reuse counters: ``buckets`` (bound modules),
        ``programs`` (entries in the executors' shared program table,
        filled by :meth:`compile`), ``switches`` and ``switch_hits``
        (switch_bucket calls, and those that found a bound bucket)."""
        assert self.binded
        default = self._buckets[self._default_bucket_key]
        return {"buckets": len(self._buckets),
                "programs": default._exec_group.program_cache_size(),
                "switches": self._switch_count,
                "switch_hits": self._switch_hits}

    def _shapes_for_key(self, key, descs):
        """An unbound bucket's shape descs from the default bucket's: the
        bucketed dim (the policy's axis, else any non-batch dim equal to
        the default key) becomes ``key``.  Integer keys only."""
        if descs is None:
            return None
        default = int(self._default_bucket_key)
        axis = (self._bucket_policy.axis if self._bucket_policy is not None
                else None)
        out = []
        for desc in descs:
            name, shape = desc[0], list(desc[1])
            if axis is not None:
                if axis < len(shape) and shape[axis] == default:
                    shape[axis] = int(key)
            else:
                shape = [int(key) if (i > 0 and s == default) else s
                         for i, s in enumerate(shape)]
            out.append((name, tuple(shape)) + tuple(desc[2:]))
        return out

    def compile(self, buckets: Optional[List[Any]] = None, fb=None):
        """Resolve the programs of ``buckets`` (default: every bound
        bucket) through the global program cache: each key is bound (by
        :meth:`switch_bucket`, sharing the default bucket's arrays) and
        its executor programs are captured
        (:meth:`~mxnet_tpu_torch.executor.Executor.warmup`).  Unbound
        integer keys derive their shapes from the default bucket's.  The
        current module is restored afterwards.  Returns the per-program
        infos, each with its ``bucket``."""
        assert self.binded, "call bind before compile"
        prev = self._curr_module
        keys = list(buckets) if buckets is not None \
            else list(self._buckets.keys())
        infos = []
        try:
            for key in keys:
                ckey = self._canonical_key(key)
                if ckey in self._buckets:
                    self._curr_module = self._buckets[ckey]
                elif isinstance(key, (int, np.integer)):
                    default = self._buckets[self._default_bucket_key]
                    self.switch_bucket(
                        key, self._shapes_for_key(ckey, default.data_shapes),
                        self._shapes_for_key(ckey, default.label_shapes))
                else:
                    raise MXNetError(
                        f"compile: bucket {key!r} is not bound and its "
                        "shapes cannot be derived (non-integer key): "
                        "switch_bucket it first")
                for info in self._curr_module.compile(fb=fb):
                    infos.append(dict(info, bucket=ckey))
        finally:
            self._curr_module = prev
        return infos

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        pol = self._bucket_policy
        key = data_batch.bucket_key
        if pol is not None and isinstance(key, (int, np.integer)):
            bucket = pol.bucket_of(int(key))
            if bucket != int(key):
                # pad the batch into the policy bucket (labels with
                # label_pad, the loss head's ignore_label, so padded
                # positions are masked out of the loss and metrics)
                from ..io import pad_batch_to_bucket
                data_batch = pad_batch_to_bucket(
                    data_batch, bucket, axis=pol.axis,
                    pad_value=pol.pad_value, label_pad=pol.label_pad)
        self.switch_bucket(data_batch.bucket_key,
                           data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    # internal state sharing with get_params
    _params_dirty = False
