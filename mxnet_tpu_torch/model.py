"""Checkpoint files and the batch-end record of the training loops.

Counterpart of the checkpoint half of ``mxnet_tpu/model.py``:
:func:`save_checkpoint` writes ``prefix-symbol.json`` and
``prefix-%04d.params`` (the port's ``nd.save``, whose bytes equal the JAX
package's), :func:`load_checkpoint` reads either package's files, and
:data:`BatchEndParam` is the record ``batch_end_callback`` receives.
``FeedForward`` is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import logging
from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym_mod
from .base import not_ported

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint",
           "split_param_dict", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


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
    """The reference's model estimator; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise not_ported("model.FeedForward")
