"""Weight loading for inference.

Counterpart of the first part of ``mxnet_tpu/predictor.py``:
:func:`load_weights`, the one weight-loading story of the serving entry
points (``serve.Engine.from_checkpoint``, ``Engine.swap_weights``,
``Engine.swap_draft_weights`` and ``Router.rolling_swap`` from a path).
The deployment predictor itself (``Predictor``, ``create``,
``export_model``) is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

from .base import MXNetError

__all__ = ["load_weights"]


def _is_manifest_dir(path: str) -> bool:
    """A CheckpointManager root: a directory holding committed
    ``step-NNNNNNNN/manifest.json`` checkpoints."""
    if not os.path.isdir(path):
        return False
    from .checkpoint.layout import committed_steps
    return bool(committed_steps(path))


def load_weights(source: str, epoch: Optional[int] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Any],
                            Dict[str, Any]]:
    """Load inference weights from ``source``:

    * a **CheckpointManager directory** (``step-*/manifest.json``) -- the
      latest committed step, or ``epoch`` if given (a ``save_model``
      checkpoint: its ``arg:``/``aux:`` arrays);
    * a **legacy prefix** -- ``prefix-symbol.json`` +
      ``prefix-%04d.params`` (``epoch``, default 0);
    * a **``.params`` file path** -- the epoch parsed from the name, the
      sibling ``-symbol.json`` picked up when present.

    Returns ``(symbol_or_None, arg_params, aux_params, meta)`` with host
    NDArray params and ``meta`` carrying ``source_kind`` and
    ``step``/``epoch``.
    """
    if _is_manifest_dir(source):
        from .checkpoint import CheckpointManager
        mgr = CheckpointManager(source)
        try:
            symbol, arg_params, aux_params, step = mgr.load_model(epoch)
        finally:
            mgr.close()
        return symbol, arg_params, aux_params, {
            "source_kind": "manifest", "step": step}
    prefix, ep = source, epoch
    m = re.match(r"^(.*)-(\d{4,})\.params$", source)
    if m:
        prefix = m.group(1)
        ep = int(m.group(2)) if epoch is None else epoch
    if ep is None:
        ep = 0
    params_path = "%s-%04d.params" % (prefix, ep)
    if not os.path.exists(params_path):
        raise MXNetError(
            f"{source!r}: neither a checkpoint-manifest directory nor a "
            f"legacy checkpoint ({params_path} missing)")
    from . import ndarray as nd
    from .context import cpu
    from .model import split_param_dict
    arg_params, aux_params = split_param_dict(nd.load(params_path,
                                                      ctx=cpu()))
    symbol = None
    sym_path = f"{prefix}-symbol.json"
    if os.path.exists(sym_path):
        from . import symbol as sym_mod
        symbol = sym_mod.load(sym_path)
    return symbol, arg_params, aux_params, {
        "source_kind": "legacy", "epoch": ep}
