"""Weight-compatibility predicate for a hot swap.

Counterpart of ``mxnet_tpu/online/compat.py`` (its ``CompatReport``,
``signature_of_params`` and ``check_compat``).  One predicate decides
whether new weights can replace the ones a running consumer holds: the
key set, per-array shapes and per-array dtypes must all match.  Values
never matter.

A signature maps each name to ``(shape, dtype name)``.  Dtype names are
numpy's (``"float32"``, ``"int32"``, ``"bfloat16"``, ...) for numpy
arrays, the port's NDArrays and torch tensors alike, so a report on the
same dict reads the same as the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["CompatReport", "signature_of_params", "check_compat"]

Signature = Dict[str, Tuple[Tuple[int, ...], str]]


@dataclass
class CompatReport:
    """Machine-readable verdict of :func:`check_compat`."""
    compatible: bool
    added: List[str] = field(default_factory=list)      # only in B
    removed: List[str] = field(default_factory=list)    # only in A
    changed: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"compatible": self.compatible, "added": self.added,
                "removed": self.removed, "changed": self.changed}

    def summary(self) -> str:
        if self.compatible:
            return "compatible"
        return ("incompatible: "
                f"+{len(self.added)} arrays, -{len(self.removed)} arrays, "
                f"{len(self.changed)} shape/dtype changes")


def _dtype_name(dtype: Any) -> str:
    """numpy's name of a numpy or torch dtype (``torch.float32`` ->
    ``"float32"``, ``torch.bfloat16`` -> ``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _shape_dtype(v: Any) -> Tuple[Tuple[int, ...], str]:
    return (tuple(int(d) for d in v.shape),
            _dtype_name(getattr(v, "dtype", np.float32)))


def signature_of_params(params: Dict[str, Any]) -> Signature:
    """``{name: (shape, dtype)}`` of an in-memory parameter dict (numpy
    arrays, tensors or NDArrays)."""
    return {str(k): _shape_dtype(v) for k, v in params.items()}


def check_compat(sig_a: Signature, sig_b: Signature) -> CompatReport:
    """Can weights of signature ``sig_b`` hot-swap into a consumer running
    ``sig_a``?  A structural comparison only."""
    added = sorted(set(sig_b) - set(sig_a))
    removed = sorted(set(sig_a) - set(sig_b))
    changed = []
    for name in sorted(set(sig_a) & set(sig_b)):
        (sa, da), (sb, db) = sig_a[name], sig_b[name]
        if sa != sb or da != db:
            changed.append({"name": name,
                            "a": {"shape": list(sa), "dtype": da},
                            "b": {"shape": list(sb), "dtype": db}})
    return CompatReport(
        compatible=not (added or removed or changed),
        added=added, removed=removed, changed=changed)
