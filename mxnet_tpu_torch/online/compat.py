"""Weight-compatibility predicate for a hot swap.

Counterpart of ``mxnet_tpu/online/compat.py``.  One predicate decides
whether new weights can replace the ones a running consumer holds: the
key set, per-array shapes and per-array dtypes must all match.  Values
never matter.

A signature maps each name to ``(shape, dtype name)``.  Dtype names are
numpy's (``"float32"``, ``"int32"``, ``"bfloat16"``, ...) for numpy
arrays, the port's NDArrays and torch tensors alike, so a report on the
same dict reads the same as the JAX package's.  A checkpoint manifest
has a signature too (:func:`signature_of_manifest`, no shard read), and
a publisher stamps the manifest's meta with :func:`compat_stamp`.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["CompatReport", "signature_of_params", "signature_of_manifest",
           "check_compat", "compat_stamp", "STAMP_FORMAT"]

STAMP_FORMAT = 1

# a trainer checkpoint names its weights ``param:``, a model checkpoint
# ``arg:``; aux, optimizer and side state never reach a serving program
_WEIGHT_PREFIXES = ("arg:", "param:")
_EXCLUDED_PREFIXES = ("aux:", "opt:")

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


def signature_of_manifest(manifest: Dict[str, Any]) -> Signature:
    """Weight signature of a checkpoint manifest (no shard reads).
    ``arg:X`` and ``param:X`` both name ``X``, so a trainer checkpoint
    and a ``save_model`` checkpoint of the same weights compare equal;
    ``aux:``/``opt:`` side state is left out.  A manifest with no
    prefixed arrays (a raw ``save``) is taken as it is."""
    arrays = manifest["arrays"]
    prefixed = {k for k in arrays if k.startswith(_WEIGHT_PREFIXES)}
    sig: Signature = {}
    for name, entry in arrays.items():
        if prefixed:
            if name not in prefixed:
                continue
            key = name.split(":", 1)[1]
        else:
            if name.startswith(_EXCLUDED_PREFIXES):
                continue
            key = name
        # manifests store numpy's byte-order string ("<f4")
        sig[key] = (tuple(int(d) for d in entry["shape"]),
                    np.dtype(entry["dtype"]).name)
    return sig


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


def _sig_digest(sig: Signature) -> str:
    h = hashlib.sha1()
    for name in sorted(sig):
        shape, dtype = sig[name]
        h.update(f"{name}:{shape}:{dtype}\n".encode())
    return h.hexdigest()


def compat_stamp(params: Dict[str, Any],
                 heads: Optional[int] = None) -> Dict[str, Any]:
    """The architecture/compat stamp a publisher writes into a
    checkpoint manifest's ``meta["compat"]``: the signature's size and
    digest, and a transformer_lm's shape (``heads`` from the engine
    config: shapes do not tell it); other dicts stamp ``arch: None``."""
    sig = signature_of_params(params)
    stamp = {"format": STAMP_FORMAT, "arrays": len(sig),
             "digest": _sig_digest(sig), "arch": None}
    try:
        from ..models.transformer import lm_config_from_params
        vocab, num_layers, d_model = lm_config_from_params(params)
        stamp["arch"] = {"vocab": vocab, "num_layers": num_layers,
                         "d_model": d_model, "heads": heads}
    except MXNetError:
        pass
    return stamp
