"""Checkpoint restore: verify and assemble host arrays.

Counterpart of ``mxnet_tpu/checkpoint/reader.py``: every array is
assembled on the host from the saved shards that cover it (a checkpoint
the JAX package wrote on a mesh, with several shards an array, reads
too), each shard file read once and checked against its manifest size
and ``crc32`` checksum; an error names the checkpoint, the array and the
shard file.  The caller copies the arrays onto its device, or a
``NamedSharding`` of its mesh cuts them into the members' pieces, so a
checkpoint of one mesh restores onto another (8 members onto 4).  Only
the JAX package's ZeRO flatten-and-pad case changes a shape
(:func:`_adapt_shape`, 1-D, zero tail), anything else raises.

:func:`load_legacy_params` reads the reference-format
``prefix-%04d.params`` files (``nd.load``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError
from . import layout

__all__ = ["read_array", "restore_array", "load_arrays", "verify_checkpoint",
           "load_legacy_params"]


class _ShardFileCache:
    """Read + verify each shard file at most once per restore call."""

    def __init__(self, dirpath: str, verify: bool = True):
        self.dirpath = dirpath
        self.verify = verify
        self._cache: Dict[str, np.ndarray] = {}

    def shard_data(self, name: str, entry: Dict[str, Any],
                   shard: Dict[str, Any]) -> np.ndarray:
        fname = shard["file"]
        if fname in self._cache:
            return self._cache[fname]
        path = os.path.join(self.dirpath, fname)
        if not os.path.isfile(path):
            raise MXNetError(
                f"checkpoint {self.dirpath}: array {name!r} shard file "
                f"{fname} is missing")
        with open(path, "rb") as f:
            payload = f.read()
        if len(payload) != int(shard["nbytes"]):
            raise MXNetError(
                f"checkpoint {self.dirpath}: array {name!r} shard {fname} "
                f"truncated ({len(payload)} bytes, manifest says "
                f"{shard['nbytes']})")
        if self.verify:
            layout.verify_checksum(payload, shard["checksum"],
                                   f"array {name!r} shard {fname}")
        dtype = np.dtype(entry["dtype"])
        shape = tuple(stop - start for start, stop in shard["index"])
        arr = np.frombuffer(payload, dtype=dtype).reshape(shape)
        self._cache[fname] = arr
        return arr


def _assemble_region(name: str, entry: Dict[str, Any],
                     region: Sequence[Tuple[int, int]],
                     cache: _ShardFileCache) -> np.ndarray:
    """Assemble the half-open ``region`` of an array from the saved
    shards that overlap it."""
    dtype = np.dtype(entry["dtype"])
    out_shape = tuple(stop - start for start, stop in region)
    out = np.empty(out_shape, dtype=dtype)
    filled = 0
    for shard in entry["shards"]:
        index = shard["index"]
        # overlap of this shard with the requested region, in global
        # coordinates
        overlap = [(max(r0, s0), min(r1, s1))
                   for (r0, r1), (s0, s1) in zip(region, index)]
        if any(a >= b for a, b in overlap) and out_shape != ():
            continue
        data = cache.shard_data(name, entry, shard)
        src = tuple(slice(a - s0, b - s0)
                    for (a, b), (s0, _) in zip(overlap, index))
        dst = tuple(slice(a - r0, b - r0)
                    for (a, b), (r0, _) in zip(overlap, region))
        out[dst] = data[src]
        filled += int(np.prod([b - a for a, b in overlap])) if overlap else 1
    size = int(np.prod(out_shape)) if out_shape else 1
    if filled < size:
        raise MXNetError(
            f"checkpoint {cache.dirpath}: array {name!r} region {region} "
            f"not fully covered by saved shards ({filled}/{size} elements) "
            "— incomplete multi-host checkpoint?")
    return out


def read_array(dirpath: str, name: str, entry: Dict[str, Any],
               verify: bool = True) -> np.ndarray:
    """Assemble one array fully on host (tools / tests / host restores)."""
    region = [(0, int(d)) for d in entry["shape"]]
    return _assemble_region(name, entry, region,
                            _ShardFileCache(dirpath, verify))


def _adapt_shape(name: str, full: np.ndarray,
                 target_shape: Sequence[int]) -> np.ndarray:
    """Reconcile a saved shape with the restoring job's shape.  Only the
    ZeRO flatten-and-pad case (1-D, zero tail, length = f(mesh size)) is
    legal; anything else is a real mismatch and raises."""
    target_shape = tuple(int(s) for s in target_shape)
    if full.shape == target_shape:
        return full
    if full.ndim == 1 and len(target_shape) == 1:
        n = target_shape[0]
        if full.shape[0] > n:
            if np.any(full[n:] != 0):
                raise MXNetError(
                    f"restore: 1-D state {name!r} shrinks {full.shape[0]} "
                    f"-> {n} but the tail is non-zero — not a "
                    "flatten-and-pad layout, refusing to truncate")
            return np.ascontiguousarray(full[:n])
        out = np.zeros(target_shape, dtype=full.dtype)
        out[:full.shape[0]] = full
        return out
    raise MXNetError(
        f"restore: array {name!r} has shape {tuple(full.shape)} in the "
        f"checkpoint but {target_shape} in this job — the model changed "
        "(only ZeRO flat-pad 1-D length changes reshard automatically)")


def restore_array(dirpath: str, name: str, entry: Dict[str, Any],
                  sharding=None, target_shape=None, verify: bool = True):
    """Restore one array as a host numpy array, or with ``sharding`` (a
    :class:`~mxnet_tpu_torch.parallel.mesh.NamedSharding` of the current
    mesh) as each member's piece on its device (``sharding.place``): the
    saving run's mesh does not have to match.  ``target_shape`` (default:
    the saved shape) lets a ZeRO flat-pad state change its padded length;
    other shape changes raise."""
    saved_shape = tuple(int(d) for d in entry["shape"])
    full = _assemble_region(name, entry, [(0, d) for d in saved_shape],
                            _ShardFileCache(dirpath, verify))
    if target_shape is not None:
        full = _adapt_shape(name, full, target_shape)
    return full if sharding is None else sharding.place(full)


def load_arrays(dirpath: str, names: Optional[Sequence[str]] = None,
                verify: bool = True) -> Dict[str, np.ndarray]:
    """Host-side bulk load (ckpt_inspect, FeedForward/Module restores)."""
    manifest = layout.read_manifest(dirpath)
    arrays = manifest["arrays"]
    names = list(arrays) if names is None else list(names)
    out = {}
    for name in names:
        if name not in arrays:
            raise MXNetError(f"checkpoint {dirpath} has no array {name!r} "
                             f"(has: {sorted(arrays)[:8]}...)")
        out[name] = read_array(dirpath, name, arrays[name], verify=verify)
    return out


def verify_checkpoint(dirpath: str) -> Dict[str, Any]:
    """Full integrity pass: every shard of every array read + checksummed.
    Returns ``{"arrays": n, "shards": n, "bytes": n}``; raises MXNetError
    naming the first bad shard."""
    manifest = layout.read_manifest(dirpath)
    cache = _ShardFileCache(dirpath, verify=True)
    shards = nbytes = 0
    for name, entry in manifest["arrays"].items():
        for shard in entry["shards"]:
            cache.shard_data(name, entry, shard)
            shards += 1
            nbytes += int(shard["nbytes"])
    return {"arrays": len(manifest["arrays"]), "shards": shards,
            "bytes": nbytes}


def load_legacy_params(path: str) -> Dict[str, np.ndarray]:
    """Read a reference-format ``.params`` file into host arrays keyed by
    the raw ``arg:``/``aux:``-prefixed names (the pre-subsystem layout
    ``model.save_checkpoint`` writes)."""
    from .. import ndarray as nd
    from ..context import cpu
    loaded = nd.load(path, ctx=cpu())
    if not isinstance(loaded, dict):
        raise MXNetError(f"{path}: legacy .params file holds an unnamed "
                         "list, not a param dict")
    return {k: v.asnumpy() for k, v in loaded.items()}
