"""On-disk checkpoint layout: directories, shard files, manifest schema.

Counterpart of ``mxnet_tpu/checkpoint/layout.py``, kept the same to the
byte: the directory names, the manifest (``format_version`` 1), the shard
file names and the ``crc32:`` checksums, so a checkpoint either package
writes reads in the other.

A checkpoint root holds one directory per committed step plus (briefly)
staging directories mid-write::

    <root>/
      step-00000120/            # committed checkpoint (atomic rename)
        manifest.json           # written LAST inside staging, so a
                                # manifest's presence == shards complete
        00000.00.bin            # per-array, per-shard raw payloads
        00001.00.bin
        ...
      .tmp-step-00000140-1234/  # in-flight staging dir (never loaded)

The manifest is the single source of truth (schema version
:data:`FORMAT_VERSION`)::

    {
      "format_version": 1,
      "step": 120,
      "process_count": 1,
      "meta": {... JSON-safe trainer metadata: step counter, RNG key,
               optimizer class, metric carry ...},
      "arrays": {
        "<name>": {
          "shape": [512, 128],
          "dtype": "<f4",                  # numpy dtype.str (endianness!)
          "shards": [
            {"file": "00000.00.bin",
             "index": [[0, 256], [0, 128]],  # [start, stop) per dim
             "nbytes": 131072,
             "checksum": "crc32:9a3f0c11"},
            ...
          ]
        }, ...
      }
    }

Shard payloads are the raw C-contiguous bytes of the host shard — no
per-file header; shape/dtype/placement all live in the manifest, and the
crc32 checksum catches truncation and bit corruption at restore time.

Why a manifest + rename instead of a single file: per-array shard files
mean save never host-gathers a sharded array, restore can assemble any
slice without reading the rest, and the atomic ``os.replace`` of the
staging directory makes torn checkpoints structurally impossible — a
crash mid-write leaves a ``.tmp-*`` dir that discovery ignores.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["FORMAT_VERSION", "MANIFEST_NAME", "STEP_PREFIX", "STAGING_PREFIX",
           "step_dir_name", "parse_step", "step_path", "staging_path",
           "committed_steps", "staging_dirs", "checksum_bytes",
           "verify_checksum", "shard_file_name", "make_array_entry",
           "write_manifest", "read_manifest", "normalize_index",
           "entry_nbytes"]

FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"
STEP_PREFIX = "step-"
STAGING_PREFIX = ".tmp-"


def step_dir_name(step: int) -> str:
    return f"{STEP_PREFIX}{int(step):08d}"


def parse_step(name: str) -> Optional[int]:
    """Directory name -> step number, or None for non-checkpoint entries."""
    if not name.startswith(STEP_PREFIX):
        return None
    try:
        return int(name[len(STEP_PREFIX):])
    except ValueError:
        return None


def step_path(root: str, step: int) -> str:
    return os.path.join(root, step_dir_name(step))


def staging_path(root: str, step: int) -> str:
    # pid suffix: two writers racing on one root never share a staging dir
    return os.path.join(root,
                        f"{STAGING_PREFIX}{step_dir_name(step)}-{os.getpid()}")


def committed_steps(root: str) -> List[int]:
    """Steps with a COMMITTED checkpoint (dir renamed into place and a
    manifest inside), sorted ascending.  Staging dirs and torn dirs
    (killed between rename phases — impossible with os.replace, but cheap
    to guard) are excluded."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        step = parse_step(name)
        if step is None:
            continue
        if os.path.isfile(os.path.join(root, name, MANIFEST_NAME)):
            steps.append(step)
    return sorted(steps)


def staging_dirs(root: str) -> List[str]:
    if not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, n) for n in os.listdir(root)
                  if n.startswith(STAGING_PREFIX))


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------


def checksum_bytes(data) -> str:
    """crc32 of a bytes-like payload, in the manifest's ``crc32:%08x``
    form.  crc32 (not sha) because the threat model is torn writes and
    bit rot, not adversaries — and it runs at memory bandwidth."""
    return "crc32:%08x" % (zlib.crc32(data) & 0xFFFFFFFF)


def verify_checksum(data, expected: str, what: str) -> None:
    got = checksum_bytes(data)
    if got != expected:
        raise MXNetError(
            f"checkpoint corruption: {what} checksum mismatch "
            f"(manifest {expected}, file {got})")


# ---------------------------------------------------------------------------
# Manifest construction / IO
# ---------------------------------------------------------------------------


def shard_file_name(array_idx: int, shard_idx: int,
                    process_index: int = 0) -> str:
    base = f"{array_idx:05d}.{shard_idx:02d}"
    if process_index:
        base += f".p{process_index}"
    return base + ".bin"


def normalize_index(index: Sequence, shape: Sequence[int]) -> List[List[int]]:
    """A shard index (tuple of slices) -> [[start, stop), ...] covering
    every dim of ``shape`` (scalars get an empty list)."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = int(dim) if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    # replicated trailing dims (index shorter than rank) span fully
    for dim in shape[len(out):]:
        out.append([0, int(dim)])
    return out


def make_array_entry(shape: Sequence[int], dtype_str: str,
                     shards: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {"shape": [int(s) for s in shape], "dtype": dtype_str,
            "shards": shards}


def entry_nbytes(entry: Dict[str, Any]) -> int:
    return sum(int(s["nbytes"]) for s in entry["shards"])


def write_manifest(dirpath: str, step: int, arrays: Dict[str, Any],
                   meta: Optional[Dict[str, Any]] = None,
                   process_count: int = 1) -> None:
    manifest = {"format_version": FORMAT_VERSION, "step": int(step),
                "process_count": int(process_count),
                "meta": meta or {}, "arrays": arrays}
    path = os.path.join(dirpath, MANIFEST_NAME)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())


def read_manifest(dirpath: str) -> Dict[str, Any]:
    path = os.path.join(dirpath, MANIFEST_NAME)
    if not os.path.isfile(path):
        raise MXNetError(
            f"{dirpath}: no {MANIFEST_NAME} — not a committed checkpoint "
            "(staging dirs and torn writes never contain one)")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except ValueError as e:
        raise MXNetError(f"{path}: manifest is not valid JSON: {e}") from e
    version = manifest.get("format_version")
    if version != FORMAT_VERSION:
        raise MXNetError(
            f"{path}: manifest format_version {version!r} not supported "
            f"(this build reads version {FORMAT_VERSION})")
    return manifest
