"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Every ``csrc/*.cu`` compiles on its own into a shared library with a plain
C interface for ``sm_90a`` (Hopper).  The library's name carries a hash
of its source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header never loads a stale build.
Outputs go to ``_kernels/`` inside the package, which ``.gitignore``
lists.  :func:`build_all` starts one ``nvcc`` per source, all at once, and
waits for them; :func:`load` builds what is missing and returns the
``ctypes.CDLL``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from .base import MXNetError

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "build_all",
           "load"]

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                     "the port's CUDA kernels are built at first use")


def sources() -> Dict[str, Path]:
    """Kernel sources by name (file stem)."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}.{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build the named kernels (default: every source), one ``nvcc`` per
    source, all started together.  Returns ``{name: {"path", "seconds",
    "cached", "log"}}``; ``log`` holds ``ptxas -v`` (registers, shared
    memory, spills).  Raises :class:`MXNetError` if a build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    missing = [n for n in names if n not in srcs]
    if missing:
        raise MXNetError(f"no kernel source for {missing} in {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        out = _target(srcs[n])
        if out.exists():
            log = out.with_suffix(".log")
            info[n] = {"path": out, "seconds": 0.0, "cached": True,
                       "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        info[n] = {"path": out, "seconds": time.perf_counter() - t0,
                   "cached": False, "log": log}
    if failed:
        raise MXNetError("kernel build failed:\n" + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]["path"]
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
