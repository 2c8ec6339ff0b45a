"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Every ``csrc/*.cu`` compiles on its own into a shared library with a plain
C interface for ``sm_90a`` (Hopper).  The library's name carries a hash
of its source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header never loads a stale build.
Outputs go to ``_kernels/`` inside the package, which ``.gitignore``
lists, or under ``<dir>/cuda`` with a persistent program cache
(``MXNET_TPU_CACHE_DIR``, :func:`mxnet_tpu_torch.compile_cache.
enable_persistent_cache`), where a restarted process finds them.
:func:`build_all` starts one ``nvcc`` per source, all at once, and
waits for them; :func:`load` builds what is missing and returns the
``ctypes.CDLL``.  :func:`build_sources` builds sources given as text (the
runtime kernels of :mod:`mxnet_tpu_torch.rtc`) into ``rtc/`` there,
with the same nvcc flags.
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
           "build_source", "build_sources", "load", "build_dir",
           "set_build_dir", "build_count"]

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_dir_override: Optional[Path] = None
# libraries this process built or already counted as loaded from disk
_known: set = set()
# nvcc builds this process ran plus libraries it loaded for the first time
_builds = 0
_count_lock = threading.Lock()


def build_count() -> int:
    """Kernel libraries this process has built with nvcc or loaded for
    the first time (``ElasticTrainer``'s ``retraces`` reads its change
    across a resize)."""
    return _builds


def set_build_dir(path) -> None:
    """Build into (and load from) ``path`` from now on."""
    global _dir_override
    _dir_override = Path(path)


def _persistent_dir() -> Optional[Path]:
    if _dir_override is not None:
        return _dir_override
    root = os.environ.get("MXNET_TPU_CACHE_DIR")
    if root and os.environ.get("MXNET_TPU_CACHE", "1") != "0":
        return Path(root) / "cuda"
    return None


def build_dir() -> Path:
    """Where kernel libraries go: the persistent cache's ``cuda/`` when
    one is set, else ``_kernels/`` in the package."""
    return _persistent_dir() or BUILD_DIR


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
    return build_dir() / f"lib{src.stem}.{h.hexdigest()[:16]}.so"


def _compile(jobs: Dict[str, tuple]) -> Dict[str, dict]:
    """Run one ``nvcc`` per ``{name: (source path, output path)}``, all
    started together; each output is written to a temp file and
    ``os.replace``d into place.  An output that exists is reused."""
    info: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    persistent = _persistent_dir()
    for n, (src, out) in jobs.items():
        if out.exists():
            log = out.with_suffix(".log")
            info[n] = {"path": out, "seconds": 0.0, "cached": True,
                       "log": log.read_text() if log.exists() else ""}
            if (persistent is not None and persistent in out.parents
                    and out not in _known):
                # a library an earlier process built, counted once
                _known.add(out)
                from . import compile_cache
                compile_cache.get_cache().note_disk_hit()
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
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
        _known.add(out)
        _count_build()
        info[n] = {"path": out, "seconds": time.perf_counter() - t0,
                   "cached": False, "log": log}
    if failed:
        raise MXNetError("kernel build failed:\n" + "\n".join(failed))
    return info


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
    return _compile({n: (srcs[n], _target(srcs[n])) for n in names})


def build_sources(texts: Dict[str, str]) -> Dict[str, dict]:
    """Build each CUDA source text of ``{name: text}`` into
    ``<build_dir()>/rtc/lib<name>.<hash>.so``, one ``nvcc`` per source, all
    started together (the hash covers the text and the flags, so an edited
    source never loads a stale build, and the same text only reloads).
    Returns ``build_all``'s entries; raises :class:`MXNetError` carrying
    nvcc's log if a build fails."""
    jobs = {}
    for name, text in texts.items():
        h = hashlib.sha256(text.encode())
        h.update(" ".join(NVCC_FLAGS).encode())
        stem = f"{name}.{h.hexdigest()[:16]}"
        out = build_dir() / "rtc" / f"lib{stem}.so"
        src = out.with_name(f"{stem}.cu")
        if not out.exists():
            src.parent.mkdir(parents=True, exist_ok=True)
            tmp = src.with_name(f"{src.name}.tmp{os.getpid()}")
            tmp.write_text(text)
            os.replace(tmp, src)
        jobs[name] = (src, out)
    return _compile(jobs)


def build_source(name: str, text: str) -> dict:
    """:func:`build_sources` for one source."""
    return build_sources({name: text})[name]


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]["path"]
            lib = _loaded[name] = ctypes.CDLL(str(path))
            _count_build()
        return lib


def _count_build() -> None:
    global _builds
    with _count_lock:
        _builds += 1
