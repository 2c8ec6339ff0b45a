"""Runtime-compiled user kernels: the MXRtc analog, in CUDA C++ for Hopper.

Counterpart of ``mxnet_tpu/rtc.py`` (``PallasKernel``, kernel K6 of the
port's table).  The reference compiled user CUDA source with NVRTC and
launched it with ``cuLaunchKernel``; the JAX package wraps a Pallas body
in ``pl.pallas_call``.  Here the user writes the CUDA source, and
:class:`CudaKernel` compiles it with nvcc for ``sm_90a``
(:func:`mxnet_tpu_torch._build.build_source`, the flags of the port's
own kernels) and launches it through ``cudaLaunchKernel`` on torch's
current stream::

    src = r'''
    extern "C" __global__ void axpb(const float* x, const float* y,
                                    float* o, long long n) {
      long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
      if (i < n) o[i] = x[i] * y[i] + 1.0f;
    }'''
    krn = mx.rtc.CudaKernel("axpb", src,
                            reference=lambda x, y: (x * y + 1.0,))
    krn.push([x_nd, y_nd], [out_nd])

**The source** holds one complete ``extern "C" __global__ void
<name>(...)`` function whose parameters are one pointer per input, one
pointer per output, then ``long long n``, the element count of the first
output.  The signature is checked against the call before anything is
built, so a wrong one never launches.  The runtime appends a host
launcher, ``mxt_rtc_launch(void** args, const unsigned* dims, size_t
shmem, void* stream)``, which calls ``cudaLaunchKernel`` and returns
``cudaGetLastError()``: one C entry point launches any signature.

**Geometry.** By default a 1-D grid of ``ceil(n / 256)`` blocks of 256
threads, one thread per element of the first output (the analog of the
JAX package's whole-array blocks).  ``grid``/``block`` (1-3-tuples, at
construction or per ``push``, as MXRtc's ``push(ins, outs, grid_dims,
block_dims)``) and ``shared_mem`` (dynamic shared bytes) override it.

**Devices.** CUDA arrays always take the compiled kernel; a failed build
raises :class:`MXNetError` with nvcc's log, a failed launch with
``cudaGetErrorString``.  CPU arrays run ``reference``, a plain PyTorch
callable of the same semantics (``reference(*in_tensors) -> tuple of
out tensors``), and raise without one: the arrays' device decides, and
nothing falls back.

**Cache.** ``_compiled`` is keyed like the JAX ``_run`` (output shapes,
output types, input shapes); an entry holds the loaded library and the
launch geometry.  The build itself is keyed by the source's hash on disk,
so a new shape only reloads.  ``launches`` counts this kernel's launches
(``CudaKernel.total_launches`` all of them).
"""
from __future__ import annotations

import ctypes
import math
import re
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import _build
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["CudaKernel", "build", "gpu_available", "launcher_source"]

DEFAULT_BLOCK = 256

_LAUNCHER = """
#include <cuda_runtime.h>

extern "C" int mxt_rtc_launch(void** args, const unsigned int* dims,
                              size_t shmem, void* stream) {{
  if (shmem > 48 * 1024) {{
    cudaError_t a = cudaFuncSetAttribute(
        (const void*){name}, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (a != cudaSuccess) return (int)a;
  }}
  cudaError_t e = cudaLaunchKernel(
      (const void*){name}, dim3(dims[0], dims[1], dims[2]),
      dim3(dims[3], dims[4], dims[5]), args, shmem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}}

extern "C" const char* mxt_rtc_error_string(int e) {{
  return cudaGetErrorString((cudaError_t)e);
}}
"""


def gpu_available() -> bool:
    """True when a CUDA card can run kernels (``tpu_available``)."""
    return torch.cuda.is_available()


def launcher_source(name: str) -> str:
    """The host launcher appended to the user source of kernel ``name``."""
    return _LAUNCHER.format(name=name)


def _dims(v, what) -> Tuple[int, int, int]:
    v = (v,) if isinstance(v, int) else tuple(int(x) for x in v)
    if not 1 <= len(v) <= 3 or any(x < 1 for x in v):
        raise MXNetError(f"{what} must be 1-3 positive ints, got {v}")
    return v + (1,) * (3 - len(v))


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, NDArray):
        return a.data
    if isinstance(a, torch.Tensor):
        return a
    raise MXNetError(f"CudaKernel takes NDArrays or tensors, got "
                     f"{type(a).__name__}")


class CudaKernel:
    """A named user kernel in CUDA C++, callable on NDArrays (reference
    ``MXRtc``).

    Parameters
    ----------
    name : str
        The ``extern "C" __global__`` function of ``source`` to launch.
    source : str
        CUDA C++ source holding that function (see the module doc).
    grid, block : tuple, optional
        Default launch geometry (1-3 ints each); both or neither.
    shared_mem : int
        Dynamic shared memory per block, in bytes.
    reference : callable, optional
        Plain PyTorch version, run for arrays on the CPU.
    """

    total_launches = 0

    def __init__(self, name: str, source: str, *,
                 grid: Optional[tuple] = None, block: Optional[tuple] = None,
                 shared_mem: int = 0, reference: Optional[Callable] = None):
        if not re.fullmatch(r"[A-Za-z_]\w*", name):
            raise MXNetError(f"kernel name {name!r} is not a C identifier")
        sig = re.search(
            r'extern\s+"C"\s+__global__\s+'
            r'(?:__launch_bounds__\s*\([^)]*\)\s+)?void\s+'
            + re.escape(name) + r"\s*\(([^)]*)\)", source)
        if sig is None:
            raise MXNetError(f'source has no extern "C" __global__ void '
                             f"{name}(...)")
        if (grid is None) != (block is None):
            raise MXNetError("pass both grid and block, or neither")
        self.name = name
        self.source = source
        self.grid = None if grid is None else _dims(grid, "grid")
        self.block = None if block is None else _dims(block, "block")
        self.shared_mem = int(shared_mem)
        self.reference = reference
        self.params = [p.strip() for p in sig.group(1).split(",")
                       if p.strip()]
        self.launches = 0
        self.build_info: Optional[dict] = None
        self._lib: Optional[ctypes.CDLL] = None
        self._compiled = {}

    # ------------------------------------------------------------------

    def _check_signature(self, n_in: int, n_out: int) -> None:
        want = n_in + n_out + 1
        ptrs, last = self.params[:-1], (self.params or [""])[-1]
        if (len(self.params) != want or not all("*" in p for p in ptrs)
                or not re.match(r"(const\s+)?long\s+long\b", last)):
            raise MXNetError(
                f"kernel {self.name}: {n_in} input(s) and {n_out} output(s) "
                f"need {n_in + n_out} pointer parameters then `long long "
                f"n`; the source declares ({', '.join(self.params)})")

    @property
    def full_source(self) -> str:
        """What nvcc compiles: the user source and the launcher."""
        return self.source + launcher_source(self.name)

    def _load(self, info: Optional[dict] = None) -> ctypes.CDLL:
        """Build (or find on disk) and load the library."""
        if self._lib is None:
            t0 = time.perf_counter()
            if info is None:
                info = _build.build_source(self.name, self.full_source)
            lib = ctypes.CDLL(str(info["path"]))
            lib.mxt_rtc_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_size_t, ctypes.c_void_p]
            lib.mxt_rtc_launch.restype = ctypes.c_int
            lib.mxt_rtc_error_string.argtypes = [ctypes.c_int]
            lib.mxt_rtc_error_string.restype = ctypes.c_char_p
            self.build_info = dict(info, load_seconds=time.perf_counter() - t0)
            self._lib = lib
        return self._lib

    def _entry(self, key, n: int, on_card: bool) -> dict:
        ent = self._compiled.get(key)
        if ent is None:
            if self.grid is not None:
                grid, block = self.grid, self.block
            else:
                grid = (max(1, math.ceil(n / DEFAULT_BLOCK)), 1, 1)
                block = (DEFAULT_BLOCK, 1, 1)
            ent = self._compiled[key] = {
                "lib": self._load() if on_card else None,
                "grid": grid, "block": block}
        elif on_card and ent["lib"] is None:
            ent["lib"] = self._load()
        return ent

    def _run(self, inputs, out_shapes, out_dtypes, grid=None, block=None):
        ins = [_as_tensor(a) for a in inputs]
        if not ins or not out_shapes:
            raise MXNetError("push needs at least one input and output")
        self._check_signature(len(ins), len(out_shapes))
        dev = ins[0].device
        if any(t.device != dev for t in ins):
            raise MXNetError(f"kernel {self.name}: inputs on several devices "
                             f"{sorted({str(t.device) for t in ins})}")
        out_shapes = [tuple(int(d) for d in s) for s in out_shapes]
        key = (tuple(out_shapes), tuple(out_dtypes),
               tuple(tuple(t.shape) for t in ins))
        n = math.prod(out_shapes[0])
        if dev.type == "cpu":
            self._entry(key, n, on_card=False)
            if self.reference is None:
                raise MXNetError(
                    f"kernel {self.name}: CPU arrays need a `reference` "
                    "(the kernel runs on CUDA arrays only)")
            with torch.no_grad():
                res = self.reference(*ins)
            res = (res,) if isinstance(res, torch.Tensor) else tuple(res)
            if [tuple(r.shape) for r in res] != out_shapes:
                raise MXNetError(
                    f"kernel {self.name}: reference gave shapes "
                    f"{[tuple(r.shape) for r in res]}, expected {out_shapes}")
            return tuple(r.to(d) for r, d in zip(res, out_dtypes))
        if dev.type != "cuda":
            raise MXNetError(f"kernel {self.name}: unsupported device {dev}")
        ent = self._entry(key, n, on_card=True)
        grid = ent["grid"] if grid is None else _dims(grid, "grid")
        block = ent["block"] if block is None else _dims(block, "block")
        ins = [t.contiguous() for t in ins]
        outs = [torch.empty(s, dtype=d, device=dev)
                for s, d in zip(out_shapes, out_dtypes)]
        if n == 0:
            return tuple(outs)
        # cudaLaunchKernel reads each argument through a pointer to storage
        # holding it; the ctypes objects stay alive until the call returns
        vals = ([ctypes.c_void_p(t.data_ptr()) for t in ins + outs]
                + [ctypes.c_longlong(n)])
        args = (ctypes.c_void_p * len(vals))(
            *[ctypes.addressof(v) for v in vals])
        dims = (ctypes.c_uint * 6)(*grid, *block)
        lib = ent["lib"]
        with torch.cuda.device(dev):
            rc = lib.mxt_rtc_launch(args, dims, self.shared_mem,
                                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise MXNetError(
                f"kernel {self.name} launch failed (grid {grid}, block "
                f"{block}, shared {self.shared_mem}): CUDA error {rc} "
                f"({lib.mxt_rtc_error_string(rc).decode()})")
        self.launches += 1
        CudaKernel.total_launches += 1
        return tuple(outs)

    def __call__(self, *inputs, grid: Optional[tuple] = None,
                 block: Optional[tuple] = None) -> Tuple[torch.Tensor, ...]:
        """Functional form: tensors (or NDArrays) in, a tuple with one
        output shaped and typed like the first input out."""
        x = _as_tensor(inputs[0]) if inputs else None
        if x is None:
            raise MXNetError("push needs at least one input and output")
        return self._run(inputs, [tuple(x.shape)], [x.dtype], grid=grid,
                         block=block)

    def push(self, ins: Sequence, outs: Sequence[NDArray],
             grid_dims: Optional[tuple] = None,
             block_dims: Optional[tuple] = None) -> None:
        """Launch on NDArrays and write the results into ``outs`` (the
        reference's ``Rtc.push``); ``grid_dims``/``block_dims`` override
        the geometry for this launch."""
        if not ins or not outs:
            raise MXNetError("push needs at least one input and output")
        results = self._run(ins, [o.shape for o in outs],
                            [o.data.dtype for o in outs],
                            grid=grid_dims, block=block_dims)
        for o, r in zip(outs, results):
            o._write(r)


def build(kernels: Sequence[CudaKernel]) -> dict:
    """Build and load several kernels, one ``nvcc`` per source, all
    started together (distinct names); ``{name: build entry}``."""
    todo = [k for k in kernels if k._lib is None]
    infos = _build.build_sources({k.name: k.full_source for k in todo})
    for k in todo:
        k._load(infos[k.name])
    return {k.name: k.build_info for k in kernels}
