"""The serving code that the C predict API (``c_predict_api.cc``) embeds.

``_build.build_c_predict`` compiles this file's text into the library, and
the library runs it in its embedded interpreter once, at the first
``MXTPUPredCreate``.  It imports only the standard library, numpy and
torch, never the port: the C host process needs nothing but a Python
with torch on its path.  :class:`_Served` mirrors
``mxnet_tpu_torch.predictor.ExportedPredictor``: it reads an
``export_model`` artifact (``MXTPTEXP1``, a little-endian int32 header
length, the JSON header, ``torch.export.save``'s bytes), loads the
program with ``torch.export.load`` and moves it to the serving device
with ``move_to_device_pass``.

The device is ``MXNET_TPU_PREDICT_DEVICE`` (default ``cuda``).  Asked for
the card where there is none, :class:`_Served` raises, and
``MXTPUPredCreate`` returns -1 with the reason: it never serves on the
CPU unless told to.  Float32 products are full float32 (no TF32), as the
port runs them.  All tensors cross the C ABI as float32; each input is
cast to the dtype its header entry records.
"""
import io
import json
import os
import struct

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

_MAGIC = b"MXTPTEXP1"
_JAX_MAGICS = (b"MXTPUEXP1", b"MXTPUEXP2")


def serving_device():
    """The device of ``MXNET_TPU_PREDICT_DEVICE``; raises when it names a
    card and there is none."""
    name = os.environ.get("MXNET_TPU_PREDICT_DEVICE", "cuda")
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"MXNET_TPU_PREDICT_DEVICE={name!r} asks for a CUDA device and "
            "torch.cuda.is_available() is False; set "
            "MXNET_TPU_PREDICT_DEVICE=cpu to serve on the CPU")
    return device


class _Served:
    def __init__(self, path):
        with open(path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic in _JAX_MAGICS:
                raise ValueError(
                    f"{path}: a JAX artifact ({magic.decode()}); this "
                    "library serves mxnet_tpu_torch.predictor.export_model "
                    "artifacts")
            if magic != _MAGIC:
                raise ValueError(f"{path}: not an exported model")
            (hlen,) = struct.unpack("<i", f.read(4))
            meta = json.loads(f.read(hlen).decode())
            body = f.read()
        self.device = serving_device()
        program = torch.export.load(io.BytesIO(body))
        self.module = move_to_device_pass(program, self.device).module()
        self.names = [n for n, _, _ in meta["inputs"]]
        self.shapes = {n: tuple(s) for n, s, _ in meta["inputs"]}
        self.dtypes = {n: np.dtype(d) for n, _, d in meta["inputs"]}
        self.inputs = {}
        self.outputs = []

    def set_input(self, name, buf):
        """Copy a float32 buffer in as input ``name``, on the device."""
        if name not in self.shapes:
            raise KeyError(f"unknown input {name!r}; have {self.names}")
        arr = np.frombuffer(buf, dtype=np.float32)
        want = int(np.prod(self.shapes[name])) if self.shapes[name] else 1
        if arr.size != want:
            raise ValueError(f"input {name!r}: got {arr.size} elements, "
                             f"expected {want}")
        host = arr.reshape(self.shapes[name]).astype(self.dtypes[name])
        self.inputs[name] = torch.as_tensor(host, device=self.device)

    def forward(self):
        missing = [n for n in self.names if n not in self.inputs]
        if missing:
            raise ValueError(f"inputs not set: {missing}")
        # full float32 products for this call only: a host process that
        # owns the interpreter keeps its own settings
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                outs = self.module(*[self.inputs[n] for n in self.names])
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        self.outputs = [np.ascontiguousarray(o.float().cpu().numpy())
                        for o in outs]

    def output_bytes(self, i):
        return self.outputs[i].tobytes()

    def output_shape(self, i):
        return list(self.outputs[i].shape)
