"""Deployment predictor: the C predict API's analog, and single-file export.

Counterpart of ``mxnet_tpu/predictor.py``:

* :func:`load_weights` is the one weight-loading story of the inference
  entry points (``Predictor``/:func:`create`,
  ``serve.Engine.from_checkpoint``, ``Engine.swap_weights``,
  ``Engine.swap_draft_weights`` and ``Router.rolling_swap`` from a path).
  It reads the checkpoints of either package: a legacy prefix or a
  ``CheckpointManager`` directory (both write the same ``MXTPUND1``
  ``.params`` format).
* :class:`Predictor` is the flat ``MXPred*`` surface (reference
  ``include/mxnet/c_predict_api.h``) over a symbol bound for inference on
  one context (default: the card).  ``warmup=True`` captures the forward
  as a CUDA graph (``Executor.warmup``); ``aot_info`` says what it did.
* :func:`export_model` writes one file that a process with torch and
  without this package can serve (:func:`load_exported`).  The JAX
  package's artifact is a serialized ``jax.export`` program behind the
  magic ``MXTPUEXP2``; the port's has its own magic, ``MXTPTEXP1``, the
  same JSON header (``inputs`` as ``[name, shape, dtype]`` and
  ``num_outputs``), and a ``torch.export`` program (non-strict) of the
  inference forward with the weights in its state, saved by
  ``torch.export.save``.  The program is traced on the CPU, where every
  kernel wrapper takes its plain version (``SoftmaxOutput``'s rows:
  ``ops.nn_ops.softmax_rows_ref``), so it holds only torch operators,
  which run on any device; a kernel launched through ctypes could not be
  traced.  That is the artifact's stated portable form; :class:`Predictor`
  keeps the kernel path.  Artifacts do not cross packages: each package
  refuses the other's magic.
"""
from __future__ import annotations

import io
import json
import os
import re
import struct
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .base import MXNetError

__all__ = ["Predictor", "create", "load_weights", "load_ndarray_file",
           "export_model", "load_exported", "ExportedPredictor"]


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
    """Load inference weights from ``source`` (written by either
    package):

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


def load_ndarray_file(blob: bytes) -> Dict[str, np.ndarray]:
    """Parse a parameter blob (the ``.params`` file format) into numpy
    arrays (reference ``MXNDListCreate``)."""
    from . import ndarray as nd
    from .context import cpu
    with tempfile.NamedTemporaryFile(suffix=".params", delete=False) as f:
        f.write(blob)
        path = f.name
    try:
        loaded = nd.load(path, ctx=cpu())
    finally:
        os.unlink(path)
    if isinstance(loaded, dict):
        return {k: v.asnumpy() for k, v in loaded.items()}
    return {str(i): v.asnumpy() for i, v in enumerate(loaded)}


class Predictor:
    """Forward-only executor over a serialized model.

    Parameters
    ----------
    symbol_json : str
        Symbol JSON (contents of ``prefix-symbol.json``).
    param_blob : bytes or dict
        ``prefix-%04d.params`` file contents (``arg:``/``aux:`` keyed), or
        an already-parsed dict.
    input_shapes : dict name -> shape
        Input shapes to bind (reference ``MXPredCreate`` input spec).
    ctx : Context, optional
        Default: the innermost ``with ctx:`` scope, else the card.
    output_names : list of str, optional
        Bind only up to these internal outputs (reference
        ``MXPredCreatePartialOut``).
    warmup : bool
        Capture the forward now (``Executor.warmup``: a CUDA graph on the
        card); ``aot_info`` holds the program infos.
    """

    def __init__(self, symbol_json: str, param_blob, input_shapes,
                 ctx=None, output_names: Optional[Sequence[str]] = None,
                 warmup: bool = True):
        from . import symbol as sym_mod
        from .context import current_context
        from .model import split_param_dict
        from .ndarray import zeros

        symbol = sym_mod.load_json(symbol_json)
        if output_names:
            internals = symbol.get_internals()
            outs = internals.list_outputs()
            picked = []
            for name in output_names:
                key = name if name in outs else f"{name}_output"
                if key not in outs:
                    raise MXNetError(f"no internal output {name!r}")
                picked.append(internals[key])
            symbol = sym_mod.Group(picked) if len(picked) > 1 else picked[0]
        self._symbol = symbol
        self._ctx = ctx or current_context()

        if isinstance(param_blob, (bytes, bytearray)):
            raw = load_ndarray_file(bytes(param_blob))
        else:
            raw = {k: (v.asnumpy() if hasattr(v, "asnumpy") else
                       np.asarray(v)) for k, v in param_blob.items()}
        arg_params, aux_params = split_param_dict(raw)

        input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
        args = {}
        for name, shape in zip(symbol.list_arguments(), arg_shapes):
            arr = zeros(shape, ctx=self._ctx)
            if name in input_shapes:
                pass
            elif name in arg_params:
                if tuple(arg_params[name].shape) != tuple(shape):
                    raise MXNetError(
                        f"param {name!r} shape {arg_params[name].shape} != "
                        f"expected {shape}")
                arr[:] = arg_params[name]
            # else: an unbound non-param argument (a loss head's label
            # input) stays zero, as the reference predict API leaves it
            args[name] = arr
        aux = {}
        for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
            arr = zeros(shape, ctx=self._ctx)
            if name in aux_params:
                arr[:] = aux_params[name]
            aux[name] = arr
        self._exec = symbol.bind(self._ctx, args, grad_req="null",
                                 aux_states=aux)
        self._input_names = list(input_shapes)
        self.aot_info: List[Dict] = (
            self._exec.warmup() if warmup else [])

    # -- the MXPred* surface -------------------------------------------
    def set_input(self, name: str, value) -> None:
        """``MXPredSetInput``: the value takes the bound input's dtype."""
        if name not in self._input_names:
            raise MXNetError(f"{name!r} is not a bound input")
        bound = self._exec.arg_dict[name]
        bound[:] = np.asarray(value, dtype=np.dtype(bound.dtype))

    def forward(self) -> None:
        """``MXPredForward``."""
        self._exec.forward(is_train=False)

    def get_output(self, index: int) -> np.ndarray:
        """``MXPredGetOutput``."""
        return self._exec.outputs[index].asnumpy()

    @property
    def num_outputs(self) -> int:
        return len(self._symbol.list_outputs())

    def predict(self, **inputs) -> List[np.ndarray]:
        """Set inputs, forward, fetch all outputs."""
        for k, v in inputs.items():
            self.set_input(k, v)
        self.forward()
        return [self.get_output(i) for i in range(self.num_outputs)]

    def cache_stats(self) -> Dict[str, int]:
        """The global program cache's counters (memory_hits / disk_hits /
        misses / puts): how warm this deployment's programs are."""
        from . import compile_cache as cc
        return dict(cc.get_cache().stats)


def create(prefix: str, epoch: Optional[int] = None, input_shapes=None,
           ctx=None, output_names=None, warmup: bool = True) -> Predictor:
    """Build a :class:`Predictor` from a checkpoint of either package: a
    legacy prefix (``prefix-symbol.json`` + ``prefix-%04d.params``) or a
    ``CheckpointManager`` directory, through :func:`load_weights`."""
    if input_shapes is None:
        raise MXNetError("create() needs input_shapes")
    symbol, arg_params, aux_params, _meta = load_weights(prefix, epoch)
    if symbol is None:
        raise MXNetError(f"{prefix!r} has no symbol json; pass a "
                         "checkpoint that saved its symbol")
    blob = {f"arg:{k}": v for k, v in arg_params.items()}
    blob.update({f"aux:{k}": v for k, v in aux_params.items()})
    return Predictor(symbol.tojson(), blob, input_shapes, ctx=ctx,
                     output_names=output_names, warmup=warmup)


# ---------------------------------------------------------------------------
# Single-artifact deployment
# ---------------------------------------------------------------------------

_EXPORT_MAGIC = b"MXTPTEXP1"
_JAX_MAGICS = (b"MXTPUEXP1", b"MXTPUEXP2")


def _host(v):
    """A CPU tensor of a parameter given as an NDArray, tensor or array."""
    import torch
    if hasattr(v, "data") and isinstance(getattr(v, "data"), torch.Tensor):
        v = v.data
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").clone()
    return torch.tensor(np.asarray(v))


def _forward_module(symbol, params, aux, input_names):
    """The inference forward of ``symbol`` as a ``torch.nn.Module`` whose
    buffers hold the weights: ``forward(*inputs)`` in ``input_names``
    order returns the heads.  It draws no random key (no ``rng``), so
    nothing of the run is baked into the program."""
    import torch

    from .graph_eval import eval_symbol

    class Forward(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self._names = {}
            for kind, table in (("arg", params), ("aux", aux)):
                for i, (name, value) in enumerate(sorted(table.items())):
                    self.register_buffer(f"{kind}{i}", value)
                    self._names[f"{kind}{i}"] = (kind, name)
            self._topo = symbol._topo()

        def forward(self, *inputs):
            args, auxv = {}, {}
            for key, (kind, name) in self._names.items():
                (args if kind == "arg" else auxv)[name] = getattr(self, key)
            args.update(zip(input_names, inputs))
            heads, _ = eval_symbol(symbol, args, auxv, None, False,
                                   topo=self._topo)
            return tuple(heads)

    return Forward()


def export_model(symbol, arg_params, aux_params, input_shapes,
                 out_path: str, input_dtypes=None) -> None:
    """Serialize a forward-only model into one deployable file.

    Parameters
    ----------
    symbol, arg_params, aux_params : the trained model (e.g. from
        ``model.load_checkpoint``).
    input_shapes : dict name -> shape of every data input.
    out_path : file or ``scheme://`` URI to write.
    input_dtypes : dict name -> dtype, optional
        Input dtypes to trace with (default float32); integer inputs
        (token ids) pass e.g. ``{"data": "int32"}``.

    The file is ``MXTPTEXP1``, a little-endian int32 header length, the
    JSON header, then ``torch.export.save``'s bytes of the program (see
    the module docstring).  The program is traced on the CPU;
    :func:`load_exported` moves it to the device it serves on.
    """
    import torch

    from .stream import open_uri

    params = {k: _host(v) for k, v in arg_params.items()}
    aux = {k: _host(v) for k, v in (aux_params or {}).items()}
    input_names = sorted(input_shapes)
    # label-like arguments that only feed loss heads are zero-filled
    arg_names = symbol.list_arguments()
    missing = [n for n in arg_names
               if n not in params and n not in input_shapes]
    if missing:
        shapes_all, _, _ = symbol.infer_shape(**input_shapes)
        shape_of = dict(zip(arg_names, shapes_all))
        for n in missing:
            params[n] = torch.zeros(shape_of[n], dtype=torch.float32)
    dtypes = {n: np.dtype((input_dtypes or {}).get(n, "float32"))
              for n in input_names}
    examples = tuple(
        torch.zeros(tuple(input_shapes[n]),
                    dtype=torch.from_numpy(np.zeros(0, dtypes[n])).dtype)
        for n in input_names)
    module = _forward_module(symbol, params, aux, input_names)
    with torch.no_grad():
        program = torch.export.export(module, examples, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    header = json.dumps({
        "inputs": [[n, list(input_shapes[n]), str(dtypes[n])]
                   for n in input_names],
        "num_outputs": len(symbol.list_outputs()),
    }).encode()
    with open_uri(out_path, "wb") as f:
        f.write(_EXPORT_MAGIC)
        f.write(struct.pack("<i", len(header)))
        f.write(header)
        f.write(buf.getvalue())


class ExportedPredictor:
    """Serve an :func:`export_model` artifact on ``device`` (default the
    card, ``"cuda"``); needs only torch at run time."""

    def __init__(self, path: str, device=None):
        import torch
        from torch.export.passes import move_to_device_pass

        from .stream import open_uri
        with open_uri(path, "rb") as f:
            magic = f.read(len(_EXPORT_MAGIC))
            if magic in _JAX_MAGICS:
                raise MXNetError(
                    f"{path}: a JAX artifact ({magic.decode()}, a "
                    "serialized jax.export program) cannot be served by "
                    "mxnet_tpu_torch; export the model with "
                    "mxnet_tpu_torch.predictor.export_model")
            if magic != _EXPORT_MAGIC:
                raise MXNetError(f"{path}: not an exported model")
            (hlen,) = struct.unpack("<i", f.read(4))
            meta = json.loads(f.read(hlen).decode())
            body = f.read()
        self.device = torch.device("cuda" if device is None else device)
        program = torch.export.load(io.BytesIO(body))
        self._module = move_to_device_pass(program, self.device).module()
        self.input_names = [n for n, _, _ in meta["inputs"]]
        self.input_shapes = {n: tuple(s) for n, s, _ in meta["inputs"]}
        self.input_dtypes = {n: np.dtype(d) for n, _, d in meta["inputs"]}
        self.num_outputs = meta["num_outputs"]

    def predict(self, **inputs) -> List[np.ndarray]:
        import torch
        args = [torch.as_tensor(np.asarray(inputs[n], self.input_dtypes[n]),
                                device=self.device)
                for n in self.input_names]
        with torch.no_grad():
            outs = self._module(*args)
        return [o.cpu().numpy() for o in outs]


def load_exported(path: str, device=None) -> ExportedPredictor:
    return ExportedPredictor(path, device=device)
