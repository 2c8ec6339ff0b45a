"""Neural-network operators.

Counterpart of ``mxnet_tpu/ops/nn_ops.py``: Activation, FullyConnected,
Convolution, Pooling, BatchNorm, Flatten, Reshape, Embedding, LayerNorm
and SoftmaxOutput (with its deprecated alias Softmax, also in its loss
mode); the image-classification zoo's LeakyReLU, Deconvolution, Dropout,
Concat, SliceChannel, SwapAxis, Cast, ElementWiseSum, BlockGrad, Crop,
L2Normalization, LRN, SoftmaxActivation and UpSampling; the legacy heads
Linear/Logistic/MAERegressionOutput, MakeLoss and
IdentityAttachKLSparseReg; the detector's ROIPooling; and
``_CrossDeviceCopy``, the marker of a crossing between two contexts of a
model-parallel graph (identity in a graph, as in the JAX package; the
executor moves the values with :func:`cross_device_copy`).

Layouts stay NCHW/OIHW as in the JAX package.  Convolutions go to cuDNN
through ``F.conv2d`` (``conv_backward.conv2d``, whose backward
``MXNET_TPU_CONV_BWD=tuned`` restructures per shape) and matrix products to cuBLAS through ``matmul``, as
the JAX package leaves them to XLA; ``FullyConnected(quant="fp8")`` takes
the block-scaled fp8 product of ``quant.fp8_linear`` (cuBLAS's fp8 GEMM).  Where torch's own ops would
compute something else than the reference, the reference's expression is
written out:

* Pooling uses the reference's ceil convention (``_pool_out_dim``): the
  input is padded explicitly (-inf for max, 0 for avg/sum) out to the
  last window, and avg divides by the full ``kh * kw``, padding included.
* BatchNorm's training statistics are single-pass ``E[x^2] - E[x]^2``
  clamped at 0; the moving averages take the biased variance.  Autograd
  differentiates the same expression, as JAX's does.
* Deconvolution is cuDNN's transposed convolution without padding,
  cropped from ``pad`` and zero-extended to the adjusted size
  (``_deconv_fwd``); Dropout keeps ``uniform < 1 - p`` from the node's
  generator (:func:`dropout_mask`) and scales by ``1 / (1 - p)``.
* ROIPooling rounds the scaled corners half to even (``torch.round``,
  as ``jnp.round``), truncates the batch index, takes each bin's
  ``[start, end)`` rows and columns with ceil ends, and maxes over the
  bin's whole window at once (``amax`` over both axes), so the gradient
  splits equally among every tied maximum of the window, as JAX's
  ``reduce_max`` does; an empty bin gives 0.  The windows are made a
  chunk of rois at a time (``ROI_POOL_CHUNK_ELEMS``), recomputed in the
  backward, so memory stays bounded at a Fast R-CNN head's size.

The ``SoftmaxOutput`` forward runs the row softmax through kernel K1
(:func:`softmax_rows`, ``csrc/softmax_rows.cu``) on CUDA tensors and its
plain version :func:`softmax_rows_ref` on CPU tensors; the wrapper counts
its launches in ``softmax_rows.launches`` and by kernel form ("warp" up to
1024 columns, "block" beyond) in ``softmax_rows.launches_by_form``.  With
``out_mode="loss"`` the forward emits the per-position cross-entropy
instead, from an f32 logsumexp, gathering the label's logit before the
f32 cast, as the JAX package does; it launches no kernel.  The backward reproduces the JAX
``_bwd`` rule (``(prob - onehot) * scale`` times the head cotangent,
broadcast over the classes when it is label-shaped), recomputing the
softmax with ``torch.softmax`` exactly where the JAX package recomputes
it with ``jax.nn.softmax``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import _build
from ..analysis import program as _program
from ..base import MXNetError
from .conv_backward import conv2d
from .registry import OpDef, OpParam, elemwise_shape, register_op

__all__ = ["softmax_rows", "softmax_rows_ref", "softmax_rows_form",
           "layer_norm", "SOFTMAX_MAX_COLS", "SOFTMAX_WARP_MAX_COLS"]

SOFTMAX_MAX_COLS = 16384
SOFTMAX_WARP_MAX_COLS = 1024     # K1's "warp" form holds a row in registers
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOFTMAX_FORMS = {"block": 0, "warp": 1}


def _amp_f32(x):
    """Promote bf16/f16 to f32 for statistics and loss math."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x


def _pair(v, n=2):
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return tuple(v) * n
        return tuple(int(x) for x in v)
    return (int(v),) * n


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
}

register_op(OpDef(
    name="Activation",
    forward=lambda ctx, params, x: _ACTIVATIONS[params["act_type"]](x),
    arguments=("data",),
    params={"act_type": OpParam("act_type", "str", required=True,
                                enum=tuple(_ACTIVATIONS))},
    infer_shape=elemwise_shape,
    doc="Elementwise activation (relu/sigmoid/tanh/softrelu).",
))


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------

def _fc_fwd(ctx, params, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1)
    if params["quant"] == "fp8":
        # the block-scaled fp8 product (quant.fp8_linear: e4m3 forward,
        # e5m2 gradients, f32 accumulation); `weight` stays the master
        from .. import quant
        out = quant.fp8_linear(x, weight,
                               quant.resolve_quant("fp8")).to(weight.dtype)
    else:
        if x.dtype != weight.dtype:
            x = x.to(weight.dtype)
        out = x @ weight.t()
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _fc_shape(params, in_shapes):
    n_in = 2 if params["no_bias"] else 3
    shapes = list(in_shapes) + [None] * (n_in - len(in_shapes))
    d = shapes[0]
    h = params["num_hidden"]
    if d is not None:
        shapes[1] = (h, int(np.prod(d[1:])))
        out = (d[0], h)
    else:
        out = None
    if not params["no_bias"]:
        shapes[2] = (h,)
    return shapes, [out], []


register_op(OpDef(
    name="FullyConnected",
    forward=_fc_fwd,
    arguments=lambda p: (["data", "weight"] if p["no_bias"]
                         else ["data", "weight", "bias"]),
    params={
        "num_hidden": OpParam("num_hidden", "int", required=True),
        "no_bias": OpParam("no_bias", "bool", default=False),
        "quant": OpParam("quant", "str", default="", enum=("", "fp8")),
    },
    infer_shape=_fc_shape,
    doc="Linear layer: out = data @ weight.T + bias.",
))


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

def _conv_fwd(ctx, params, data, weight, bias=None):
    if data.dtype != weight.dtype:
        data = data.to(weight.dtype)
    # conv2d carries the per-shape tuned backward paths (conv_backward.py)
    out = conv2d(data, weight, stride=_pair(params["stride"]),
                 pad=_pair(params["pad"]), dilate=_pair(params["dilate"]),
                 groups=params["num_group"])
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out


def _conv_out_dim(x, k, s, p, d=1):
    eff = (k - 1) * d + 1
    return (x + 2 * p - eff) // s + 1


def _conv_shape(params, in_shapes):
    n_in = 2 if params["no_bias"] else 3
    shapes = list(in_shapes) + [None] * (n_in - len(in_shapes))
    d = shapes[0]
    kh, kw = _pair(params["kernel"])
    sh, sw = _pair(params["stride"])
    dh, dw = _pair(params["dilate"])
    ph, pw = _pair(params["pad"])
    f = params["num_filter"]
    g = params["num_group"]
    if d is not None:
        n, c, h, w = d
        shapes[1] = (f, c // g, kh, kw)
        out = (n, f, _conv_out_dim(h, kh, sh, ph, dh),
               _conv_out_dim(w, kw, sw, pw, dw))
    else:
        out = None
    if not params["no_bias"]:
        shapes[2] = (f,)
    return shapes, [out], []


register_op(OpDef(
    name="Convolution",
    forward=_conv_fwd,
    arguments=lambda p: (["data", "weight"] if p["no_bias"]
                         else ["data", "weight", "bias"]),
    params={
        "kernel": OpParam("kernel", "shape", required=True),
        "stride": OpParam("stride", "shape", default=(1, 1)),
        "dilate": OpParam("dilate", "shape", default=(1, 1)),
        "pad": OpParam("pad", "shape", default=(0, 0)),
        "num_filter": OpParam("num_filter", "int", required=True),
        "num_group": OpParam("num_group", "int", default=1),
        "no_bias": OpParam("no_bias", "bool", default=False),
        # accepted for API parity; cuDNN picks its own workspace
        "workspace": OpParam("workspace", "int", default=512),
        "cudnn_tune": OpParam("cudnn_tune", "str", default=""),
    },
    infer_shape=_conv_shape,
    doc="2D convolution, NCHW/OIHW, grouped + dilated (cuDNN).",
))


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

def _pool_out_dim(x, k, s, p):
    # reference ceil convention: min(x + 2p - k + s - 1, x + 2p - 1) / s + 1
    return min(x + 2 * p - k + s - 1, x + 2 * p - 1) // s + 1


def _pool_fwd(ctx, params, x):
    kh, kw = _pair(params["kernel"])
    sh, sw = _pair(params["stride"])
    ph, pw = _pair(params["pad"])
    ptype = params["pool_type"]
    if params["global_pool"]:
        kh, kw = x.shape[2], x.shape[3]
        sh, sw, ph, pw = 1, 1, 0, 0
    h, w = x.shape[2], x.shape[3]
    oh = _pool_out_dim(h, kh, sh, ph)
    ow = _pool_out_dim(w, kw, sw, pw)
    # pad right/bottom out to the last window the ceil convention counts
    extra_h = max(0, (oh - 1) * sh + kh - (h + 2 * ph))
    extra_w = max(0, (ow - 1) * sw + kw - (w + 2 * pw))
    pads = (pw, pw + extra_w, ph, ph + extra_h)
    in_dtype = x.dtype
    if ptype == "max":
        if any(pads):
            x = F.pad(x, pads, value=float("-inf"))
        out = F.max_pool2d(x, (kh, kw), (sh, sw))
    else:
        x = _amp_f32(x)
        if any(pads):
            x = F.pad(x, pads)
        # unpadded avg pooling divides every window by kh * kw, padding
        # included, as the reference does
        out = F.avg_pool2d(x, (kh, kw), (sh, sw))
        if ptype == "sum":
            out = out * (kh * kw)
    return out.to(in_dtype)


def _pool_shape(params, in_shapes):
    (d,) = in_shapes
    if d is None:
        return in_shapes, [None], []
    n, c, h, w = d
    if params["global_pool"]:
        return [tuple(d)], [(n, c, 1, 1)], []
    kh, kw = _pair(params["kernel"])
    sh, sw = _pair(params["stride"])
    ph, pw = _pair(params["pad"])
    return ([tuple(d)], [(n, c, _pool_out_dim(h, kh, sh, ph),
                          _pool_out_dim(w, kw, sw, pw))], [])


register_op(OpDef(
    name="Pooling",
    forward=_pool_fwd,
    arguments=("data",),
    params={
        "kernel": OpParam("kernel", "shape", required=True),
        "pool_type": OpParam("pool_type", "str", default="max",
                             enum=("max", "avg", "sum")),
        "stride": OpParam("stride", "shape", default=(1, 1)),
        "pad": OpParam("pad", "shape", default=(0, 0)),
        "global_pool": OpParam("global_pool", "bool", default=False),
    },
    infer_shape=_pool_shape,
    doc="2D max/avg/sum pooling, ceil convention.",
))


# ---------------------------------------------------------------------------
# BatchNorm -- aux: moving_mean, moving_var
# ---------------------------------------------------------------------------

def _bn_fwd(ctx, params, data, gamma, beta):
    eps = params["eps"]
    momentum = params["momentum"]
    axes = tuple(i for i in range(data.ndim) if i != 1)
    cshape = (1, -1) + (1,) * (data.ndim - 2)
    if params["fix_gamma"]:
        gamma = torch.ones_like(gamma).detach()
    x32 = _amp_f32(data)
    if ctx.is_train and not params["use_global_stats"]:
        if ctx.sync is None:
            mean = x32.mean(dim=axes)
            var = torch.clamp_min(
                torch.square(x32).mean(dim=axes) - torch.square(mean), 0.0)
        else:
            # the batch is split over mesh members: the same moments over
            # every member's rows (a differentiable sum of the members'
            # partial sums, so the backward sees the global statistics)
            count = float(ctx.sync.host_sum(x32.numel() // x32.shape[1]))
            tot = ctx.sync.allreduce(torch.stack(
                [x32.sum(dim=axes), torch.square(x32).sum(dim=axes)]))
            mean = tot[0] / count
            var = torch.clamp_min(tot[1] / count - torch.square(mean), 0.0)
        ctx.aux_updates["moving_mean"] = (
            momentum * ctx.aux["moving_mean"]
            + (1.0 - momentum) * mean.detach())
        ctx.aux_updates["moving_var"] = (
            momentum * ctx.aux["moving_var"]
            + (1.0 - momentum) * var.detach())
    else:
        mean = ctx.aux["moving_mean"]
        var = ctx.aux["moving_var"]
    inv = torch.rsqrt(var + eps)
    g32 = gamma.to(x32.dtype)
    scale = (g32 * inv).reshape(cshape)
    shift = (beta.to(x32.dtype) - mean * g32 * inv).reshape(cshape)
    return data * scale.to(data.dtype) + shift.to(data.dtype)


def _bn_shape(params, in_shapes):
    shapes = list(in_shapes) + [None] * (3 - len(in_shapes))
    d = shapes[0]
    if d is None:
        return shapes, [None], [None, None]
    c = (d[1],)
    shapes[1] = c
    shapes[2] = c
    return shapes, [tuple(d)], [c, c]


register_op(OpDef(
    name="BatchNorm",
    forward=_bn_fwd,
    arguments=("data", "gamma", "beta"),
    aux_states=("moving_mean", "moving_var"),
    params={
        "eps": OpParam("eps", "float", default=1e-3),
        "momentum": OpParam("momentum", "float", default=0.9),
        "fix_gamma": OpParam("fix_gamma", "bool", default=True),
        "use_global_stats": OpParam("use_global_stats", "bool",
                                    default=False),
    },
    infer_shape=_bn_shape,
    doc="Batch normalization over the channel axis with moving-stat aux "
        "states.",
))


# ---------------------------------------------------------------------------
# Flatten
# ---------------------------------------------------------------------------

register_op(OpDef(
    name="Flatten",
    forward=lambda ctx, params, x: x.reshape(x.shape[0], -1),
    arguments=("data",),
    infer_shape=lambda params, in_shapes: (
        in_shapes,
        [None if in_shapes[0] is None
         else (in_shapes[0][0], int(np.prod(in_shapes[0][1:])))],
        []),
    doc="Collapse all trailing axes into one.",
))


# ---------------------------------------------------------------------------
# Reshape
# ---------------------------------------------------------------------------

def _reshape_target(params, in_shape):
    tgt = params["target_shape"] if params["target_shape"] else params["shape"]
    if not tgt:
        raise MXNetError("Reshape needs `shape` (or legacy `target_shape`)")
    tgt = list(tgt)
    if 0 in tgt and -1 not in tgt:
        # legacy target_shape: 0 means inferred batch dim
        tgt = [-1 if t == 0 else t for t in tgt]
    if in_shape is None:
        return None
    total = int(np.prod(in_shape))
    if -1 in tgt:
        rest = int(np.prod([t for t in tgt if t != -1]))
        tgt = [total // rest if t == -1 else t for t in tgt]
    return tuple(tgt)


register_op(OpDef(
    name="Reshape",
    forward=lambda ctx, params, x: x.reshape(
        _reshape_target(params, tuple(x.shape))),
    arguments=("data",),
    params={
        "shape": OpParam("shape", "shape", default=()),
        "target_shape": OpParam("target_shape", "shape", default=()),
    },
    infer_shape=lambda params, in_shapes: (
        in_shapes, [_reshape_target(params, in_shapes[0])], []),
    doc="Reshape with -1/0 wildcard support.",
))


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def _embedding_shape(params, in_shapes):
    shapes = list(in_shapes) + [None] * (2 - len(in_shapes))
    d = shapes[0]
    shapes[1] = (params["input_dim"], params["output_dim"])
    out = None if d is None else tuple(d) + (params["output_dim"],)
    return shapes, [out], []


def _embedding_fwd(ctx, params, data, weight):
    """``jnp.take(weight, data.astype(int32), axis=0)``, the JAX package's
    lookup: float ids truncate to int32 as XLA converts them (NaN to 0,
    saturating), ids in ``[-n, n)`` pick their row (negatives wrap), and
    any other id gives a row of NaN (``take``'s fill mode) and no
    gradient.  An out-of-range id must not index: on the card that is a
    device-side fault."""
    idx, valid = embedding_index(data, weight.shape[0])
    rows = weight[idx]
    return torch.where(valid.unsqueeze(-1), rows,
                       torch.full((), float("nan"), dtype=rows.dtype,
                                  device=rows.device))


def embedding_index(data: torch.Tensor, n: int):
    """The Embedding op's row of each id over an ``n``-row table:
    ``(row, valid)``, the row 0 where the id is out of range."""
    ids = data
    if ids.is_floating_point():
        ids = torch.nan_to_num(ids.double(), nan=0.0, posinf=2.0 ** 31 - 1,
                               neginf=-2.0 ** 31).clamp(-2.0 ** 31,
                                                        2.0 ** 31 - 1)
    ids = ids.long()
    valid = (ids >= -n) & (ids < n)
    return torch.where(valid, torch.remainder(ids, n),
                       torch.zeros_like(ids)), valid


register_op(OpDef(
    name="Embedding",
    forward=_embedding_fwd,
    arguments=("data", "weight"),
    params={
        "input_dim": OpParam("input_dim", "int", required=True),
        "output_dim": OpParam("output_dim", "int", required=True),
    },
    infer_shape=_embedding_shape,
    doc="Index into an embedding table; grad is a scatter-add.",
))


# ---------------------------------------------------------------------------
# _CrossDeviceCopy and the crossings of a model-parallel graph
# ---------------------------------------------------------------------------

class _CrossDeviceCopyFn(torch.autograd.Function):
    """A value moved to another context; its gradient moves back."""

    @staticmethod
    def forward(ctx, x, device):
        ctx.src = x.device
        return x.to(device, copy=True)

    @staticmethod
    def backward(ctx, g):
        cross_device_copy.grad_crossings += 1
        return g.to(ctx.src), None


def cross_device_copy(x: torch.Tensor, ctx) -> torch.Tensor:
    """``x`` copied onto context ``ctx`` (a crossing between two groups
    of a ``group2ctx`` placement), differentiably: the gradient crosses
    back.  ``cross_device_copy.crossings`` counts the forward crossings
    and ``.grad_crossings`` the backward ones."""
    from ..context import resolve_device
    cross_device_copy.crossings += 1
    return _CrossDeviceCopyFn.apply(x, resolve_device(ctx))


cross_device_copy.crossings = 0
cross_device_copy.grad_crossings = 0

register_op(OpDef(
    name="_CrossDeviceCopy",
    forward=lambda ctx, params, x: x,
    arguments=("data",),
    infer_shape=elemwise_shape,
    doc="Device-boundary copy marker; the executor's placement realizes "
        "the transfer.",
))


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def layer_norm(x, gamma, beta, eps):
    """Last-axis layer normalization; statistics in f32 under bf16/fp16,
    the result in ``x``'s type."""
    x32 = _amp_f32(x)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    xhat = (x32 - mean) * torch.rsqrt(var + eps)
    out = xhat * gamma.to(x32.dtype) + beta.to(x32.dtype)
    return out.to(x.dtype)


def _layernorm_shape(params, in_shapes):
    d = (list(in_shapes) + [None])[0]
    if d is None:
        return in_shapes, [None], []
    feat = (d[-1],)
    return [tuple(d), feat, feat], [tuple(d)], []


register_op(OpDef(
    name="LayerNorm",
    forward=lambda ctx, params, x, gamma, beta: layer_norm(
        x, gamma, beta, params["eps"]),
    arguments=("data", "gamma", "beta"),
    params={"eps": OpParam("eps", "float", default=1e-5)},
    infer_shape=_layernorm_shape,
    doc="Last-axis layer normalization with learnable scale/shift.",
))


# ---------------------------------------------------------------------------
# K1: the row softmax
# ---------------------------------------------------------------------------

def softmax_rows_ref(x):
    """Plain PyTorch version of the kernel: max, exp, sum, divide, in f32;
    the result has ``x.dtype``."""
    v = x.float()
    e = torch.exp(v - v.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("softmax_rows")
    if not getattr(lib, "_mxt_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mxt_softmax_rows.argtypes = [vp, vp, ci, ci, ci, ci, vp]
        lib.mxt_softmax_rows.restype = ci
        lib.mxt_error_string.argtypes = [ci]
        lib.mxt_error_string.restype = ctypes.c_char_p
        lib._mxt_typed = True
    return lib


def softmax_rows_form(ncols: int) -> str:
    """K1's kernel form for rows of ``ncols`` columns: ``"warp"`` (one
    warp per row, the row in registers) up to
    :data:`SOFTMAX_WARP_MAX_COLS`, ``"block"`` (one block per row) beyond."""
    return "warp" if ncols <= SOFTMAX_WARP_MAX_COLS else "block"


@_program.kernel_region
def softmax_rows(x, form: Optional[str] = None):
    """Row softmax of a 2-D float32/bfloat16 ``x`` with at most
    :data:`SOFTMAX_MAX_COLS` columns; the result has ``x.dtype``.
    ``form`` forces a kernel form (default :func:`softmax_rows_form`'s
    choice); ``"block"`` takes every width, ``"warp"`` at most
    :data:`SOFTMAX_WARP_MAX_COLS` columns, and a form that cannot take
    ``x`` raises.

    CPU tensors go to :func:`softmax_rows_ref` (the form is only
    validated).  CUDA tensors launch the kernel of
    ``csrc/softmax_rows.cu`` in its form (and count the launch) or raise.
    """
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise MXNetError(f"softmax_rows: x must be a non-empty [N, C] "
                         f"array, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise MXNetError(f"softmax_rows: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.shape[1] > SOFTMAX_MAX_COLS:
        raise MXNetError(f"softmax_rows: {x.shape[1]} columns > "
                         f"{SOFTMAX_MAX_COLS}")
    n, c = x.shape
    if form is None:
        form = softmax_rows_form(c)
    elif form not in _SOFTMAX_FORMS or (
            form == "warp" and c > SOFTMAX_WARP_MAX_COLS):
        raise MXNetError(f"softmax_rows: form {form!r} cannot take {c} "
                         f"columns (allowed: "
                         f"{sorted({'block', softmax_rows_form(c)})})")
    _program.note_kernel("softmax_rows", reads=(x,))
    if x.device.type == "cpu":
        return softmax_rows_ref(x)
    if x.device.type != "cuda":
        raise MXNetError(f"softmax_rows: unsupported device {x.device}")
    if not x.is_contiguous():
        raise MXNetError("softmax_rows: x must be contiguous")
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.mxt_softmax_rows(
            x.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype], n, c,
            _SOFTMAX_FORMS[form],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise MXNetError(f"softmax_rows kernel launch failed ({form} form): "
                         f"CUDA error {rc} "
                         f"({lib.mxt_error_string(rc).decode()})")
    softmax_rows.launches += 1
    softmax_rows.launches_by_form[form] += 1
    return out


softmax_rows.launches = 0
softmax_rows.launches_by_form = dict.fromkeys(_SOFTMAX_FORMS, 0)


def _softmax_rows(x):
    """The JAX package's dispatch (``nn_ops._softmax_rows``) without its
    TPU-only VMEM block rule: 2-D float32/bfloat16 rows of at most
    16384 columns go to the kernel, anything else to ``torch.softmax``,
    where the reference uses ``jax.nn.softmax``."""
    if (x.dim() != 2 or x.shape[-1] > SOFTMAX_MAX_COLS
            or x.dtype not in _DTYPE_CODES):
        return torch.softmax(x, dim=-1)
    return softmax_rows(x)


# ---------------------------------------------------------------------------
# SoftmaxOutput
# ---------------------------------------------------------------------------

def _nll(data, label, p):
    """Loss mode: per-position ``logsumexp - logit[label]`` in f32, masked
    at ``ignore_label`` when ``use_ignore``.  The label's logit is gathered
    before the f32 cast (the same bits, without an f32 copy of the
    logits)."""
    axis = 1 if (p["multi_output"] and data.dim() > 2) else -1
    lse = torch.logsumexp(_amp_f32(data), dim=axis)
    picked = _amp_f32(torch.gather(data, axis,
                                   label.long().unsqueeze(axis)))
    nll = lse - picked.squeeze(axis)
    if p["use_ignore"]:
        nll = nll * (label != p["ignore_label"]).to(nll.dtype)
    return nll


class _SoftmaxOutputFn(torch.autograd.Function):
    """Forward: probabilities, or the per-position cross-entropy in loss
    mode.  Backward: the reference rule ``(prob - onehot(label)) *
    grad_scale [/ denom] * head cotangent``, with ``ignore_label``
    masking; the label gets a zero gradient."""

    @staticmethod
    def forward(ctx, data, label, p, sync=None):
        ctx.save_for_backward(data, label)
        ctx.p = p
        # a batch split over mesh members normalizes by every member's
        # count: the denominator is taken here, where the members meet
        ctx.denom = (None if sync is None or p["normalization"] == "null"
                     else _global_denom(sync, label, p))
        if p["out_mode"] == "loss":
            return _nll(data, label, p)
        in_dtype = data.dtype
        x = _amp_f32(data)
        if p["multi_output"] and x.dim() > 2:
            prob = torch.softmax(x, dim=1)
        else:
            prob = _softmax_rows(x)
        if p["out_dtype"] == "same":
            prob = prob.to(in_dtype)
        return prob

    @staticmethod
    def backward(ctx, cot):
        data, label = ctx.saved_tensors
        p = ctx.p
        in_dtype = data.dtype
        x = _amp_f32(data)
        multi = p["multi_output"] and x.dim() > 2
        axis = 1 if multi else -1
        ncls = x.shape[axis]
        lab = label.long()
        prob = torch.softmax(x, dim=axis)
        classes = torch.arange(ncls, device=x.device)
        if multi:
            classes = classes.reshape((1, ncls) + (1,) * (x.dim() - 2))
            oh = (lab.unsqueeze(1) == classes).to(x.dtype)
        else:
            oh = (lab.unsqueeze(-1) == classes).to(x.dtype)
        mask = (label != p["ignore_label"]).to(x.dtype)

        def norm_denom():
            if ctx.denom is not None:
                return ctx.denom
            # counted in f32, as the reference does
            # (0-d fills, not torch.tensor: a host copy would sync)
            if p["normalization"] == "batch":
                return torch.full((), float(label.shape[0]),
                                  dtype=torch.float32, device=x.device)
            if p["normalization"] == "valid":
                if p["use_ignore"]:
                    return torch.clamp_min(mask.float().sum(), 1.0)
                return torch.full((), max(float(label.numel()), 1.0),
                                  dtype=torch.float32, device=x.device)
            return None

        cot = cot.to(x.dtype)
        if cot.dim() < x.dim():
            # label-shaped cotangent (loss mode): broadcast over the classes
            cot = cot.unsqueeze(1) if multi else cot.unsqueeze(-1)
        if multi:
            grad = (prob - oh) * p["grad_scale"]
            if p["use_ignore"]:
                grad = grad * mask.unsqueeze(1)
            denom = norm_denom()
            if denom is not None:
                grad = grad / denom.to(grad.dtype)
            grad = grad * cot
        else:
            g = prob - oh
            if p["use_ignore"]:
                g = g * mask.unsqueeze(-1)
            denom = norm_denom()
            scale = torch.full((), p["grad_scale"], dtype=x.dtype,
                               device=x.device)
            if denom is not None:
                scale = scale / denom.to(x.dtype)
            if denom is not None or p["grad_scale"] != 1.0:
                g = g * scale
            grad = g * cot
        return grad.to(in_dtype), None, None, None


def _global_denom(sync, label, p) -> torch.Tensor:
    """SoftmaxOutput's ``batch``/``valid`` denominator over the labels of
    every mesh member (f32, as ``norm_denom`` counts one member's)."""
    f32 = dict(dtype=torch.float32, device=label.device)
    if p["normalization"] == "batch":
        return torch.full((), float(sync.host_sum(label.shape[0])), **f32)
    if p["use_ignore"]:
        valid = (label != p["ignore_label"]).to(torch.float32).sum()
        return torch.clamp_min(sync.allreduce(valid), 1.0)
    return torch.full((), max(float(sync.host_sum(label.numel())), 1.0),
                      **f32)


def _softmax_output_fwd(ctx, params, data, label):
    return _SoftmaxOutputFn.apply(data, label, params, ctx.sync)


def _softmax_output_shape(params, in_shapes):
    shapes = list(in_shapes) + [None] * (2 - len(in_shapes))
    d = shapes[0]
    if d is not None:
        if params["multi_output"] and len(d) > 2:
            shapes[1] = (d[0],) + tuple(d[2:])
        else:
            shapes[1] = (d[0],)
        out = shapes[1] if params.get("out_mode") == "loss" else tuple(d)
    else:
        out = None
    return shapes, [out], []


_SOFTMAX_OUT_PARAMS = {
    "grad_scale": OpParam("grad_scale", "float", default=1.0),
    "ignore_label": OpParam("ignore_label", "float", default=-1.0),
    "multi_output": OpParam("multi_output", "bool", default=False),
    "use_ignore": OpParam("use_ignore", "bool", default=False),
    "normalization": OpParam("normalization", "str", default="null",
                             enum=("null", "batch", "valid")),
    "out_dtype": OpParam("out_dtype", "str", default="", enum=("", "same")),
    "out_mode": OpParam("out_mode", "str", default="", enum=("", "loss")),
}

for _name in ("SoftmaxOutput", "Softmax"):  # "Softmax" is the old alias
    register_op(OpDef(
        name=_name,
        forward=_softmax_output_fwd,
        arguments=("data", "label"),
        params=dict(_SOFTMAX_OUT_PARAMS),
        infer_shape=_softmax_output_shape,
        is_loss=True,
        doc="Softmax forward (kernel K1) or per-position cross-entropy "
            "(out_mode='loss'); backward = (prob - onehot(label)) times "
            "the head cotangent.",
    ))


# ---------------------------------------------------------------------------
# The image-classification zoo's ops and the legacy heads.  Plain torch
# expressions of the JAX package's jnp/lax definitions; Deconvolution goes
# to cuDNN through F.conv_transpose2d.
# ---------------------------------------------------------------------------

def _num_args_list(prefix="arg"):
    return lambda params: [f"{prefix}{i}" for i in range(params["num_args"])]


# -- LeakyReLU ---------------------------------------------------------------

def _leaky_relu_fwd(ctx, params, *inputs):
    act = params["act_type"]
    x = inputs[0]
    if act == "leaky":
        return torch.where(x > 0, x, params["slope"] * x)
    if act == "elu":
        return torch.where(x > 0, x, params["slope"] * (torch.exp(x) - 1.0))
    if act == "prelu":
        gamma = inputs[1]
        g = (gamma.reshape((1, -1) + (1,) * (x.dim() - 2)) if x.dim() > 1
             else gamma)
        return torch.where(x > 0, x, g * x)
    if act == "rrelu":
        lo, hi = params["lower_bound"], params["upper_bound"]
        if ctx.is_train and ctx.rng is not None:
            slope = lo + (hi - lo) * torch.rand(
                x.shape, generator=ctx.rng, device=x.device, dtype=x.dtype)
        else:
            slope = (lo + hi) / 2.0
        return torch.where(x > 0, x, slope * x)
    raise MXNetError(f"unknown LeakyReLU act_type {act}")


def _leaky_relu_shape(params, in_shapes):
    if params["act_type"] != "prelu":
        return elemwise_shape(params, in_shapes)
    d, g = (list(in_shapes) + [None])[:2]
    if d is not None and g is None:
        g = (d[1],)
    return [d, g], [d], []


register_op(OpDef(
    name="LeakyReLU",
    forward=_leaky_relu_fwd,
    arguments=lambda p: (["data", "gamma"] if p["act_type"] == "prelu"
                         else ["data"]),
    params={
        "act_type": OpParam("act_type", "str", default="leaky",
                            enum=("leaky", "prelu", "rrelu", "elu")),
        "slope": OpParam("slope", "float", default=0.25),
        "lower_bound": OpParam("lower_bound", "float", default=0.125),
        "upper_bound": OpParam("upper_bound", "float", default=0.334),
    },
    infer_shape=_leaky_relu_shape,
    needs_rng=True,
    doc="Leaky/parametric/randomized/exponential rectified unit.",
))


# -- Deconvolution -----------------------------------------------------------

def _deconv_adj(params, in_hw):
    """Output-size adjustment: ``adj``, or what ``target_shape`` needs
    (which may be negative or reach the stride)."""
    ah, aw = _pair(params["adj"])
    tgt = params["target_shape"]
    if tgt and in_hw is not None:
        th, tw = _pair(tgt)
        kh, kw = _pair(params["kernel"])
        sh, sw = _pair(params["stride"])
        ph, pw = _pair(params["pad"])
        h, w = in_hw
        ah = th - (sh * (h - 1) + kh - 2 * ph)
        aw = tw - (sw * (w - 1) + kw - 2 * pw)
    return ah, aw


def _deconv_fwd(ctx, params, data, weight, bias=None):
    """The JAX package's input-dilated convolution equals the unpadded
    transposed convolution (cuDNN) read from ``pad`` on, with zero rows
    beyond its end: computed so, since ``output_padding`` rejects an
    adjustment that is negative or reaches the stride."""
    sh, sw = _pair(params["stride"])
    ph, pw = _pair(params["pad"])
    kh, kw = _pair(params["kernel"])
    h, w = data.shape[2], data.shape[3]
    ah, aw = _deconv_adj(params, (h, w))
    oh = sh * (h - 1) + kh - 2 * ph + ah
    ow = sw * (w - 1) + kw - 2 * pw + aw
    if data.dtype != weight.dtype:
        data = data.to(weight.dtype)
    # weight (C_in, F/g, kh, kw): torch's transposed-convolution layout
    full = F.conv_transpose2d(data, weight, stride=(sh, sw),
                              groups=params["num_group"])
    out = full[:, :, ph:ph + oh, pw:pw + ow]
    if out.shape[2] < oh or out.shape[3] < ow:
        out = F.pad(out, (0, ow - out.shape[3], 0, oh - out.shape[2]))
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out


def _deconv_shape(params, in_shapes):
    n_in = 2 if params["no_bias"] else 3
    shapes = list(in_shapes) + [None] * (n_in - len(in_shapes))
    d = shapes[0]
    kh, kw = _pair(params["kernel"])
    sh, sw = _pair(params["stride"])
    ph, pw = _pair(params["pad"])
    f = params["num_filter"]
    g = params["num_group"]
    if d is not None:
        n, c, h, w = d
        ah, aw = _deconv_adj(params, (h, w))
        shapes[1] = (c, f // g, kh, kw)
        out = (n, f, sh * (h - 1) + kh - 2 * ph + ah,
               sw * (w - 1) + kw - 2 * pw + aw)
    else:
        out = None
    if not params["no_bias"]:
        shapes[2] = (f,)
    return shapes, [out], []


register_op(OpDef(
    name="Deconvolution",
    forward=_deconv_fwd,
    arguments=lambda p: (["data", "weight"] if p["no_bias"]
                         else ["data", "weight", "bias"]),
    params={
        "kernel": OpParam("kernel", "shape", required=True),
        "stride": OpParam("stride", "shape", default=(1, 1)),
        "pad": OpParam("pad", "shape", default=(0, 0)),
        "adj": OpParam("adj", "shape", default=(0, 0)),
        "target_shape": OpParam("target_shape", "shape", default=()),
        "num_filter": OpParam("num_filter", "int", required=True),
        "num_group": OpParam("num_group", "int", default=1),
        # the reference's DeconvolutionParam defaults no_bias to true
        "no_bias": OpParam("no_bias", "bool", default=True),
        "workspace": OpParam("workspace", "int", default=512),
    },
    infer_shape=_deconv_shape,
    doc="2D transposed convolution (cuDNN), cropped to pad/adj/target.",
))


# -- Dropout -----------------------------------------------------------------

def dropout_mask(x, keep: float, generator):
    """The kept positions: ``uniform[0, 1) < keep`` of ``x``'s shape, drawn
    from ``generator`` on ``x``'s device."""
    return torch.rand(x.shape, generator=generator, device=x.device) < keep


def _dropout_fwd(ctx, params, x):
    p = params["p"]
    if not ctx.is_train or p <= 0.0 or ctx.rng is None:
        return x
    keep = 1.0 - p
    mask = dropout_mask(x, keep, ctx.rng)
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


register_op(OpDef(
    name="Dropout",
    forward=_dropout_fwd,
    arguments=("data",),
    params={"p": OpParam("p", "float", default=0.5)},
    infer_shape=elemwise_shape,
    needs_rng=True,
    doc="Inverted dropout; identity at inference.",
))


# -- Concat, SliceChannel, SwapAxis, Cast, ElementWiseSum, BlockGrad, Crop ---

def _concat_shape(params, in_shapes):
    dim = params["dim"]
    if not in_shapes or any(s is None for s in in_shapes):
        return in_shapes, [None], []
    base = list(in_shapes[0])
    base[dim] = sum(s[dim] for s in in_shapes)
    return [tuple(s) for s in in_shapes], [tuple(base)], []


register_op(OpDef(
    name="Concat",
    forward=lambda ctx, params, *xs: torch.cat(xs, dim=params["dim"]),
    arguments=_num_args_list(),
    params={
        "num_args": OpParam("num_args", "int", required=True),
        "dim": OpParam("dim", "int", default=1),
    },
    infer_shape=_concat_shape,
    doc="Concatenate along an axis.",
))


def _slice_channel_fwd(ctx, params, x):
    n = params["num_outputs"]
    ax = params["axis"] % x.dim()
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if params["squeeze_axis"]:
        parts = [q.squeeze(ax) for q in parts]
    return tuple(parts)


def _slice_channel_shape(params, in_shapes):
    (d,) = in_shapes
    n = params["num_outputs"]
    if d is None:
        return in_shapes, [None] * n, []
    ax = params["axis"] % len(d)
    if d[ax] % n:
        raise MXNetError(f"SliceChannel: axis {ax} size {d[ax]} not "
                         f"divisible by {n}")
    out = list(d)
    out[ax] = d[ax] // n
    if params["squeeze_axis"]:
        if out[ax] != 1:
            raise MXNetError("SliceChannel: squeeze_axis requires size-1 "
                             "result axis")
        out = out[:ax] + out[ax + 1:]
    return [tuple(d)], [tuple(out)] * n, []


register_op(OpDef(
    name="SliceChannel",
    forward=_slice_channel_fwd,
    arguments=("data",),
    outputs=lambda p: [f"output{i}" for i in range(p["num_outputs"])],
    params={
        "num_outputs": OpParam("num_outputs", "int", required=True),
        "axis": OpParam("axis", "int", default=1),
        "squeeze_axis": OpParam("squeeze_axis", "bool", default=False),
    },
    infer_shape=_slice_channel_shape,
    doc="Split along an axis into equal parts (inverse of Concat).",
))


def _swapaxis_shape(params, in_shapes):
    (d,) = in_shapes
    if d is None:
        return in_shapes, [None], []
    a, b = params["dim1"], params["dim2"]
    out = list(d)
    out[a], out[b] = out[b], out[a]
    return [tuple(d)], [tuple(out)], []


register_op(OpDef(
    name="SwapAxis",
    forward=lambda ctx, params, x: x.transpose(params["dim1"],
                                               params["dim2"]),
    arguments=("data",),
    params={
        "dim1": OpParam("dim1", "int", default=0),
        "dim2": OpParam("dim2", "int", default=0),
    },
    infer_shape=_swapaxis_shape,
    doc="Swap two axes.",
))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name (``"float32"``, ``"uint8"``,
    ``"float"``, ...) or of ``"bfloat16"``."""
    if name == "bfloat16":
        return torch.bfloat16
    canon = np.dtype(name).name
    return torch.bool if canon == "bool" else getattr(torch, canon)


register_op(OpDef(
    name="Cast",
    forward=lambda ctx, params, x: x.to(torch_dtype(params["dtype"])),
    arguments=("data",),
    params={"dtype": OpParam("dtype", "str", required=True)},
    infer_shape=elemwise_shape,
    infer_type=lambda params, in_types: (
        in_types, [np.dtype(params["dtype"])], []),
    doc="Elementwise dtype cast.",
))

register_op(OpDef(
    name="ElementWiseSum",
    forward=lambda ctx, params, *xs: sum(xs[1:], xs[0]),
    arguments=_num_args_list(),
    params={"num_args": OpParam("num_args", "int", required=True)},
    infer_shape=elemwise_shape,
    func_name="_element_wise_sum",
    doc="Sum of N arrays.",
))

register_op(OpDef(
    name="BlockGrad",
    forward=lambda ctx, params, x: x.detach(),
    arguments=("data",),
    infer_shape=elemwise_shape,
    doc="Identity forward, zero backward.",
))


def _crop_hw(params, like_shape):
    if params["num_args"] == 2:
        return like_shape[2], like_shape[3]
    return _pair(params["h_w"])


def _crop_fwd(ctx, params, *inputs):
    x = inputs[0]
    th, tw = _crop_hw(params, inputs[-1].shape)
    if params["center_crop"]:
        oy = (x.shape[2] - th) // 2
        ox = (x.shape[3] - tw) // 2
    else:
        oy, ox = _pair(params["offset"])
    if oy < 0 or ox < 0 or oy + th > x.shape[2] or ox + tw > x.shape[3]:
        raise MXNetError(f"Crop: window ({oy}, {ox}) + ({th}, {tw}) "
                         f"outside {tuple(x.shape)}")
    return x[:, :, oy:oy + th, ox:ox + tw]


def _crop_shape(params, in_shapes):
    d = in_shapes[0]
    if d is None or (params["num_args"] == 2 and in_shapes[1] is None):
        return in_shapes, [None], []
    th, tw = _crop_hw(params, in_shapes[-1])
    return ([tuple(s) if s else s for s in in_shapes],
            [(d[0], d[1], th, tw)], [])


register_op(OpDef(
    name="Crop",
    forward=_crop_fwd,
    arguments=lambda p: (["data", "crop_like"] if p["num_args"] == 2
                         else ["data"]),
    params={
        "num_args": OpParam("num_args", "int", default=1),
        "offset": OpParam("offset", "shape", default=(0, 0)),
        "h_w": OpParam("h_w", "shape", default=(0, 0)),
        "center_crop": OpParam("center_crop", "bool", default=False),
    },
    infer_shape=_crop_shape,
    doc="Spatial crop to a target size or to a like-array's.",
))


# -- L2Normalization, LRN ----------------------------------------------------

def _l2norm_fwd(ctx, params, x):
    mode = params["mode"]
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    else:  # spatial
        axes = tuple(range(2, x.dim()))
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                      + params["eps"])
    return x / norm


register_op(OpDef(
    name="L2Normalization",
    forward=_l2norm_fwd,
    arguments=("data",),
    params={
        "eps": OpParam("eps", "float", default=1e-10),
        "mode": OpParam("mode", "str", default="instance",
                        enum=("instance", "channel", "spatial")),
    },
    infer_shape=elemwise_shape,
    doc="x / ||x||_2 over instance/channel/spatial axes.",
))


def _lrn_fwd(ctx, params, x):
    """The JAX package's expression, written out: the squares padded by
    ``nsize // 2`` channels on both sides, summed over ``nsize``
    channel-shifted slices (for an even ``nsize`` the window is
    ``[c - n/2, c + n/2 - 1]``, the one ``F.local_response_norm`` takes
    too; that function divides by n before scaling, so its last bits
    differ)."""
    n = params["nsize"]
    alpha, beta, k = params["alpha"], params["beta"], params["knorm"]
    half = n // 2
    padded = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    window = sum(padded[:, i:i + c] for i in range(n))
    return x * torch.pow(k + (alpha / n) * window, -beta)


register_op(OpDef(
    name="LRN",
    forward=_lrn_fwd,
    arguments=("data",),
    params={
        "alpha": OpParam("alpha", "float", default=1e-4),
        "beta": OpParam("beta", "float", default=0.75),
        "knorm": OpParam("knorm", "float", default=2.0),
        "nsize": OpParam("nsize", "int", required=True),
    },
    infer_shape=elemwise_shape,
    doc="Cross-channel local response normalization.",
))


# -- SoftmaxActivation -------------------------------------------------------

register_op(OpDef(
    name="SoftmaxActivation",
    # the JAX package uses jax.nn.softmax here, not kernel K1
    forward=lambda ctx, params, x: torch.softmax(
        x, dim=1 if (params["mode"] == "channel" and x.dim() > 2) else -1),
    arguments=("data",),
    params={"mode": OpParam("mode", "str", default="instance",
                            enum=("instance", "channel"))},
    infer_shape=elemwise_shape,
    doc="Softmax with its autograd backward.",
))


# -- Regression heads, MakeLoss, IdentityAttachKLSparseReg -------------------

class _RegressionFn(torch.autograd.Function):
    """Forward ``transform(data)``; backward ``grad_fn(out, label) *
    grad_scale / n`` times the head cotangent (n: the label's elements
    per sample), recomputing ``transform`` as the JAX rule does; the
    label gets a zero gradient.  ``data`` arrives in f32 (``_amp_f32``)."""

    @staticmethod
    def forward(ctx, data, label, transform, grad_fn, grad_scale):
        ctx.save_for_backward(data, label)
        ctx.rule = (transform, grad_fn, grad_scale)
        return transform(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        transform, grad_fn, grad_scale = ctx.rule
        out = transform(data)
        n = max(1, int(np.prod(label.shape[1:])) if label.dim() > 1 else 1)
        grad = grad_fn(out, label.reshape(out.shape)) * (grad_scale / n)
        grad = grad * g.to(grad.dtype)
        return grad, torch.zeros_like(label), None, None, None


def _regression_head(transform, grad_fn):
    def fwd(ctx, params, data, label):
        return _RegressionFn.apply(_amp_f32(data), label, transform, grad_fn,
                                   params["grad_scale"])
    return fwd


def _regression_shape(params, in_shapes):
    shapes = list(in_shapes) + [None] * (2 - len(in_shapes))
    d = shapes[0]
    if d is None:
        return shapes, [None], []
    shapes[1] = tuple(d)
    return shapes, [tuple(d)], []


for _name, _transform, _grad, _doc in (
        ("LinearRegressionOutput", lambda x: x, lambda o, l: o - l,
         "Identity forward; grad = out - label."),
        ("LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l,
         "Sigmoid forward; grad = sigmoid(out) - label."),
        ("MAERegressionOutput", lambda x: x,
         lambda o, l: torch.sign(o - l),
         "Identity forward; grad = sign(out - label).")):
    register_op(OpDef(
        name=_name,
        forward=_regression_head(_transform, _grad),
        arguments=("data", "label"),
        params={"grad_scale": OpParam("grad_scale", "float", default=1.0)},
        infer_shape=_regression_shape,
        is_loss=True,
        doc=_doc,
    ))


class _ScaledIdentityFn(torch.autograd.Function):
    """Identity forward; backward ``cotangent * grad_scale`` (the scale in
    the cotangent's type) plus ``extra`` (a tensor broadcast to it, or
    None)."""

    @staticmethod
    def forward(ctx, x, grad_scale, extra):
        ctx.grad_scale = grad_scale
        ctx.extra = extra
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_scale is not None:
            g = g * torch.full((), ctx.grad_scale, dtype=g.dtype,
                               device=g.device)
        if ctx.extra is not None:
            g = g + ctx.extra.expand_as(g)
        return g, None, None


register_op(OpDef(
    name="MakeLoss",
    forward=lambda ctx, params, x: _ScaledIdentityFn.apply(
        x, params["grad_scale"], None),
    arguments=("data",),
    params={"grad_scale": OpParam("grad_scale", "float", default=1.0)},
    infer_shape=elemwise_shape,
    is_loss=True,
    doc="Treat any symbol as a loss: backward is grad_scale everywhere.",
))


def _kl_sparse_fwd(ctx, params, x):
    """Identity whose backward adds the KL sparseness penalty's gradient
    at the moving average of the batch means (``x`` is expected to be a
    sigmoid's output, as in the reference)."""
    target = params["sparseness_target"]
    momentum = params["momentum"]
    if ctx.sync is None:
        batch_mean = torch.mean(x, dim=0).detach()
    else:
        # the batch is split over mesh members: the mean over every
        # member's rows, as BatchNorm's moments
        count = float(ctx.sync.host_sum(x.shape[0]))
        batch_mean = ctx.sync.allreduce(
            torch.sum(x.detach(), dim=0)) / count
    if "avg" in ctx.aux:
        avg = momentum * ctx.aux["avg"] + (1 - momentum) * batch_mean
        ctx.aux_updates["avg"] = avg
    else:
        avg = batch_mean
    rho_hat = torch.clamp(avg, 1e-6, 1.0 - 1e-6)
    kl_grad = params["penalty"] * (-target / rho_hat
                                   + (1.0 - target) / (1.0 - rho_hat))
    return _ScaledIdentityFn.apply(x, None, kl_grad)


register_op(OpDef(
    name="IdentityAttachKLSparseReg",
    forward=_kl_sparse_fwd,
    arguments=("data",),
    aux_states=("avg",),
    params={
        "sparseness_target": OpParam("sparseness_target", "float",
                                     default=0.1),
        "penalty": OpParam("penalty", "float", default=0.001),
        "momentum": OpParam("momentum", "float", default=0.9),
    },
    infer_shape=lambda params, in_shapes: (
        in_shapes, [in_shapes[0]],
        [None if in_shapes[0] is None else (in_shapes[0][1],)]),
    doc="Identity with KL sparseness penalty added to the gradient.",
))


# -- ROIPooling (src/operator/roi_pooling-inl.h) ------------------------------

# The bins' masked windows [rois, C, ph, pw, H, W] are made at most this
# many elements at a time (512 MiB of f32): a Fast R-CNN head, 256 rois x
# 512 channels x 7x7 bins over a 38x63 map, would need 62 GB in one pass
ROI_POOL_CHUNK_ELEMS = 1 << 27

def _roi_pool_fwd(ctx, params, data, rois):
    ph, pw = _pair(params["pooled_size"])
    scale = params["spatial_scale"]
    n, c, h, w = data.shape
    dev = data.device
    rois = rois.detach()
    bi = rois[:, 0].to(torch.int64)
    # an index past either end is taken as JAX's gather takes it
    bi = torch.clamp(torch.where(bi < 0, bi + n, bi), 0, n - 1)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale).to(torch.int64)
                      for i in range(1, 5))
    rh = torch.clamp_min(y2 - y1 + 1, 1)
    rw = torch.clamp_min(x2 - x1 + 1, 1)
    iy = torch.arange(ph, device=dev)
    ix = torch.arange(pw, device=dev)
    hstart = y1[:, None] + torch.div(iy * rh[:, None], ph,
                                     rounding_mode="floor")
    hend = y1[:, None] + torch.div((iy + 1) * rh[:, None] + ph - 1, ph,
                                   rounding_mode="floor")
    wstart = x1[:, None] + torch.div(ix * rw[:, None], pw,
                                     rounding_mode="floor")
    wend = x1[:, None] + torch.div((ix + 1) * rw[:, None] + pw - 1, pw,
                                   rounding_mode="floor")
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    ymask = (ys >= hstart[..., None]) & (ys < hend[..., None])   # [R,ph,H]
    xmask = (xs >= wstart[..., None]) & (xs < wend[..., None])   # [R,pw,W]
    img = data.index_select(0, bi)                               # [R,C,H,W]
    step = max(1, ROI_POOL_CHUNK_ELEMS // max(1, c * ph * pw * h * w))
    if rois.shape[0] <= step:
        val = _roi_bins_max(img, ymask, xmask)
    else:
        # a chunk of rois at a time; under autograd each chunk keeps only
        # its inputs and remakes its windows in the backward.  Rows are
        # independent and the split's backward concatenates, so values
        # and gradients are the bits of the one-pass form
        keep = torch.is_grad_enabled() and img.requires_grad
        val = torch.cat([
            checkpoint(_roi_bins_max, *chunk, use_reentrant=False,
                       preserve_rng_state=False)
            if keep else _roi_bins_max(*chunk)
            for chunk in zip(img.split(step), ymask.split(step),
                             xmask.split(step))])
    return torch.where(torch.isfinite(val), val, torch.zeros_like(val))


def _roi_bins_max(img, ymask, xmask):
    """``[R, C, ph, pw]``: the max of ``img [R, C, H, W]`` over each bin's
    window, its rows ``ymask [R, ph, H]`` by its columns ``xmask [R, pw,
    W]``; -inf for an empty bin."""
    mask = ymask[:, :, None, :, None] & xmask[:, None, :, None, :]
    masked = torch.where(mask[:, None], img[:, :, None, None],
                         torch.full((), -torch.inf, dtype=img.dtype,
                                    device=img.device))
    return torch.amax(masked, dim=(-2, -1))


def _roi_pool_shape(params, in_shapes):
    d, r = in_shapes
    ph, pw = _pair(params["pooled_size"])
    if d is None or r is None:
        return in_shapes, [None], []
    return [tuple(d), tuple(r)], [(r[0], d[1], ph, pw)], []


register_op(OpDef(
    name="ROIPooling",
    forward=_roi_pool_fwd,
    arguments=("data", "rois"),
    params={
        "pooled_size": OpParam("pooled_size", "shape", required=True),
        "spatial_scale": OpParam("spatial_scale", "float", required=True),
    },
    infer_shape=_roi_pool_shape,
    doc="Max-pool regions of interest to a fixed spatial size.",
))


# -- UpSampling --------------------------------------------------------------

def _upsample_fwd(ctx, params, *inputs):
    scale = params["scale"]
    if params["sample_type"] == "nearest":
        target_h = inputs[0].shape[2] * scale
        target_w = inputs[0].shape[3] * scale
        outs = [x.repeat_interleave(target_h // x.shape[2], dim=2)
                 .repeat_interleave(target_w // x.shape[3], dim=3)
                for x in inputs]
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    x = inputs[0]
    n, c, h, w = x.shape
    if len(inputs) < 2:
        # no weight bound: a plain bilinear resize with half-pixel
        # centres, as jax.image.resize computes it (at the borders its
        # renormalised triangle kernel equals the clamped coordinate)
        return F.interpolate(x, size=(h * scale, w * scale),
                             mode="bilinear", align_corners=False)
    # the bound (C, 1, k, k) weight as a depthwise transposed convolution
    # (k = 2s - s % 2, stride s, pad ceil((s - 1) / 2))
    p = -(-(scale - 1) // 2)
    return F.conv_transpose2d(x, inputs[1].to(x.dtype), stride=scale,
                              padding=p, groups=c)


def _upsample_args(p):
    if p["sample_type"] == "bilinear":
        return ["data", "weight"] if p["num_args"] > 1 else ["data"]
    return [f"arg{i}" for i in range(p["num_args"])]


def _upsample_shape(params, in_shapes):
    d = in_shapes[0]
    scale = params["scale"]
    if d is None:
        return in_shapes, [None], []
    if params["sample_type"] == "nearest":
        if any(s is None for s in in_shapes):
            return in_shapes, [None], []
        c = sum(s[1] for s in in_shapes)
        out = (d[0], c, d[2] * scale, d[3] * scale)
        return [tuple(s) for s in in_shapes], [out], []
    out = (d[0], d[1], d[2] * scale, d[3] * scale)
    shapes = [tuple(d)]
    if len(in_shapes) > 1:
        k = 2 * scale - scale % 2
        shapes.append((d[1], 1, k, k))
    return shapes, [out], []


register_op(OpDef(
    name="UpSampling",
    forward=_upsample_fwd,
    arguments=_upsample_args,
    params={
        "scale": OpParam("scale", "int", required=True),
        "num_filter": OpParam("num_filter", "int", default=0),
        "sample_type": OpParam("sample_type", "str", default="nearest",
                               enum=("nearest", "bilinear")),
        "num_args": OpParam("num_args", "int", default=1),
        "workspace": OpParam("workspace", "int", default=512),
    },
    infer_shape=_upsample_shape,
    doc="Nearest/bilinear spatial upsampling; multi-input concat on "
        "channels.",
))
