"""Neural-network operators of the ResNet and transformer-LM training paths.

Counterpart of ``mxnet_tpu/ops/nn_ops.py`` for the ops that
``models.resnet``/``resnet_cifar`` and ``models.transformer_lm`` reach:
Activation, FullyConnected, Convolution, Pooling, BatchNorm, Flatten,
Reshape, Embedding, LayerNorm and SoftmaxOutput (with its deprecated
alias Softmax), the latter also in its loss mode.  The other ops of that
module come with later slices (ROADMAP.md).

Layouts stay NCHW/OIHW as in the JAX package.  Convolutions go to cuDNN
through ``F.conv2d`` and matrix products to cuBLAS through ``matmul``, as
the JAX package leaves them to XLA.  Where torch's own ops would
compute something else than the reference, the reference's expression is
written out:

* Pooling uses the reference's ceil convention (``_pool_out_dim``): the
  input is padded explicitly (-inf for max, 0 for avg/sum) out to the
  last window, and avg divides by the full ``kh * kw``, padding included.
* BatchNorm's training statistics are single-pass ``E[x^2] - E[x]^2``
  clamped at 0; the moving averages take the biased variance.  Autograd
  differentiates the same expression, as JAX's does.

The ``SoftmaxOutput`` forward runs the row softmax through kernel K1
(:func:`softmax_rows`, ``csrc/softmax_rows.cu``) on CUDA tensors and its
plain version :func:`softmax_rows_ref` on CPU tensors; the wrapper counts
its launches in ``softmax_rows.launches``.  With ``out_mode="loss"`` the
forward emits the per-position cross-entropy instead, from an f32
logsumexp, gathering the label's logit before the f32 cast, as the JAX
package does; it launches no kernel.  The backward reproduces the JAX
``_bwd`` rule (``(prob - onehot) * scale`` times the head cotangent,
broadcast over the classes when it is label-shaped), recomputing the
softmax with ``torch.softmax`` exactly where the JAX package recomputes
it with ``jax.nn.softmax``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..base import MXNetError, not_ported
from .registry import OpDef, OpParam, elemwise_shape, register_op

__all__ = ["softmax_rows", "softmax_rows_ref", "layer_norm",
           "SOFTMAX_MAX_COLS"]

SOFTMAX_MAX_COLS = 16384
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    if params["quant"]:
        raise not_ported("FullyConnected(quant='fp8')")
    x = data.reshape(data.shape[0], -1)
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
    out = F.conv2d(data, weight, stride=_pair(params["stride"]),
                   padding=_pair(params["pad"]),
                   dilation=_pair(params["dilate"]),
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
        mean = x32.mean(dim=axes)
        var = torch.clamp_min(
            torch.square(x32).mean(dim=axes) - torch.square(mean), 0.0)
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


register_op(OpDef(
    name="Embedding",
    # ids arrive as float32, as every batch input does, and truncate to
    # integers as the reference's astype(int32) does
    forward=lambda ctx, params, data, weight: weight[data.long()],
    arguments=("data", "weight"),
    params={
        "input_dim": OpParam("input_dim", "int", required=True),
        "output_dim": OpParam("output_dim", "int", required=True),
    },
    infer_shape=_embedding_shape,
    doc="Index into an embedding table; grad is a scatter-add.",
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
        lib.mxt_softmax_rows.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.mxt_softmax_rows.restype = ci
        lib.mxt_error_string.argtypes = [ci]
        lib.mxt_error_string.restype = ctypes.c_char_p
        lib._mxt_typed = True
    return lib


def softmax_rows(x):
    """Row softmax of a 2-D float32/bfloat16 ``x`` with at most
    :data:`SOFTMAX_MAX_COLS` columns; the result has ``x.dtype``.

    CPU tensors go to :func:`softmax_rows_ref`.  CUDA tensors launch the
    kernel of ``csrc/softmax_rows.cu`` (and count the launch) or raise.
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
    if x.device.type == "cpu":
        return softmax_rows_ref(x)
    if x.device.type != "cuda":
        raise MXNetError(f"softmax_rows: unsupported device {x.device}")
    if not x.is_contiguous():
        raise MXNetError("softmax_rows: x must be contiguous")
    lib = _lib()
    out = torch.empty_like(x)
    n, c = x.shape
    with torch.cuda.device(x.device):
        rc = lib.mxt_softmax_rows(
            x.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype], n, c,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise MXNetError(f"softmax_rows kernel launch failed: CUDA error "
                         f"{rc} ({lib.mxt_error_string(rc).decode()})")
    softmax_rows.launches += 1
    return out


softmax_rows.launches = 0


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
    def forward(ctx, data, label, p):
        ctx.save_for_backward(data, label)
        ctx.p = p
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
            # counted in f32, as the reference does
            if p["normalization"] == "batch":
                return torch.tensor(float(label.shape[0]),
                                    dtype=torch.float32, device=x.device)
            if p["normalization"] == "valid":
                if p["use_ignore"]:
                    return torch.clamp_min(mask.float().sum(), 1.0)
                return torch.tensor(max(float(label.numel()), 1.0),
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
            scale = torch.tensor(p["grad_scale"], dtype=x.dtype,
                                 device=x.device)
            if denom is not None:
                scale = scale / denom.to(x.dtype)
            if denom is not None or p["grad_scale"] != 1.0:
                g = g * scale
            grad = g * cot
        return grad.to(in_dtype), None, None


def _softmax_output_fwd(ctx, params, data, label):
    return _SoftmaxOutputFn.apply(data, label, params)


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
        doc="Softmax forward (kernel K1) or per-position cross-entropy "
            "(out_mode='loss'); backward = (prob - onehot(label)) times "
            "the head cotangent.",
    ))
