"""Restructured conv backward paths, chosen per static shape.

Counterpart of ``mxnet_tpu/ops/conv_backward.py``.  :func:`conv2d` is the
NCHW/OIHW convolution of the ``Convolution`` op.  Its backward is picked
per shape by :func:`_policy`, under ``MXNET_TPU_CONV_BWD``:

* ``xla`` (the default, the JAX package's name kept): the backend's own
  transpose, here cuDNN's.  :func:`conv2d` is plain ``F.conv2d`` and
  autograd records ``aten.convolution_backward``.
* ``tuned``: a ``torch.autograd.Function`` whose backward is
  :func:`_conv2d_bwd`, running the JAX package's three restructurings
  where the policy picks them:

  - ``dgrad_mm``: the 1x1 stride-1 input gradient as one product over
    the output channels (``torch.matmul``);
  - ``wgrad_mm``: the 1x1 stride-1 weight gradient as one product over
    N*H*W;
  - ``phase_dgrad``: the stride-s input gradient as s*s stride-1
    convolutions over the kernel taps' parity classes, interleaved back
    (no zeros inserted between the output gradient's rows).

  The other side of each pair, and every shape the policy leaves to the
  backend, takes ``aten.convolution_backward`` with one output mask, so
  no transpose is built for a side that was replaced.

Grouped or dilated convolutions, asymmetric kernels, strides or pads,
and a padded 1x1 fall through to the backend, as in the JAX package.
The policy is read when the forward runs, so a captured program keeps
the policy it was captured under (the JAX package fixes it at trace
time).  Under ``tuned`` a shape for which the policy picks the backend on
both sides, and a forward that records no gradient, run plain
``F.conv2d``: the backward would be the same.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

__all__ = ["conv2d"]


# ---------------------------------------------------------------------------
# variant implementations
# ---------------------------------------------------------------------------

def _plain_conv(x, w, stride, pad):
    return F.conv2d(x, w, stride=tuple(stride), padding=tuple(pad))


def _backend_grads(dy, x, w, stride, pad, mask):
    """cuDNN's (or ATen's, on the CPU) transpose of :func:`_plain_conv`,
    only for the sides ``mask = (dx, dw)`` asks for."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy, x, w, None, list(stride), list(pad), [1, 1], False, [0, 0], 1,
        [mask[0], mask[1], False])
    return dx, dw


def _dgrad_mm(dy, w, x_shape):
    """1x1 stride-1: dx[n,c,h,w] = sum_o dy[n,o,h,w] * w[o,c]."""
    n, cout, hh, ww = dy.shape
    w2 = w.reshape(cout, w.shape[1])
    out = torch.matmul(w2.t(), dy.reshape(n, cout, hh * ww))  # [n, c, hw]
    return out.reshape(x_shape).to(dy.dtype)


def _wgrad_mm(x, dy, w_shape):
    """1x1 stride-1: dw[o,c] = sum_{n,h,w} dy[n,o,h,w] * x[n,c,h,w]."""
    n, cin = x.shape[0], x.shape[1]
    cout = dy.shape[1]
    dym = dy.transpose(0, 1).reshape(cout, -1)             # [o, n*hw]
    xm = x.transpose(0, 1).reshape(cin, -1)                # [c, n*hw]
    return torch.matmul(dym, xm.t()).reshape(w_shape).to(dy.dtype)


def _phase_dgrad(dy, w, x_shape, k, s, p):
    """dx for a stride-s conv via s*s phase convolutions (no zero
    insertion): group kernel taps by (u % s, t % s); each parity class
    contributes one output phase as a STRIDE-1 conv of dy with the
    flipped tap subset; phases interleave back into dx."""
    n, c, hh, ww_ = x_shape
    phases = []
    for a in range(s):
        row = []
        for b in range(s):
            u0 = (a + p) % s
            v0 = (b + p) % s
            wk = w[:, :, u0::s, v0::s]                   # (O, C, ku, kv)
            ku, kv = wk.shape[2], wk.shape[3]
            if ku == 0 or kv == 0:
                row.append(None)                         # phase gets no taps
                continue
            wk = torch.flip(wk, (2, 3)).transpose(0, 1)
            off = (a + p - u0) // s
            lo = off - (ku - 1)
            h_out = (hh - 1 - a) // s + 1
            w_out = (ww_ - 1 - b) // s + 1
            offb = (b + p - v0) // s
            lob = offb - (kv - 1)
            dyh, dyw = dy.shape[2], dy.shape[3]
            pad_lo = -lo if lo < 0 else 0
            crop_lo = lo if lo > 0 else 0
            pad_hi = max(0, (h_out - 1) + off - (dyh - 1))
            pad_lob = -lob if lob < 0 else 0
            crop_lob = lob if lob > 0 else 0
            pad_hib = max(0, (w_out - 1) + offb - (dyw - 1))
            ph = F.conv2d(F.pad(dy, (pad_lob, pad_hib, pad_lo, pad_hi)), wk)
            ph = ph[:, :, crop_lo:crop_lo + h_out, crop_lob:crop_lob + w_out]
            row.append(ph)
        phases.append(row)
    h_max = max(ph.shape[2] for row in phases for ph in row if ph is not None)
    w_max = max(ph.shape[3] for row in phases for ph in row if ph is not None)
    stacked = dy.new_zeros((n, c, h_max, s, w_max, s))
    for a in range(s):
        for b in range(s):
            ph = phases[a][b]
            if ph is None:
                continue
            stacked[:, :, :ph.shape[2], a, :ph.shape[3], b] = ph
    return stacked.reshape(n, c, h_max * s, w_max * s)[:, :, :hh, :ww_]


# ---------------------------------------------------------------------------
# per-shape dispatch policy (the JAX package's, unchanged)
# ---------------------------------------------------------------------------

def _use_dgrad_mm(k, s, p, cin, cout, hw):
    # the matmul form assumes output spatial == input spatial
    return k == 1 and s == 1 and p == 0


def _use_wgrad_mm(k, s, p, cin, cout, hw):
    return k == 1 and s == 1 and p == 0


def _use_phase_dgrad(k, s, p, cin, cout, hw):
    return s > 1


def _policy(x_shape, w_shape, stride, pad):
    """Returns (dgrad_kind, wgrad_kind) for this static shape."""
    if os.environ.get("MXNET_TPU_CONV_BWD", "xla") != "tuned":
        return "xla", "xla"
    n, cin, hh, _ = x_shape
    cout, _, kh, kw = w_shape
    s, p = stride[0], pad[0]
    # the tuned variants assume square kernel/stride and SYMMETRIC pad
    # (the phase decomposition applies p to both spatial dims)
    if kh != kw or stride[0] != stride[1] or pad[0] != pad[1]:
        return "xla", "xla"
    dgrad = "xla"
    if _use_dgrad_mm(kh, s, p, cin, cout, hh):
        dgrad = "mm"
    elif _use_phase_dgrad(kh, s, p, cin, cout, hh):
        dgrad = "phase"
    wgrad = "mm" if _use_wgrad_mm(kh, s, p, cin, cout, hh) else "xla"
    return dgrad, wgrad


# ---------------------------------------------------------------------------
# the tuned backward
# ---------------------------------------------------------------------------

def _conv2d_bwd(stride, pad, res, dy, kinds=None, need=(True, True)):
    """``(dx, dw)`` of :func:`_plain_conv` at ``res = (x, w)``, each side
    by the kind ``kinds`` names (default: :func:`_policy`'s now); a side
    that ``need`` leaves out is ``None``."""
    x, w = res
    dgrad_kind, wgrad_kind = kinds or _policy(x.shape, w.shape, stride, pad)
    kh = w.shape[2]
    s, p = stride[0], pad[0]
    dx = dw = None
    if need[0] and dgrad_kind == "mm":
        dx = _dgrad_mm(dy, w, x.shape)
    elif need[0] and dgrad_kind == "phase":
        dx = _phase_dgrad(dy, w, x.shape, kh, s, p)
    if need[1] and wgrad_kind == "mm":
        dw = _wgrad_mm(x, dy, w.shape)
    mask = (need[0] and dx is None, need[1] and dw is None)
    if any(mask):
        bx, bw = _backend_grads(dy, x, w, stride, pad, mask)
        dx = bx if mask[0] else dx
        dw = bw if mask[1] else dw
    return dx, dw


class _TunedConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, pad, kinds):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad, kinds)
        return _plain_conv(x, w, stride, pad)

    @staticmethod
    def backward(ctx, dy):
        stride, pad, kinds = ctx.conf
        dx, dw = _conv2d_bwd(stride, pad, ctx.saved_tensors,
                             dy.contiguous(), kinds,
                             tuple(ctx.needs_input_grad[:2]))
        return dx, dw, None, None, None


def conv2d(x, w, *, stride, pad, dilate=(1, 1), groups=1):
    """NCHW/OIHW conv with per-shape tuned backward (see module doc).

    Falls through to plain ``F.conv2d`` (cuDNN's backward) for grouped or
    dilated convs and for every shape the policy leaves to the backend.
    """
    stride, pad = tuple(stride), tuple(pad)
    if groups == 1 and tuple(dilate) == (1, 1) and torch.is_grad_enabled() \
            and (x.requires_grad or w.requires_grad):
        kinds = _policy(x.shape, w.shape, stride, pad)
        if kinds != ("xla", "xla"):
            return _TunedConv2d.apply(x, w, stride, pad, kinds)
    return F.conv2d(x, w, stride=stride, padding=pad,
                    dilation=tuple(dilate), groups=groups)
