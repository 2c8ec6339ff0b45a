"""CTC loss and the ``WarpCTC`` loss head (reference WarpCTC plugin parity).

Counterpart of ``mxnet_tpu/ops/ctc.py``.  The reference binds Baidu's
warp-ctc as a loss op (``plugin/warpctc/warpctc-inl.h``): ``data`` is
``[(T*B), C]`` pre-softmax activations (time-major flattened), ``label``
is ``[B*L]`` flattened labels with blank 0, the forward emits
``softmax(data)`` and the backward writes the CTC gradient.

:func:`ctc_loss` is the JAX package's log-space alpha recursion over the
extended label sequence ``[blank, l1, blank, ..., lL, blank]``, written
out step by step over time in the same arithmetic (``-1e30`` for log 0),
so an impossible label gives a large finite loss, not ``inf``.  The
gradient comes from autograd through the recursion.  ``F.ctc_loss`` is
not used: it returns ``inf`` there, and its CUDA backward raises under
``torch.use_deterministic_algorithms(True)``.  Label lengths are the
count of non-blank labels (zero padding marks the end).
"""
from __future__ import annotations

import torch

from .registry import OpDef, OpParam, register_op

__all__ = ["ctc_loss"]

_NEG = -1e30


def ctc_loss(logits, labels, blank: int = 0):
    """Per-sample CTC negative log likelihood.

    Parameters
    ----------
    logits : [T, B, C] pre-softmax activations (time major).
    labels : [B, L] int labels; values equal to ``blank`` are padding.
    blank : int
        Blank class index (warp-ctc convention: 0).

    Returns ``[B]`` losses in ``logits``' dtype promoted to at least
    float32.  Differentiable through autograd.
    """
    T, B, C = logits.shape
    L = labels.shape[1]
    S = 2 * L + 1
    ldt = torch.promote_types(logits.dtype, torch.float32)
    lp = torch.log_softmax(logits.to(ldt), dim=-1)
    dev = logits.device

    labels = labels.to(torch.int64)
    lengths = (labels != blank).sum(dim=1)                 # [B]
    # extended sequence z: blanks interleaved with labels
    z = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    z[:, 1::2] = labels
    # transition s-2 -> s allowed iff z_s != blank and z_s != z_{s-2}
    z_prev2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64,
                                    device=dev), z[:, :-2]], dim=1)[:, :S]
    can_skip = (z != blank) & (z != z_prev2)               # [B, S]

    def neg(n):
        return torch.full((B, n), _NEG, dtype=ldt, device=dev)

    def emit(lp_t):                                         # [B,C] -> [B,S]
        return torch.gather(lp_t, 1, z)

    first = [lp[0, :, blank:blank + 1]]
    if L > 0:
        # only valid when the label has at least one symbol
        first.append(torch.where(lengths[:, None] > 0,
                                 emit(lp[0])[:, 1:2], neg(1)))
        first.append(neg(S - 2))
    alpha = torch.cat(first, dim=1)
    for t in range(1, T):
        a1 = torch.cat([neg(1), alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg(2), alpha[:, :-2]], dim=1)[:, :S]
        a2 = torch.where(can_skip, a2, neg(S))
        merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
        alpha = merged + emit(lp[t])
    # finish in the last blank (index 2*len) or the last symbol (2*len - 1)
    idx_last = 2 * lengths                                  # [B]
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    idx_sym = torch.clamp_min(idx_last - 1, 0)
    a_sym = torch.gather(alpha, 1, idx_sym[:, None])[:, 0]
    a_sym = torch.where(lengths > 0, a_sym, neg(1)[:, 0])
    return -torch.logaddexp(a_last, a_sym)


class _WarpCTCFn(torch.autograd.Function):
    """Forward: ``softmax(data)`` (plain softmax, as the JAX op's
    ``jax.nn.softmax``).  Backward: the CTC gradient with respect to the
    pre-softmax activations, through autograd over :func:`ctc_loss`,
    times the head cotangent; ``label`` gets a zero gradient."""

    @staticmethod
    def forward(ctx, data, label, T, L):
        ctx.save_for_backward(data, label)
        ctx.T, ctx.L = T, L
        dt = torch.promote_types(data.dtype, torch.float32)
        return torch.softmax(data.to(dt), dim=-1)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        T, L = ctx.T, ctx.L
        TB, C = data.shape
        B = TB // T
        dt = torch.promote_types(data.dtype, torch.float32)
        with torch.enable_grad():
            logits = data.detach().to(dt).reshape(T, B, C).requires_grad_()
            labels = label.detach().to(torch.int64).reshape(B, L)
            (grad,) = torch.autograd.grad(ctc_loss(logits, labels).sum(),
                                          logits)
        grad = grad.reshape(TB, C) * g.to(grad.dtype)
        return grad.to(data.dtype), torch.zeros_like(label), None, None


def _warpctc_fwd(ctx, params, data, label):
    """Reference-parity op: data [(T*B), C], label [B*L] flattened."""
    return _WarpCTCFn.apply(data, label, params["input_length"],
                            params["label_length"])


def _warpctc_shape(params, in_shapes):
    shapes = list(in_shapes) + [None] * (2 - len(in_shapes))
    d = shapes[0]
    if d is None:
        return shapes, [None], []
    T = params["input_length"]
    L = params["label_length"]
    B = d[0] // T
    shapes[1] = (B * L,)
    return shapes, [tuple(d)], []


register_op(OpDef(
    name="WarpCTC",
    forward=_warpctc_fwd,
    arguments=("data", "label"),
    params={
        "input_length": OpParam("input_length", "int", required=True),
        "label_length": OpParam("label_length", "int", required=True),
    },
    infer_shape=_warpctc_shape,
    doc="CTC loss head (warp-ctc plugin parity): softmax forward, CTC "
        "gradient backward, blank=0, zero-padded labels.",
))
