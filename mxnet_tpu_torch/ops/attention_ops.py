"""Attention operators for the symbol layer, on one device.

Counterpart of ``mxnet_tpu/ops/attention_ops.py``.  ``RingAttention``
computes exact attention: dense below ``AUTO_SWITCH_LEN`` (or with
``block_size=-1``), the flash family (kernels K3/K4 on the card, their
plain versions on the CPU; ``parallel/flash_attention.py``) at or above
it, or with an explicit ``block_size > 0``.  It takes ``[B, H, L, D]``
or, with ``layout="blhd"``, ``[B, L, H, D]`` (the transformer's layout,
read by the kernels in place).  A causal call with an explicit block
pads a ragged sequence to the next block multiple and slices the output
back, as the reference does.

The JAX op turns into ring attention over an active mesh's ``seq`` axis;
the port has no mesh (``parallel.mesh`` raises), so the op always runs
single-device.  ``MoEFFN`` is registered with the reference's arguments,
parameters and shapes, so symbols that hold it build and serialise; its
forward raises until the multi-GPU slice.
"""
from __future__ import annotations

import logging

import torch.nn.functional as F

from ..base import MXNetError, not_ported
from .registry import OpDef, OpParam, register_op

__all__ = []  # ops land in the registry


def _attention_fwd(ctx, params, q, k, v):
    from ..parallel.flash_attention import (AUTO_SWITCH_LEN, _pick_block,
                                            flash_attention)
    from ..parallel.ring_attention import local_attention
    causal = params["causal"]
    blhd = params["layout"] == "blhd"
    block = params["block_size"]
    if block < 0:
        # -1 forces the dense path
        block = None
    elif block == 0:
        lk = k.shape[1] if blhd else k.shape[2]
        if lk < AUTO_SWITCH_LEN:
            block = None
        elif _pick_block(lk) is None:
            # no power-of-two block divides the length: dense, loudly
            block = None
            logging.getLogger(__name__).warning(
                "attention seq len %d >= %d has no power-of-two block "
                "divisor; using DENSE attention ([L, L] scores "
                "materialize) - pad the sequence to a multiple of 64", lk,
                AUTO_SWITCH_LEN)

    # ragged length with an explicit causal block: pad q/k/v to the next
    # block multiple; under the causal mask every padded key is masked for
    # every valid query, so the valid rows are those of the padded bucket
    orig_len = None
    if causal and block is not None and block > 0:
        seq_dim = 1 if blhd else 2
        rem = q.shape[seq_dim] % block
        if rem:
            orig_len = q.shape[seq_dim]
            pad = [0, 0] * (q.dim() - seq_dim - 1) + [0, block - rem]
            q, k, v = (F.pad(t, pad) for t in (q, k, v))

    if blhd:
        if block is not None:
            out = flash_attention(q, k, v, causal=causal, layout="blhd",
                                  block_k=(block or None))
        else:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            out = local_attention(q, k, v, causal=causal).transpose(1, 2)
        return out[:, :orig_len] if orig_len is not None else out
    out = local_attention(q, k, v, causal=causal, block_size=block)
    return out[:, :, :orig_len] if orig_len is not None else out


def _attention_shape(params, in_shapes):
    q, k, v = (list(in_shapes) + [None] * 3)[:3]
    known = next((s for s in (q, k, v) if s is not None), None)
    if known is None:
        return in_shapes, [None], []
    if len(known) != 4:
        raise MXNetError(
            f"RingAttention expects [batch, heads, seq, head_dim] (or "
            f"[batch, seq, heads, head_dim] with layout='blhd'), "
            f"got {known}")
    return [tuple(known)] * 3, [tuple(q or known)], []


def _moe_ffn_fwd(ctx, params, *inputs):
    raise not_ported("MoEFFN (mixture of experts, multi-GPU slice)")


def _moe_ffn_shape(params, in_shapes):
    shapes = list(in_shapes) + [None] * (6 - len(in_shapes))
    d = shapes[0]
    if d is None:
        return shapes, [None, ()] if params["aux_loss"] else [None], []
    e = params["num_experts"]
    h = params["hidden_size"]
    dm = d[-1]
    outs = [tuple(d), ()] if params["aux_loss"] else [tuple(d)]
    return ([tuple(d), (dm, e), (e, dm, h), (e, h), (e, h, dm), (e, dm)],
            outs, [])


register_op(OpDef(
    name="MoEFFN",
    forward=_moe_ffn_fwd,
    arguments=("data", "gate_weight", "expert1_weight", "expert1_bias",
               "expert2_weight", "expert2_bias"),
    outputs=lambda p: (["output", "aux_loss"] if p["aux_loss"]
                       else ["output"]),
    params={
        "num_experts": OpParam("num_experts", "int", required=True),
        "hidden_size": OpParam("hidden_size", "int", required=True),
        "capacity_factor": OpParam("capacity_factor", "float", default=1.5),
        "top_k": OpParam("top_k", "int", default=1),
        "expert_axis": OpParam("expert_axis", "str", default="expert"),
        "data_axis": OpParam("data_axis", "str", default="data"),
        "aux_loss": OpParam("aux_loss", "bool", default=False),
    },
    infer_shape=_moe_ffn_shape,
    doc="Top-k mixture-of-experts feed-forward (not ported: raises).",
))


register_op(OpDef(
    name="RingAttention",
    forward=_attention_fwd,
    arguments=("query", "key", "value"),
    params={
        "causal": OpParam("causal", "bool", default=False),
        "seq_axis": OpParam("seq_axis", "str", default="seq"),
        "layout": OpParam("layout", "str", default="bhld",
                          enum=("bhld", "blhd")),
        "block_size": OpParam("block_size", "int", default=0,
                              doc="0 = auto (dense below 1024, flash at or "
                                  "above); -1 = dense; > 0 = flash with "
                                  "that K block"),
    },
    infer_shape=_attention_shape,
    doc="Exact scaled-dot-product attention over [B, H, L, D] (or "
        "[B, L, H, D]); flash kernels K3/K4 for long sequences.",
))
