"""Attention and mixture-of-experts operators for the symbol layer.

Counterpart of ``mxnet_tpu/ops/attention_ops.py``.  ``RingAttention``
computes exact attention: dense below ``AUTO_SWITCH_LEN`` (or with
``block_size=-1``), the flash family (kernels K3/K4 on the card, their
plain versions on the CPU; ``parallel/flash_attention.py``) at or above
it, or with an explicit ``block_size > 0``.  It takes ``[B, H, L, D]``
or, with ``layout="blhd"``, ``[B, L, H, D]`` (the transformer's layout,
read by the kernels in place).  A causal call with an explicit block
pads a ragged sequence to the next block multiple and slices the output
back, as the reference does.

Both ops switch on the active mesh (``parallel.default_mesh``; the
trainer scopes its own around each step), as the JAX ops do:

* ``RingAttention`` under a mesh whose ``seq_axis`` has more than one
  member runs ring attention (``blhd`` inputs transposed to ``[B, H, L,
  D]`` around it).  Inside a trainer member's step (``OpContext.sync``)
  every member of a seq group holds the same rows: it takes its shard
  of the sequence, runs ``ring_attention`` with the group, and gathers
  the group's output shards (each differentiable into its owner);
  outside one, ``ring_self_attention`` runs the mesh's members itself.
* ``MoEFFN`` flattens its input to ``[-1, d]`` and takes the
  expert-parallel program (``moe_ffn_ep``) under a mesh whose
  ``expert_axis`` has more than one member, else Switch for ``top_k <=
  1``, else top-k; with ``aux_loss`` it returns ``load_balance_loss`` as
  a second head.  In a member's step the expert group's members hold the
  same rows: each runs its token block through ``ep_member`` (its own
  experts: a piece the trainer's rules gave it, or its slice of a whole
  weight) and gathers the group's outputs.  Where the trainer marks the
  node as a reduction over the data group's rows (the implicit mode over
  several data members), the dense programs route that group's global
  batch and the aux loss averages over it.
"""
from __future__ import annotations

import logging

import torch.nn.functional as F

from ..base import MXNetError
from .registry import OpDef, OpParam, register_op

__all__ = []  # ops land in the registry


def _active_axis(axis: str):
    """The active mesh when it has ``axis`` with more than one member."""
    from ..parallel.mesh import current_mesh
    mesh = current_mesh()
    if mesh is not None and axis in mesh.axis_names and mesh.shape[axis] > 1:
        return mesh
    return None


def _ring_member(sync, q, k, v, axis, causal):
    """A trainer member's ring attention: its shard of the sequence
    (``[B, H, L, D]``) through ``ring_attention`` with its seq group, the
    group's output shards gathered end to end."""
    from ..parallel.ring_attention import ring_attention
    n, r = sync.size(axis), sync.rank(axis)
    length = q.shape[2]
    if length % n:
        raise MXNetError(f"RingAttention: sequence length {length} does not "
                         f"split over the {n} members of axis {axis!r}")
    sl = slice(r * (length // n), (r + 1) * (length // n))
    out = ring_attention(q[:, :, sl], k[:, :, sl], v[:, :, sl], axis,
                         causal=causal, sync=sync)
    return sync.all_gather(out, 2, axis)


def _attention_fwd(ctx, params, q, k, v):
    from ..parallel.flash_attention import (AUTO_SWITCH_LEN, _pick_block,
                                            flash_attention)
    from ..parallel.ring_attention import local_attention, ring_self_attention
    causal = params["causal"]
    blhd = params["layout"] == "blhd"
    axis = params["seq_axis"]
    mesh = _active_axis(axis)
    if mesh is not None:
        # the ring cuts dim 2: blhd inputs go to [B, H, L, D] around it
        if blhd:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if ctx.sync is not None:
            out = _ring_member(ctx.sync, q, k, v, axis, causal)
        else:
            out = ring_self_attention(q, k, v, mesh, seq_axis=axis,
                                      causal=causal)
        return out.transpose(1, 2) if blhd else out
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


def _moe_ep_member(sync, x, gate_w, w1, b1, w2, b2, params, axis):
    """A trainer member's expert-parallel program: token block ``r`` of
    its rows (``r`` its rank along ``axis``), its own experts, and the
    group's outputs and router probabilities gathered end to end."""
    from ..parallel.moe import ep_member
    ep, r = sync.size(axis), sync.rank(axis)
    e = params["num_experts"]
    if e % ep or x.shape[0] % ep:
        raise MXNetError(f"MoEFFN: {e} experts and {x.shape[0]} tokens must "
                         f"both split over the {ep} members of axis {axis!r}")
    n_l = x.shape[0] // ep
    w = [t if t.shape[0] == e // ep else t.chunk(ep)[r]
         for t in (w1, b1, w2, b2)]
    y, probs = ep_member(x[r * n_l:(r + 1) * n_l], gate_w, *w,
                         max(1, params["top_k"]), params["capacity_factor"],
                         sync, axis)
    return sync.all_gather(y, 0, axis), sync.all_gather(probs, 0, axis)


def _moe_ffn_fwd(ctx, params, x, gate_w, w1, b1, w2, b2):
    from ..parallel.mesh import DATA_AXIS
    from ..parallel.moe import (load_balance_loss, moe_ffn, moe_ffn_ep,
                                switch_ffn)
    orig = x.shape
    x = x.reshape(-1, orig[-1])
    eax = params["expert_axis"]
    sync = ctx.sync
    # the node reduces over the data group's rows: route its global batch
    glob = (sync if sync is not None and sync.reduces_rows
            and sync.size(DATA_AXIS) > 1 else None)
    mesh = _active_axis(eax)
    cf = params["capacity_factor"]
    if mesh is not None and sync is not None:
        y, probs = _moe_ep_member(sync, x, gate_w, w1, b1, w2, b2, params,
                                  eax)
    elif mesh is not None:
        y, probs = moe_ffn_ep(x, gate_w, w1, b1, w2, b2, mesh,
                              k=max(1, params["top_k"]), capacity_factor=cf,
                              expert_axis=eax, data_axis=params["data_axis"])
    elif params["top_k"] <= 1:
        y, probs = switch_ffn(x, gate_w, w1, b1, w2, b2, capacity_factor=cf,
                              sync=glob)
    else:
        y, probs = moe_ffn(x, gate_w, w1, b1, w2, b2, k=params["top_k"],
                           capacity_factor=cf, sync=glob)
    y = y.reshape(orig)
    if params["aux_loss"]:
        return y, load_balance_loss(probs, sync=glob)
    return y


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
        "aux_loss": OpParam("aux_loss", "bool", default=False,
                            doc="emit the Switch load-balance auxiliary "
                                "loss as a second (scalar) output"),
    },
    infer_shape=_moe_ffn_shape,
    doc="Top-k mixture-of-experts feed-forward (top_k=1: Switch, 2: "
        "GShard).  When the active default mesh has an ``expert_axis`` "
        "of size > 1, the explicit-all-to-all expert-parallel program "
        "(parallel/moe.py:moe_ffn_ep); otherwise dense dispatch/combine "
        "einsums.",
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
