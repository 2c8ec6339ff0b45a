"""Attention on one shard and ring attention over a ``seq`` mesh axis.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py``:

* ``local_attention`` (dense for ``block_size=None``, the flash family
  otherwise) and ``blockwise_attention`` (the exact online-softmax
  reference, optionally with row statistics) on one device; autograd
  differentiates the blockwise loop where the JAX package differentiates
  its checkpointed scan;
* :func:`ring_attention`: exact attention over a sequence cut over the
  members of a mesh axis, called inside a member's step on its local
  ``[B, H, L/N, D]`` shards.  K/V blocks travel the ring (``N - 1``
  meetings, each member taking the block of the one before it:
  ``ppermute``'s step) while each member keeps its query shard; shards
  the flash gate admits run :class:`_RingFlash` (kernel K3 through
  ``flash_attention_stats`` a step, merged by ``logaddexp`` in f32;
  backward K4 through ``flash_attention_block_bwd`` against the merged
  ``lse`` and one global ``delta``), the others a dense per-step online
  softmax;
* :func:`ring_self_attention`: global ``[B, H, L, D]`` tensors over a
  mesh of contexts, the sequence cut over ``seq_axis`` and the batch
  over ``batch_axis`` when the mesh has it; each member runs
  :func:`ring_attention` in its own thread.

The visiting blocks are inputs of the step's autograd graph, so each
block's ``dk``/``dv`` go back to the member that owns it; ``dq`` stays
local.  A member keeps the blocks that visited it until the backward
(the JAX ring re-sends them in its backward pass).  On the CPU
``flash_attention_stats`` and ``flash_attention_block_bwd`` take their
plain versions; on CUDA tensors they launch K3 and K4 or raise.

``local_attention.dense_calls`` and ``blockwise_attention.calls`` count
how often each path ran, so a run can show that the flash kernels and not
these paths carried its attention.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import NEG_INF
from .members import current_sync, mesh_groups, run_synced
from .mesh import SEQ_AXIS, NamedSharding, PartitionSpec

__all__ = ["NEG_INF", "local_attention", "blockwise_attention",
           "ring_attention", "ring_self_attention"]


def local_attention(q, k, v, *, causal=False, scale=None, q_offset=0,
                    kv_offset=0, neg_inf=NEG_INF, block_size=None):
    """Scaled dot-product attention on ``[B, H, L, D]``, with optional
    causal masking in global positions.

    ``block_size``: ``None`` = dense (scores and softmax in f32, the
    probabilities cast back to the activation type for the PV product);
    ``0`` = the flash family with its own block picks; ``> 0`` = the
    flash family with that K-block size.  Offsets or a caller's
    ``neg_inf`` route a blocked call to :func:`blockwise_attention`, as in
    the JAX package (the kernels hard-code the default masking value).
    """
    if block_size is not None:
        from .flash_attention import _pick_block, flash_attention
        if q_offset == 0 and kv_offset == 0 and neg_inf == NEG_INF:
            return flash_attention(q, k, v, causal=causal, scale=scale,
                                   block_k=(block_size or None))
        blk = block_size or _pick_block(k.shape[2]) or k.shape[2]
        return blockwise_attention(q, k, v, blk, causal=causal, scale=scale,
                                   q_offset=q_offset, kv_offset=kv_offset,
                                   neg_inf=neg_inf)
    local_attention.dense_calls += 1
    if scale is None:
        # a fill, not a copy from the host: capturable in a CUDA graph
        scale = 1.0 / torch.full((), math.sqrt(q.shape[-1]), dtype=q.dtype,
                                 device=q.device)
    scores = (torch.einsum("bhqd,bhkd->bhqk", q, k) * scale).float()
    if causal:
        qpos = q_offset + torch.arange(q.shape[2], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[2], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = scores.masked_fill(~mask, neg_inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


local_attention.dense_calls = 0


def blockwise_attention(q, k, v, block_size, *, causal=False, scale=None,
                        q_offset=0, kv_offset=0, neg_inf=NEG_INF,
                        return_stats=False):
    """Exact attention over key blocks with running (max, sum,
    accumulator) statistics in f32; ``[B, H, L, D]`` in and out.  With
    ``return_stats`` also the row logsumexp ``[B, H, L]`` f32."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if lk % block_size:
        raise ValueError(f"key length {lk} not divisible by block "
                         f"{block_size}")
    blockwise_attention.calls += 1
    f32 = torch.float32
    scale_ = (1.0 / math.sqrt(d)) if scale is None else scale
    qpos = q_offset + torch.arange(lq, device=q.device)
    m = torch.full((b, h, lq), neg_inf, dtype=f32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=f32, device=q.device)
    o = torch.zeros((b, h, lq, d), dtype=f32, device=q.device)
    for i in range(lk // block_size):
        sl = slice(i * block_size, (i + 1) * block_size)
        k_blk, v_blk = k[:, :, sl], v[:, :, sl]
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k_blk).to(f32) * scale_
        mask = None
        if causal:
            kpos = (kv_offset + i * block_size
                    + torch.arange(block_size, device=q.device))
            mask = qpos[:, None] >= kpos[None, :]
            scores = scores.masked_fill(~mask, neg_inf)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                v_blk.to(f32))
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = (o / l[..., None]).to(q.dtype)
    if return_stats:
        return out, m + torch.log(l)
    return out


blockwise_attention.calls = 0


def _ring_order(me: int, n: int, i: int) -> int:
    """The block that visits member ``me`` at ring step ``i``: blocks
    move forward, so it holds block ``(me - i) mod n``."""
    return (me - i) % n


def _step_mode(causal: bool, me: int, n: int, i: int) -> str:
    """How step ``i`` attends its visiting block: ``full`` (an earlier
    block, or no mask), ``diag`` (its own block: the causal kernel) or
    ``skip`` (a later block, fully masked)."""
    if not causal:
        return "full"
    kv = _ring_order(me, n, i)
    return "diag" if kv == me else "full" if kv < me else "skip"


class _RingFlash(torch.autograd.Function):
    """The flash ring (the JAX ``_ring_flash`` custom_vjp) over one
    member's query shard and the ``n`` key and value blocks that visit it,
    in ring order.

    Forward: for each step, ``flash_attention_stats`` (K3) on the full,
    diagonal or no block by causal position, the running ``(out, lse)``
    merged by ``logaddexp`` in f32.  Backward: ``delta = rowsum(do *
    out)`` once, then ``flash_attention_block_bwd`` (K4) against the
    merged ``lse`` with that ``delta`` for each visiting block; ``dq``
    sums locally in f32 and each block's ``dk``/``dv`` is that block's
    gradient (autograd carries it to the block's owner, where the
    visits' gradients sum in the block's type)."""

    @staticmethod
    def forward(ctx, q, causal, scale, me, n, *blocks):
        from .flash_attention import flash_attention_stats
        f32 = torch.float32
        ks, vs = blocks[:n], blocks[n:]
        o = torch.zeros(q.shape, dtype=f32, device=q.device)
        lse = torch.full(q.shape[:-1], NEG_INF, dtype=f32, device=q.device)
        for i in range(n):
            mode = _step_mode(causal, me, n, i)
            if mode == "skip":
                # logaddexp(lse, NEG_INF) is lse and the block adds
                # nothing: the JAX step's merge with an empty block
                continue
            out_i, lse_i = flash_attention_stats(q, ks[i], vs[i],
                                                 causal=mode == "diag",
                                                 scale=scale)
            lse_new = torch.logaddexp(lse, lse_i)
            o = (o * torch.exp(lse - lse_new)[..., None]
                 + out_i.to(f32) * torch.exp(lse_i - lse_new)[..., None])
            lse = lse_new
        out = o.to(q.dtype)
        ctx.save_for_backward(q, out, lse, *blocks)
        ctx.cfg = (causal, scale, me, n)
        return out

    @staticmethod
    def backward(ctx, do):
        from .flash_attention import flash_attention_block_bwd
        q, out, lse, *blocks = ctx.saved_tensors
        causal, scale, me, n = ctx.cfg
        ks, vs = blocks[:n], blocks[n:]
        f32 = torch.float32
        do = do.contiguous()
        # delta = rowsum(do * out) is the same at every step: once
        delta = (do.to(f32) * out.to(f32)).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=f32, device=q.device)
        dks, dvs = [None] * n, [None] * n
        for i in range(n):
            mode = _step_mode(causal, me, n, i)
            if mode == "skip":
                continue
            dq_i, dks[i], dvs[i] = flash_attention_block_bwd(
                q, ks[i], vs[i], out, lse, do, causal=mode == "diag",
                scale=scale, delta=delta)
            dq = dq + dq_i.to(f32)
        return (dq.to(q.dtype), None, None, None, None, *dks, *dvs)


def _flash_gate(q, k, v, scale, neg_inf) -> bool:
    """The JAX ring's condition for the flash path, condition for
    condition."""
    from .flash_attention import _pick_block
    lq, lkv, d = q.shape[2], k.shape[2], q.shape[3]
    return (neg_inf == NEG_INF and lq == lkv
            and (scale is None or isinstance(scale, (int, float)))
            and _pick_block(lq) is not None and _pick_block(lkv) is not None
            and d <= 256 and q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.float32, torch.bfloat16))


def _ring_dense(q, ks, vs, me, n, causal, scale, neg_inf):
    """The dense per-step ring (shards the flash gate refuses): scores of
    the query shard against each visiting block in f32 with causal
    masking in global positions, merged by running (max, sum,
    accumulator) statistics."""
    b, h, lq, d = q.shape
    lkv = ks[0].shape[2]
    f32 = torch.float32
    scale_ = (1.0 / math.sqrt(d)) if scale is None else scale
    qpos = me * lq + torch.arange(lq, device=q.device)
    m = torch.full((b, h, lq), neg_inf, dtype=f32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=f32, device=q.device)
    o = torch.zeros((b, h, lq, d), dtype=f32, device=q.device)
    for i in range(n):
        scores = torch.einsum("bhqd,bhkd->bhqk", q, ks[i]).to(f32) * scale_
        mask = None
        if causal:
            kpos = (_ring_order(me, n, i) * lkv
                    + torch.arange(lkv, device=q.device))
            mask = qpos[:, None] >= kpos[None, :]
            scores = scores.masked_fill(~mask, neg_inf)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                vs[i].to(f32))
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (o / l[..., None]).to(q.dtype)


def ring_attention(q, k, v, axis_name: str = SEQ_AXIS, *, causal=False,
                   scale=None, neg_inf=NEG_INF, sync=None):
    """Exact ring attention inside a mesh member's step.

    ``q``, ``k``, ``v`` are the member's local ``[B, H, L/N, D]`` shards
    of a sequence cut over the members of ``axis_name`` (member ``r`` of
    the axis holds positions ``[r L/N, (r+1) L/N)``); ``sync`` is the
    member's meetings (default: the calling member thread's).  Returns
    the member's ``[B, H, L/N, D]`` shard of the output, differentiable
    into every member's ``q``, ``k`` and ``v``.  Shards the flash gate
    admits (block divisor >= 64, ``Lq == Lkv``, ``D <= 256``, f32/bf16 of
    one type, the default masking value, a number or no ``scale``) take
    the flash ring; the others the dense per-step ring."""
    if sync is None:
        sync = current_sync("ring_attention")
    n, me = sync.size(axis_name), sync.rank(axis_name)
    ks, vs = [k], [v]
    for _ in range(n - 1):
        k_nxt, v_nxt = sync.shift((ks[-1], vs[-1]), axis_name)
        ks.append(k_nxt)
        vs.append(v_nxt)
    if _flash_gate(q, k, v, scale, neg_inf):
        d = q.shape[-1]
        scale_f = float(1.0 / (d ** 0.5)) if scale is None else float(scale)
        return _RingFlash.apply(q, causal, scale_f, me, n, *ks, *vs)
    return _ring_dense(q, ks, vs, me, n, causal, scale, neg_inf)


def ring_self_attention(q, k, v, mesh, *, seq_axis: str = SEQ_AXIS,
                        batch_axis: Optional[str] = "data",
                        causal: bool = False, scale: Optional[float] = None):
    """Global ``[B, H, L, D]`` tensors, the sequence cut over
    ``seq_axis`` of ``mesh`` (a mesh of contexts) and, when the mesh has
    ``batch_axis``, the batch over it; each member runs
    :func:`ring_attention` on its shards in its own thread (on its
    device).  Returns the global result on ``q``'s device,
    differentiable into ``q``, ``k`` and ``v``."""
    b_axis = batch_axis if (batch_axis and batch_axis in mesh.axis_names) \
        else None
    sh = NamedSharding(mesh, PartitionSpec(b_axis, None, seq_axis, None))
    devices = [m.torch_device for m in mesh.members]
    first = {}
    for i in range(mesh.size):
        idx = sh.index(i, q.shape)
        first.setdefault((idx[0].start, idx[2].start), i)

    def member(i, handle):
        idx = sh.index(i, q.shape)
        ql, kl, vl = (t[idx].to(devices[i]) for t in (q, k, v))
        return ring_attention(ql, kl, vl, seq_axis, causal=causal,
                              scale=scale, sync=handle.at("ring_attention"))

    outs = run_synced(member, devices, mesh_groups(mesh, [seq_axis]))
    rows = {}
    for (b0, s0), i in sorted(first.items()):
        rows.setdefault(b0, []).append(outs[i].to(q.device))
    return torch.cat([torch.cat(r, dim=2) for _, r in sorted(rows.items())],
                     dim=0)
