"""Single-shard attention: the dense, blockwise and flash paths of
``local_attention``.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py`` on one device:
``local_attention`` (dense for ``block_size=None``, the flash family
otherwise) and ``blockwise_attention`` (the exact online-softmax
reference, optionally with row statistics).  Autograd differentiates
the blockwise loop where the JAX package differentiates its checkpointed
scan.  The ring functions (sequence parallelism over a mesh) belong to
the multi-GPU slice and raise.

``local_attention.dense_calls`` and ``blockwise_attention.calls`` count
how often each path ran, so a run can show that the flash kernels and not
these paths carried its attention.
"""
from __future__ import annotations

import math

import torch

from ..base import not_ported
from .flash_attention import NEG_INF

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
        scale = 1.0 / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype,
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


def ring_attention(*args, **kwargs):
    raise not_ported("ring_attention (sequence parallelism, multi-GPU)")


def ring_self_attention(*args, **kwargs):
    raise not_ported("ring_self_attention (sequence parallelism, "
                     "multi-GPU)")
