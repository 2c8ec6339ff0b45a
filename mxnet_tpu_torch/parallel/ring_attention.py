"""Single-shard attention: the dense causal path of ``local_attention``.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py:local_attention``
with ``block_size=None``, the path whole-prompt prefill takes.  The
blockwise, flash and ring paths come with transformer-LM training.
"""
from __future__ import annotations

import math

import torch

from ..base import not_ported

__all__ = ["NEG_INF", "local_attention"]

#: masking value of the JAX package (``parallel/flash_attention.py``)
NEG_INF = -1e30


def local_attention(q, k, v, *, causal=False, scale=None, q_offset=0,
                    kv_offset=0, neg_inf=NEG_INF, block_size=None):
    """Scaled dot-product attention on ``[B, H, L, D]``, with optional
    causal masking in global positions.  Scores and softmax run in f32;
    the probabilities are cast back to the activation dtype for the PV
    product, as the JAX package does."""
    if block_size is not None:
        raise not_ported("local_attention(block_size=...) (blockwise/flash)")
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
