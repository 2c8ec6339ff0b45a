"""Flash-decode: paged decode attention through a CUDA kernel for Hopper.

Counterpart of ``mxnet_tpu/serve/flash_decode.py``.  Decode attention is
bound by device-memory bytes: each step streams every cached K/V position
of every running request once and does about four flops per element.
:func:`flash_decode_attention` runs the hand-written kernel of
``csrc/flash_decode.cu`` (split-K online-softmax partials plus their
combine) on CUDA tensors, and the plain PyTorch version
:func:`flash_decode_attention_ref` on CPU tensors.  The plain version
repeats the same split and padding logic and the same combine; it is what
the CPU tests hold against the JAX kernel, and what the kernel is held
against on the card.

The wrapper counts its kernel launches in
``flash_decode_attention.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..base import MXNetError
from ..parallel.ring_attention import NEG_INF

__all__ = ["flash_decode_attention", "flash_decode_attention_ref",
           "default_split_k", "split_plan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def default_split_k(nblk: int) -> int:
    """Split-K heuristic: short contexts stay single-stream; long
    contexts split so no partition scans more than 8 blocks, at most 8
    partitions."""
    if nblk <= 8:
        return 1
    return min(8, -(-nblk // 8))


def split_plan(nblk: int, split_k: Optional[int] = None) -> Tuple[int, int]:
    """``(splits, blocks_per_split)`` for a table of ``nblk`` columns."""
    splits = default_split_k(nblk) if split_k is None else int(split_k)
    if splits < 1:
        raise MXNetError(f"split_k must be >= 1, got {splits}")
    splits = min(splits, nblk)
    return splits, -(-nblk // splits)


def _check(q, k_pool, v_pool, tables, lengths):
    if q.dim() != 3:
        raise MXNetError(f"flash_decode: q must be [B, H, hd], got "
                         f"{tuple(q.shape)}")
    b, h, hd = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise MXNetError(f"flash_decode: pools must both be [NB, BS, H, hd], "
                         f"got {tuple(k_pool.shape)} and "
                         f"{tuple(v_pool.shape)}")
    if tuple(k_pool.shape[2:]) != (h, hd):
        raise MXNetError(f"flash_decode: pool heads/head_dim "
                         f"{tuple(k_pool.shape[2:])} != q's {(h, hd)}")
    if tables.dim() != 2 or tables.shape[0] != b or tables.shape[1] < 1:
        raise MXNetError(f"flash_decode: tables must be [B={b}, max_blocks], "
                         f"got {tuple(tables.shape)}")
    if tuple(lengths.shape) != (b,):
        raise MXNetError(f"flash_decode: lengths must be [B={b}], got "
                         f"{tuple(lengths.shape)}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise MXNetError(f"flash_decode: tables and lengths must be int32, "
                         f"got {tables.dtype} and {lengths.dtype}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype not in _DTYPE_CODES:
        raise MXNetError(f"flash_decode: q and pools must be float32 or "
                         f"bfloat16, got {q.dtype} and {k_pool.dtype}")
    if v_pool.dtype != k_pool.dtype:
        raise MXNetError("flash_decode: K and V pools differ in dtype")
    devs = {t.device for t in (q, k_pool, v_pool, tables, lengths)}
    if len(devs) != 1:
        raise MXNetError(f"flash_decode: inputs on several devices {devs}")


def _combine(acc, m, l):
    """Split-K combine: reweight each partition's partial by its distance
    to the global running max, then one normalised sum.  Empty partitions
    carry ``(m=NEG_INF, l=0, acc=0)`` and contribute nothing."""
    m_star = m.amax(dim=1)                               # [B, H]
    w = torch.exp(m - m_star[:, None])                   # [B, S, H]
    l_star = torch.clamp_min((l * w).sum(dim=1), 1e-30)
    return (acc * w[..., None]).sum(dim=1) / l_star[..., None]


def flash_decode_attention_ref(q, k_pool, v_pool, tables, lengths, *,
                               scale: Optional[float] = None,
                               split_k: Optional[int] = None):
    """Plain PyTorch version of the kernel: the same split-K function.

    The table is padded with trash-slot entries to ``splits * bps``
    columns; each split computes its partial ``(acc, m, l)`` with f32
    scores scaled by ``scale`` and positions ``>= lengths`` masked with
    ``NEG_INF``; partials combine as in the kernel.  Returns [B, H, hd]
    in ``q.dtype``.
    """
    _check(q, k_pool, v_pool, tables, lengths)
    b, h, hd = q.shape
    bs = k_pool.shape[1]
    nblk = tables.shape[1]
    scale_ = (1.0 / np.sqrt(hd)) if scale is None else scale
    splits, bps = split_plan(nblk, split_k)
    # pad with trash-slot entries: their positions are >= nblk*bs >= every
    # length, so the mask kills them
    idx = F.pad(tables, (0, splits * bps - nblk)).long()
    k = k_pool[idx].float().reshape(b, splits, bps * bs, h, hd)
    v = v_pool[idx].float().reshape(b, splits, bps * bs, h, hd)
    s = torch.einsum("bhd,bsphd->bshp", q.float(), k) * np.float32(scale_)
    pos = torch.arange(splits * bps * bs, device=q.device).reshape(splits, -1)
    valid = pos[None] < lengths.long()[:, None, None]     # [B, S, P]
    s = s.masked_fill(~valid[:, :, None, :], NEG_INF)
    m = s.amax(dim=-1)                                    # [B, S, H]
    p = torch.exp(s - m[..., None]).masked_fill(~valid[:, :, None, :], 0.0)
    acc = torch.einsum("bshp,bsphd->bshd", p, v)
    return _combine(acc, m, p.sum(dim=-1)).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    if not getattr(lib, "_mxt_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mxt_flash_decode.argtypes = [
            vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
        lib.mxt_flash_decode.restype = ci
        lib.mxt_max_head_dim.argtypes = []
        lib.mxt_max_head_dim.restype = ci
        lib.mxt_error_string.argtypes = [ci]
        lib.mxt_error_string.restype = ctypes.c_char_p
        lib._mxt_typed = True
    return lib


def flash_decode_attention(q, k_pool, v_pool, tables, lengths, *,
                           scale: Optional[float] = None,
                           split_k: Optional[int] = None):
    """Paged decode attention: ``q`` [B, H, hd]; one layer's pools
    [NB, BS, H, hd] (float32 or bfloat16); ``tables`` [B, max_blocks]
    int32; ``lengths`` [B] int32.  Returns [B, H, hd] in ``q.dtype``.

    CPU tensors go to :func:`flash_decode_attention_ref`.  CUDA tensors
    launch the kernel (and count the launch) or raise.
    """
    _check(q, k_pool, v_pool, tables, lengths)
    if q.device.type == "cpu":
        return flash_decode_attention_ref(q, k_pool, v_pool, tables, lengths,
                                          scale=scale, split_k=split_k)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_decode: unsupported device {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise MXNetError(f"flash_decode: {name} must be contiguous")
    b, h, hd = q.shape
    bs = k_pool.shape[1]
    nblk = tables.shape[1]
    lib = _lib()
    if hd > lib.mxt_max_head_dim():
        raise MXNetError(f"flash_decode: head_dim {hd} > "
                         f"{lib.mxt_max_head_dim()}")
    scale_ = (1.0 / np.sqrt(hd)) if scale is None else scale
    splits, bps = split_plan(nblk, split_k)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((b, splits, h, hd), **f32)
    m = torch.empty((b, splits, h), **f32)
    l = torch.empty((b, splits, h), **f32)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.mxt_flash_decode(
            q.data_ptr(), _DTYPE_CODES[q.dtype], k_pool.data_ptr(),
            v_pool.data_ptr(), _DTYPE_CODES[k_pool.dtype], tables.data_ptr(),
            lengths.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            out.data_ptr(), b, h, hd, bs, nblk, splits, bps, float(scale_),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise MXNetError(f"flash_decode kernel launch failed: CUDA error "
                         f"{rc} ({lib.mxt_error_string(rc).decode()})")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
