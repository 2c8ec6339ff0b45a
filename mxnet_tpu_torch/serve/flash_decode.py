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

fp8 pools (:class:`~.kvcache.QuantPool` pairs) run the kernel's fp8
instance (K5-fp8, ``mxt_flash_decode_fp8``): the e4m3 payload is read as
one byte per element and dequantized in registers against the
per-position scales.  The wrapper counts plain-pool launches in
``flash_decode_attention.launches`` and fp8 launches in
``flash_decode_attention.launches_fp8``.
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
from .kvcache import _gather_blocks, is_quantized

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


def _check(q, k_pool, v_pool, tables, lengths) -> bool:
    """Validate the operands; returns whether the pools are fp8."""
    quantized = is_quantized(k_pool)
    if quantized != is_quantized(v_pool):
        raise MXNetError("flash_decode: mixed quantized / plain K and V "
                         "pools")
    kp = k_pool.payload if quantized else k_pool
    vp = v_pool.payload if quantized else v_pool
    if q.dim() != 3:
        raise MXNetError(f"flash_decode: q must be [B, H, hd], got "
                         f"{tuple(q.shape)}")
    b, h, hd = q.shape
    if kp.dim() != 4 or kp.shape != vp.shape:
        raise MXNetError(f"flash_decode: pools must both be [NB, BS, H, hd], "
                         f"got {tuple(kp.shape)} and {tuple(vp.shape)}")
    if tuple(kp.shape[2:]) != (h, hd):
        raise MXNetError(f"flash_decode: pool heads/head_dim "
                         f"{tuple(kp.shape[2:])} != q's {(h, hd)}")
    if tables.dim() != 2 or tables.shape[0] != b or tables.shape[1] < 1:
        raise MXNetError(f"flash_decode: tables must be [B={b}, max_blocks], "
                         f"got {tuple(tables.shape)}")
    if tuple(lengths.shape) != (b,):
        raise MXNetError(f"flash_decode: lengths must be [B={b}], got "
                         f"{tuple(lengths.shape)}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise MXNetError(f"flash_decode: tables and lengths must be int32, "
                         f"got {tables.dtype} and {lengths.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise MXNetError(f"flash_decode: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    if quantized:
        if kp.dtype != torch.float8_e4m3fn or vp.dtype != kp.dtype:
            raise MXNetError(f"flash_decode: fp8 payloads must be "
                             f"float8_e4m3fn, got {kp.dtype} and {vp.dtype}")
        for sc in (k_pool.scale, v_pool.scale):
            if tuple(sc.shape) != tuple(kp.shape[:2]) or \
                    sc.dtype != torch.float32:
                raise MXNetError(f"flash_decode: scales must be float32 "
                                 f"{tuple(kp.shape[:2])}, got {sc.dtype}"
                                 f"{tuple(sc.shape)}")
    elif kp.dtype not in _DTYPE_CODES:
        raise MXNetError(f"flash_decode: pools must be float32 or bfloat16, "
                         f"got {kp.dtype}")
    elif vp.dtype != kp.dtype:
        raise MXNetError("flash_decode: K and V pools differ in dtype")
    leaves = (q, kp, vp, tables, lengths) + (
        (k_pool.scale, v_pool.scale) if quantized else ())
    devs = {t.device for t in leaves}
    if len(devs) != 1:
        raise MXNetError(f"flash_decode: inputs on several devices {devs}")
    return quantized


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
    columns; the gathered blocks are widened to f32 (an fp8 payload is
    then multiplied by its per-position scale); each split computes its
    partial ``(acc, m, l)`` with f32 scores scaled by ``scale`` and
    positions ``>= lengths`` masked with ``NEG_INF``; partials combine as
    in the kernel.  Returns [B, H, hd] in ``q.dtype``.
    """
    quantized = _check(q, k_pool, v_pool, tables, lengths)
    b, h, hd = q.shape
    bs = (k_pool.payload if quantized else k_pool).shape[1]
    nblk = tables.shape[1]
    scale_ = (1.0 / np.sqrt(hd)) if scale is None else scale
    splits, bps = split_plan(nblk, split_k)
    # pad with trash-slot entries: their positions are >= nblk*bs >= every
    # length, so the mask kills them
    idx = F.pad(tables, (0, splits * bps - nblk)).long()
    k = _gather_blocks(k_pool, idx).float().reshape(b, splits, bps * bs, h,
                                                     hd)
    v = _gather_blocks(v_pool, idx).float().reshape(b, splits, bps * bs, h,
                                                     hd)
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
        lib.mxt_flash_decode_fp8.argtypes = [
            vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
        lib.mxt_flash_decode_fp8.restype = ci
        lib.mxt_max_head_dim.argtypes = []
        lib.mxt_max_head_dim.restype = ci
        lib.mxt_error_string.argtypes = [ci]
        lib.mxt_error_string.restype = ctypes.c_char_p
        lib._mxt_typed = True
    return lib


def flash_decode_attention(q, k_pool, v_pool, tables, lengths, *,
                           scale: Optional[float] = None,
                           split_k: Optional[int] = None):
    """Paged decode attention: ``q`` [B, H, hd] (float32 or bfloat16);
    one layer's pools, [NB, BS, H, hd] float32 or bfloat16 tensors or
    :class:`~.kvcache.QuantPool` pairs (e4m3 payload, [NB, BS] f32
    scales); ``tables`` [B, max_blocks] int32; ``lengths`` [B] int32.
    Returns [B, H, hd] in ``q.dtype``.

    CPU tensors go to :func:`flash_decode_attention_ref`.  CUDA tensors
    launch the kernel (and count the launch) or raise.
    """
    quantized = _check(q, k_pool, v_pool, tables, lengths)
    if q.device.type == "cpu":
        return flash_decode_attention_ref(q, k_pool, v_pool, tables, lengths,
                                          scale=scale, split_k=split_k)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_decode: unsupported device {q.device}")
    kp = k_pool.payload if quantized else k_pool
    vp = v_pool.payload if quantized else v_pool
    named = [("q", q), ("k_pool", kp), ("v_pool", vp), ("tables", tables),
             ("lengths", lengths)]
    if quantized:
        named += [("k scale", k_pool.scale), ("v scale", v_pool.scale)]
    for name, t in named:
        if not t.is_contiguous():
            raise MXNetError(f"flash_decode: {name} must be contiguous")
    b, h, hd = q.shape
    bs = kp.shape[1]
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
    tail = (tables.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), out.data_ptr(), b, h, hd, bs, nblk,
            splits, bps, float(scale_),
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        if quantized:
            rc = lib.mxt_flash_decode_fp8(
                q.data_ptr(), _DTYPE_CODES[q.dtype], kp.data_ptr(),
                vp.data_ptr(), k_pool.scale.data_ptr(),
                v_pool.scale.data_ptr(), *tail)
        else:
            rc = lib.mxt_flash_decode(
                q.data_ptr(), _DTYPE_CODES[q.dtype], kp.data_ptr(),
                vp.data_ptr(), _DTYPE_CODES[kp.dtype], *tail)
    if rc != 0:
        raise MXNetError(f"flash_decode kernel launch failed: CUDA error "
                         f"{rc} ({lib.mxt_error_string(rc).decode()})")
    if quantized:
        flash_decode_attention.launches_fp8 += 1
    else:
        flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention.launches_fp8 = 0
