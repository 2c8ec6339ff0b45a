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

The kernel has two forms (:func:`kernel_form` picks one; ``form=``
forces an allowed one): ``"hopper"``, bulk-copy rings of table entries
with the combine in the same launch (16-byte aligned pools and head
slices, see :func:`hopper_plan`), and ``"warp"``, the first port's
dependent chain per position, for any operands.  fp8 pools
(:class:`~.kvcache.QuantPool` pairs) run the kernel's fp8 instance
(K5-fp8): the e4m3 payload is read as one byte per element and
dequantized in registers against the per-position scales.  The wrapper
counts plain-pool launches in ``flash_decode_attention.launches``, fp8
launches in ``flash_decode_attention.launches_fp8`` and both by form in
``flash_decode_attention.launches_by_form``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..analysis import program as _program
from ..base import MXNetError
from ..parallel.ring_attention import NEG_INF
from .kvcache import _gather_blocks, is_quantized

__all__ = ["flash_decode_attention", "flash_decode_attention_ref",
           "default_split_k", "split_plan", "kernel_form", "hopper_plan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_FORM_CODES = {"warp": 0, "hopper": 1}
MAX_HEAD_DIM = 256
# the hopper form's plan: a ring stage holds one table entry's K and V rows
# of a head group (and for fp8 their scale rows) and stays under
# _MAX_STAGE_BYTES; the ring's stages share _RING_BYTES (at least 2
# stages, at most 4); at most _MAX_GROUP consumer warps and _MAX_ENTRIES
# table entries a block
_MAX_STAGE_BYTES = 64 << 10
_RING_BYTES = 100 << 10
_MAX_GROUP = 8
_MAX_ENTRIES = 2048


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


def _stage_bytes(bs: int, group: int, hd: int, esize: int,
                 quantized: bool) -> int:
    return 2 * bs * group * hd * esize + (8 * bs if quantized else 0)


def kernel_form(k_pool, v_pool) -> str:
    """The kernel form for one layer's pools: ``"hopper"`` when the bulk
    copies can read them (every pool and scale tensor starts on a 16-byte
    boundary, a position's head slice ``hd * element size`` is a multiple
    of 16 bytes, for fp8 pools the block size is a multiple of 4 so a
    scale row is too, and one head's ring stage fits), else ``"warp"``."""
    quantized = is_quantized(k_pool)
    read = ((k_pool.payload, v_pool.payload, k_pool.scale, v_pool.scale)
            if quantized else (k_pool, v_pool))
    _, bs, _, hd = read[0].shape
    esize = read[0].element_size()
    if ((hd * esize) % 16 == 0 and hd <= MAX_HEAD_DIM
            and (not quantized or bs % 4 == 0)
            and _stage_bytes(bs, 1, hd, esize, quantized) <= _MAX_STAGE_BYTES
            and all(t.data_ptr() % 16 == 0 for t in read)):
        return "hopper"
    return "warp"


def _resolve_form(form, k_pool, v_pool) -> str:
    """``form``, or :func:`kernel_form`'s choice when it is None; raises
    on a form the operands do not allow."""
    best = kernel_form(k_pool, v_pool)
    if form is None:
        return best
    allowed = {"warp", best}
    if form not in allowed:
        raise MXNetError(f"flash_decode: form {form!r} cannot take these "
                         f"operands (allowed: {sorted(allowed)})")
    return form


@functools.lru_cache(maxsize=256)
def hopper_plan(b: int, h: int, hd: int, bs: int, esize: int,
                quantized: bool, splits: int, bps: int,
                num_sms: int = 132) -> Tuple[int, int, int, int]:
    """``(group, parts, entries, stages)`` of the hopper form.  Blocks own
    ``group`` heads: the largest divisor of ``h`` (at most 8) whose ring
    stage fits 64 KB, so that at the served shapes a block takes all
    heads and copies each table entry as one contiguous run.  The ring
    has as many ``stages`` as fit 100 KB (2 to 4, never more than the
    entries).  Each split's ``bps`` columns are cut into ``parts`` parts
    of at most ``entries`` columns, as many as give every SM one block
    (two where two rings fit its shared memory) in one wave (at least
    one part, never finer than one column, at most 2048 columns a
    part)."""
    group = max(g for g in range(1, min(h, _MAX_GROUP) + 1)
                if h % g == 0 and (g == 1 or _stage_bytes(
                    bs, g, hd, esize, quantized) <= _MAX_STAGE_BYTES))
    stage = _stage_bytes(bs, group, hd, esize, quantized)
    stages = min(4, max(2, _RING_BYTES // stage))
    per_sm = 2 if 2 * stages * stage <= (224 << 10) else 1
    blocks = b * splits * (h // group)
    parts = min(bps, max(num_sms * per_sm // blocks, 1,
                         -(-bps // _MAX_ENTRIES)))
    entries = -(-bps // parts)
    parts = -(-bps // entries)
    return group, parts, entries, min(stages, entries)


def _scratch(b: int, nparts: int, h: int, hd: int, device):
    """The partials ``(acc [B, NP, H, hd], m [B, NP, H], l [B, NP, H])``,
    f32 views of one allocation."""
    n = b * nparts * h
    buf = torch.empty(n * (hd + 2), dtype=torch.float32, device=device)
    return (buf[:n * hd].view(b, nparts, h, hd),
            buf[n * hd:n * (hd + 1)].view(b, nparts, h),
            buf[n * (hd + 1):].view(b, nparts, h))


# the hopper form's tickets: int32 zeros per (device, stream), grown on
# demand; each launch leaves them zero again.  A buffer outgrown is kept,
# never freed: a captured graph may hold its address
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
_retired_tickets: List[torch.Tensor] = []
_num_sms: Dict[int, int] = {}


def _ticket_buffer(device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        if t is not None:
            _retired_tickets.append(t)
        t = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=device)
    return t


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


def _note_decode(q, k_pool, v_pool, tables, lengths, quantized) -> None:
    """The program auditor's note of one launch: the pools' payloads (the
    paged KV read, ``kv_elems`` elements each: batch x table width x
    block size x heads x head_dim, from shapes alone) and the scales."""
    kp = k_pool.payload if quantized else k_pool
    vp = v_pool.payload if quantized else v_pool
    b, h, hd = q.shape
    reads = [q, kp, vp, tables, lengths]
    if quantized:
        reads += [k_pool.scale, v_pool.scale]
    _program.note_kernel("flash_decode", reads=reads, quantized=quantized,
                         kv_elems=b * tables.shape[1] * kp.shape[1] * h * hd)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    if not getattr(lib, "_mxt_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mxt_flash_decode.argtypes = [
            vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float,
            vp]
        lib.mxt_flash_decode.restype = ci
        lib.mxt_error_string.argtypes = [ci]
        lib.mxt_error_string.restype = ctypes.c_char_p
        lib._mxt_typed = True
    return lib


@_program.kernel_region
def flash_decode_attention(q, k_pool, v_pool, tables, lengths, *,
                           scale: Optional[float] = None,
                           split_k: Optional[int] = None,
                           form: Optional[str] = None):
    """Paged decode attention: ``q`` [B, H, hd] (float32 or bfloat16);
    one layer's pools, [NB, BS, H, hd] float32 or bfloat16 tensors or
    :class:`~.kvcache.QuantPool` pairs (e4m3 payload, [NB, BS] f32
    scales); ``tables`` [B, max_blocks] int32; ``lengths`` [B] int32.
    Returns [B, H, hd] in ``q.dtype``.  ``form`` forces a kernel form
    (default: :func:`kernel_form`'s choice); a form the operands do not
    allow raises.

    CPU tensors go to :func:`flash_decode_attention_ref` (the form is only
    validated).  CUDA tensors launch the kernel in its form (and count
    the launch) or raise.
    """
    quantized = _check(q, k_pool, v_pool, tables, lengths)
    form = _resolve_form(form, k_pool, v_pool)
    _note_decode(q, k_pool, v_pool, tables, lengths, quantized)
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
    if hd > MAX_HEAD_DIM:
        raise MXNetError(f"flash_decode: head_dim {hd} > {MAX_HEAD_DIM}")
    lib = _lib()
    scale_ = (1.0 / np.sqrt(hd)) if scale is None else scale
    splits, bps = split_plan(nblk, split_k)
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    group = parts = entries = stages = 1
    tickets = None
    if form == "hopper":
        if dev.index not in _num_sms:
            _num_sms[dev.index] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        group, parts, entries, stages = hopper_plan(
            b, h, hd, bs, kp.element_size(), quantized, splits, bps,
            _num_sms[dev.index])
        tickets = _ticket_buffer(dev, stream, b * (h // group)).data_ptr()
    acc, m, l = _scratch(b, splits * parts, h, hd, dev)
    out = torch.empty_like(q)
    scales = ((k_pool.scale.data_ptr(), v_pool.scale.data_ptr())
              if quantized else (None, None))
    args = (q.data_ptr(), _DTYPE_CODES[q.dtype], kp.data_ptr(),
            vp.data_ptr(), _KV_CODES[kp.dtype], *scales, tables.data_ptr(),
            lengths.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            out.data_ptr(), tickets, b, h, hd, bs, nblk, splits, bps,
            _FORM_CODES[form], group, parts, entries, stages, float(scale_),
            stream)
    if dev.index == torch.cuda.current_device():
        rc = lib.mxt_flash_decode(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.mxt_flash_decode(*args)
    if rc != 0:
        raise MXNetError(f"flash_decode kernel launch failed ({form} form): "
                         f"CUDA error {rc} "
                         f"({lib.mxt_error_string(rc).decode()})")
    if quantized:
        flash_decode_attention.launches_fp8 += 1
    else:
        flash_decode_attention.launches += 1
    flash_decode_attention.launches_by_form[form] += 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention.launches_fp8 = 0
flash_decode_attention.launches_by_form = dict.fromkeys(_FORM_CODES, 0)
