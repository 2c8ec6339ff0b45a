"""Flash attention: kernels K3 (forward) and K4 (backward) with their
plain versions, and the JAX package's dispatch around them.

Counterpart of ``mxnet_tpu/parallel/flash_attention.py``.  The TPU module
runs one ``pallas_call`` for the forward (``_flash_fwd_pallas``) and two
for the backward (``_dq_kernel``, ``_dkv_kernel``), joined by a
``custom_vjp``.  Here:

* :func:`flash_fwd` (K3, ``csrc/flash_attn_fwd.cu``) returns ``(out,
  lse)``: the attention output in the input type and the f32 row
  logsumexp;
* :func:`flash_bwd` (K4, ``csrc/flash_attn_bwd.cu``) returns ``(dq, dk,
  dv)`` from the saved ``lse`` and ``delta = rowsum(do * out)`` (f32), or
  from an external ``delta``; one call launches the dq kernel and the
  dk/dv kernel;
* :class:`_FlashAttnFn` is the ``torch.autograd.Function`` whose forward
  runs K3 and saves ``(q, k, v, out, lse)`` and whose backward runs K4.

Each kernel has two forms, chosen in C by type and head dim: bf16 with
``D <= 128`` (the LM's case) runs its products on the tensor cores
(``mma.sync``), f32 (which must stay f32-exact) and bf16 with ``D > 128``
on the f32 FMA units; both round at the same points.  Both wrappers take
CUDA tensors to the kernel (counting the launch in
``flash_fwd.launches`` / ``flash_bwd.launches``) or raise; CPU tensors go
to the plain versions :func:`flash_fwd_ref` / :func:`flash_bwd_ref`,
which repeat the kernels' arithmetic: f32 scores scaled after the dot,
``NEG_INF`` masking with ``p`` zeroed after the ``exp``, ``p`` rounded
to ``v``'s type before ``p @ v``, ``ds`` to ``k``'s/``q``'s type and
``p`` to ``do``'s type before the gradient products, ``l`` clamped at
1e-30, ``lse = m + log(l)``, f32 accumulation throughout.  The forward's
online softmax walks key tiles of :func:`kernel_tile` positions, the
kernel's own tile, so the bf16 rounding of ``p`` happens against the
same running maxima.

Both layouts are read in place: ``"bhld"`` is ``[B, H, L, D]`` and
``"blhd"`` is ``[B, L, H, D]`` (what the transformer's projections
produce); the kernels compute their own offsets, so nothing is
transposed.  ``lse`` and ``delta`` are ``[B, H, Lq]`` f32 either way.

The public functions keep the JAX dispatch: the ``kernel_ok`` conditions
(block picks that divide the lengths and are at least 64, causal only for
``Lq == Lk``, ``D <= 256``, f32/bf16 of one type) decide which shapes take
the flash family; the others take the blockwise or dense path of
``ring_attention`` exactly as the reference does.  The port has no mesh
yet (``parallel.mesh`` raises), so ``_wrap_for_mesh`` has no counterpart.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["NEG_INF", "AUTO_SWITCH_LEN", "flash_attention",
           "flash_attention_stats", "flash_attention_block_bwd",
           "flash_fwd", "flash_fwd_ref", "flash_bwd", "flash_bwd_ref",
           "kernel_tile"]

NEG_INF = -1e30

# sequence length at/above which the RingAttention op switches from dense
# to the flash path (the JAX package's value)
AUTO_SWITCH_LEN = 1024

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _pick_block(length: int, preferred: int = 512) -> Optional[int]:
    for b in (preferred, 512, 256, 128, 64):
        if b <= preferred and length % b == 0 and b <= length:
            return b
    return None


def _pick_blocks(lq: int, lk: int):
    """Default ``(block_q, block_k)`` of the JAX package.  Here they only
    decide ``kernel_ok``: the CUDA kernels use their own tiles."""
    bq = _pick_block(lq, preferred=256 if lq <= 1024 else 512)
    bk = _pick_block(lk, preferred=1024)
    return bq, bk


def _kernel_ok(q, k, v, bq, bk, lq, lk, d, causal) -> bool:
    return (bq is not None and bk is not None
            # causal masking assumes aligned q/k positions
            and (lq == lk or not causal)
            and lq % bq == 0 and lk % bk == 0
            and bq >= 64 and bk >= 64
            and d <= MAX_HEAD_DIM
            and q.dtype in _DTYPE_CODES
            and q.dtype == k.dtype == v.dtype)


def kernel_tile(d: int) -> int:
    """Query and key tile of the kernels for head dim ``d``: 64 rows up
    to ``d = 128``, 32 beyond (shared memory holds the tiles in f32)."""
    return 64 if d <= 128 else 32


def _dims(q, k, blhd: bool):
    if blhd:
        b, lq, h, d = q.shape
        return b, h, lq, k.shape[1], d
    b, h, lq, d = q.shape
    return b, h, lq, k.shape[2], d


def _to_bhld(t, blhd: bool):
    return t.transpose(1, 2) if blhd else t


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash_fwd_ref(q, k, v, *, causal: bool, scale: float,
                  layout: str = "bhld") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: ``(out, lse)`` with ``out`` in the
    input type and layout, ``lse`` ``[B, H, Lq]`` f32."""
    blhd = layout == "blhd"
    qf, kf, vf = (_to_bhld(t, blhd).float() for t in (q, k, v))
    b, h, lq, d = qf.shape
    lk = kf.shape[2]
    dev = q.device
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=dev)
    qpos = torch.arange(lq, device=dev)
    tile = kernel_tile(d)
    for k0 in range(0, lk, tile):
        kb, vb = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        mask = None
        if causal:
            kpos = k0 + torch.arange(kb.shape[2], device=dev)
            mask = qpos[:, None] >= kpos[None, :]
            s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).float(), vb)
        acc = acc * alpha[..., None] + pv
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    return _to_bhld(out, blhd), m + torch.log(l)


def _delta(do, out, blhd: bool):
    """``rowsum(do * out)`` in f32, ``[B, H, Lq]``."""
    return _to_bhld((do.float() * out.float()).sum(dim=-1, keepdim=True),
                    blhd)[..., 0]


def flash_bwd_ref(q, k, v, out, lse, do, *, causal: bool, scale: float,
                  layout: str = "bhld", delta=None):
    """Plain PyTorch version of K4: ``(dq, dk, dv)`` in the input types
    and layout, from ``lse`` and ``delta`` (``[B, H, Lq]`` f32; ``delta``
    defaults to ``rowsum(do * out)``)."""
    blhd = layout == "blhd"
    if delta is None:
        delta = _delta(do, out, blhd)
    qf, kf, vf, dof = (_to_bhld(t, blhd).float() for t in (q, k, v, do))
    lq, d = qf.shape[2], qf.shape[3]
    lk = kf.shape[2]
    dev = q.device
    lse, delta = lse.float(), delta.float()
    qpos = torch.arange(lq, device=dev)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    tile = kernel_tile(d)
    for k0 in range(0, lk, tile):
        kb, vb = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        mask = None
        if causal:
            kpos = k0 + torch.arange(kb.shape[2], device=dev)
            mask = qpos[:, None] >= kpos[None, :]
            s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - lse[..., None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        dvs.append(torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                                dof))
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = p * (dp - delta[..., None])
        dq = dq + torch.matmul(ds.to(k.dtype).float(), kb)
        dks.append(torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                                qf))
    dk = torch.cat(dks, dim=2) * scale
    dv = torch.cat(dvs, dim=2)
    dq = dq * scale
    return (_to_bhld(dq.to(q.dtype), blhd), _to_bhld(dk.to(k.dtype), blhd),
            _to_bhld(dv.to(v.dtype), blhd))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib(name: str, fn: str, n_ptrs: int) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with ``fn``'s argument types set:
    ``n_ptrs`` pointers, then dtype, B, H, Lq, Lk, D, blhd, causal
    (ints), scale (float) and the stream."""
    lib = _build.load(name)
    if not getattr(lib, "_mxt_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f = getattr(lib, fn)
        f.argtypes = [vp] * n_ptrs + [ci] * 8 + [ctypes.c_float, vp]
        f.restype = ci
        lib.mxt_error_string.argtypes = [ci]
        lib.mxt_error_string.restype = ctypes.c_char_p
        lib._mxt_typed = True
    return lib


def _check_operands(what, tensors, q, k, layout):
    if layout not in ("bhld", "blhd"):
        raise MXNetError(f"{what}: unknown layout {layout!r}")
    if q.dim() != 4 or k.dim() != 4:
        raise MXNetError(f"{what}: q and k must be 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise MXNetError(f"{what}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    blhd = layout == "blhd"
    b, h, lq, lk, d = _dims(q, k, blhd)
    kshape = (b, lk, h, d) if blhd else (b, h, lk, d)
    if tuple(k.shape) != kshape:
        raise MXNetError(f"{what}: k has shape {tuple(k.shape)}, expected "
                         f"{kshape}")
    if d > MAX_HEAD_DIM:
        raise MXNetError(f"{what}: head_dim {d} > {MAX_HEAD_DIM}")
    dev = q.device
    for name, t, shape, dtype in tensors:
        if t.device != dev:
            raise MXNetError(f"{what}: {name} is on {t.device}, q on {dev}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise MXNetError(f"{what}: {name} must be {dtype}"
                             f"{tuple(shape)}, got {t.dtype}"
                             f"{tuple(t.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise MXNetError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous()
                                      for _, t, _, _ in tensors):
        raise MXNetError(f"{what}: operands must be contiguous")
    return blhd, (b, h, lq, lk, d)


def _launch(lib, fn, what, ptrs, dtype, dims, blhd, causal, scale, dev):
    b, h, lq, lk, d = dims
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(
            *ptrs, _DTYPE_CODES[dtype], b, h, lq, lk, d, int(blhd),
            int(bool(causal)), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise MXNetError(f"{what} kernel launch failed: CUDA error {rc} "
                         f"({lib.mxt_error_string(rc).decode()})")


def flash_fwd(q, k, v, *, causal: bool, scale: float,
              layout: str = "bhld") -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward ``(out, lse)`` (K3).  CPU tensors go to
    :func:`flash_fwd_ref`; CUDA tensors launch the kernel of
    ``csrc/flash_attn_fwd.cu`` (and count the launch) or raise."""
    blhd, dims = _check_operands(
        "flash_fwd", [("q", q, q.shape, q.dtype),
                      ("k", k, k.shape, q.dtype),
                      ("v", v, k.shape, q.dtype)], q, k, layout)
    if causal and dims[2] != dims[3]:
        raise MXNetError("flash_fwd: causal attention needs Lq == Lk")
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, scale=scale,
                             layout=layout)
    b, h, lq, _, _ = dims
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = _lib("flash_attn_fwd", "mxt_flash_attn_fwd", 5)
    _launch(lib, "mxt_flash_attn_fwd", "flash_fwd",
            [t.data_ptr() for t in (q, k, v, out, lse)], q.dtype, dims,
            blhd, causal, scale, q.device)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd(q, k, v, out, lse, do, *, causal: bool, scale: float,
              layout: str = "bhld", delta=None):
    """Attention backward ``(dq, dk, dv)`` (K4) from ``lse`` and
    ``delta`` (default ``rowsum(do * out)`` in f32).  CPU tensors go to
    :func:`flash_bwd_ref`; CUDA tensors launch the dq and dk/dv kernels
    of ``csrc/flash_attn_bwd.cu`` in one call (counted once) or raise."""
    b, h = q.shape[0], (q.shape[2] if layout == "blhd" else q.shape[1])
    lq = q.shape[1] if layout == "blhd" else q.shape[2]
    rows = [("lse", lse, (b, h, lq), torch.float32)]
    if delta is not None:
        rows.append(("delta", delta, (b, h, lq), torch.float32))
    blhd, dims = _check_operands(
        "flash_bwd", [("q", q, q.shape, q.dtype),
                      ("k", k, k.shape, q.dtype),
                      ("v", v, k.shape, q.dtype),
                      ("out", out, q.shape, q.dtype),
                      ("do", do, q.shape, q.dtype)] + rows, q, k, layout)
    if causal and dims[2] != dims[3]:
        raise MXNetError("flash_bwd: causal attention needs Lq == Lk")
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, out, lse, do, causal=causal,
                             scale=scale, layout=layout, delta=delta)
    if delta is None:
        delta = _delta(do, out, blhd).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = _lib("flash_attn_bwd", "mxt_flash_attn_bwd", 9)
    _launch(lib, "mxt_flash_attn_bwd", "flash_bwd",
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dq, dk, dv)],
            q.dtype, dims, blhd, causal, scale, q.device)
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


class _FlashAttnFn(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX module: forward K3, saving ``(q, k,
    v, out, lse)``; backward K4."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, layout):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale,
                             layout=layout)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, scale, layout)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, layout = ctx.cfg
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(),
                               causal=causal, scale=scale, layout=layout)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# Public functions (the JAX dispatch)
# ---------------------------------------------------------------------------

def _scale_of(scale, d) -> float:
    return float(1.0 / (d ** 0.5)) if scale is None else float(scale)


def flash_attention(q, k, v, *, causal=False, scale=None, block_q=None,
                    block_k=None, layout="bhld"):
    """Exact attention with O(L * tile) memory.  Shapes that ``kernel_ok``
    admits run K3 forward and K4 backward (their plain versions on CPU
    tensors); the others take the blockwise path when ``block_k`` (given
    or picked) divides the key length, else the dense one.

    ``layout``: ``"bhld"`` takes ``[B, H, L, D]``, ``"blhd"`` takes
    ``[B, L, H, D]``; the output has the input's layout.
    """
    from .ring_attention import blockwise_attention, local_attention

    blhd = layout == "blhd"
    b, h, lq, lk, d = _dims(q, k, blhd)
    scale_f = _scale_of(scale, d)
    auto_bq, auto_bk = _pick_blocks(lq, lk)
    bq = block_q or auto_bq
    bk = block_k or auto_bk
    if not _kernel_ok(q, k, v, bq, bk, lq, lk, d, causal):
        qt, kt, vt = (_to_bhld(t, blhd) for t in (q, k, v))
        if bk is not None and lk % bk == 0:
            out = blockwise_attention(qt, kt, vt, bk, causal=causal,
                                      scale=scale_f)
        else:
            # no valid block divisor: dense reference (never crashes)
            out = local_attention(qt, kt, vt, causal=causal, scale=scale_f)
        return _to_bhld(out, blhd)
    return _FlashAttnFn.apply(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal, scale_f, layout)


def flash_attention_stats(q, k, v, *, causal=False, scale=None):
    """Attention with row statistics on ``[B, H, L, D]``: ``(out, lse
    [B, H, L] f32)``, the mergeable form ring attention combines.  K3 for
    shapes ``kernel_ok`` admits, the blockwise path otherwise."""
    from .ring_attention import blockwise_attention

    b, h, lq, lk, d = _dims(q, k, False)
    scale_f = _scale_of(scale, d)
    bq, bk = _pick_blocks(lq, lk)
    if not _kernel_ok(q, k, v, bq, bk, lq, lk, d, causal):
        return blockwise_attention(q, k, v, bk or lk, causal=causal,
                                   scale=scale_f, return_stats=True)
    return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                     causal=causal, scale=scale_f)


def _block_bwd_ref(q, k, v, out, lse, do, causal, scale, block,
                   delta=None):
    """Twin of the JAX ``_block_bwd_jnp``: dq/dk/dv for one kv block
    under global row statistics, products in the input type as the
    reference's einsums give them."""
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    f32 = torch.float32
    nblk = max(1, lk // block)
    block = lk // nblk
    if delta is None:
        delta = (do.to(f32) * out.to(f32)).sum(dim=-1)
    qpos = torch.arange(lq, device=q.device)
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dks, dvs = [], []
    for i in range(nblk):
        k_b, v_b = (t[:, :, i * block:(i + 1) * block] for t in (k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k_b).to(f32) * scale
        mask = None
        if causal:
            kpos = i * block + torch.arange(block, device=q.device)
            mask = (qpos[:, None] >= kpos[None, :])[None, None]
            s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - lse[..., None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype), do))
        dp = torch.einsum("bhqd,bhkd->bhqk", do, v_b).to(f32)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype),
                               k_b) * scale
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype), q)
                   * scale)
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_block_bwd(q, k, v, out, lse, do, *, causal=False,
                              scale=None, delta=None):
    """Backward against one kv block under GLOBAL statistics: ``(dq, dk,
    dv)`` on ``[B, H, L, D]`` given the merged ``lse`` (and ``out``/``do``
    of the full attention, or an external ``delta``).  K4 for shapes
    ``kernel_ok`` admits, the plain block backward otherwise."""
    b, h, lq, lk, d = _dims(q, k, False)
    scale_f = _scale_of(scale, d)
    bq, bk = _pick_blocks(lq, lk)
    if not _kernel_ok(q, k, v, bq, bk, lq, lk, d, causal):
        return _block_bwd_ref(q, k, v, out, lse, do, causal, scale_f,
                              bk or lk, delta=delta)
    return flash_bwd(*(t.contiguous() for t in (q, k, v, out)),
                     lse.contiguous(), do.contiguous(), causal=causal,
                     scale=scale_f,
                     delta=None if delta is None else delta.contiguous())
