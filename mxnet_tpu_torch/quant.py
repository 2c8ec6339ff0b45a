"""fp8 quantization: the paged KV cache's rowwise scales and the
block-scaled fp8 matmul of the fp8 linears.

Counterpart of ``mxnet_tpu/quant.py``; the port keeps its own copy so
that it never imports the JAX package.

:func:`rowwise_quantize` (one f32 scale per leading-axis row, the KV
pools' layout) and :func:`block_quantize` (one f32 scale per (row,
contraction block)) keep the JAX package's order of operations: widen to
f32, take the absmax, clamp it at 1e-30, divide by the format's maximum,
divide the values by their scale, cast.  Payloads and scales equal the
JAX package's bit for bit.  Every division divides by a tensor on the
input's device: CUDA turns a division by a host scalar into a product
with its reciprocal, which can move the last bit.

:func:`fp8_dot` is ``a @ b.T`` with both operands block-quantized on the
contraction axis; each block's partial product is rescaled by the two
operands' scales and the partials are summed in f32.  The JAX package
leaves that product to XLA's ``dot_general`` on fp8 payloads; here
:func:`block_dot` sends each block to cuBLAS's fp8 GEMM through
``torch._scaled_mm`` (unit tensorwise scales, f32 output, no fast
accumulation; the block scales are applied afterwards in f32, as in
JAX: rowwise cuBLAS scales would round each partial to bf16).  cuBLAS
wants the second operand column-major and every dimension a multiple of
16, so the payloads are padded with zeros; it has no e5m2 x e5m2 GEMM,
which only the backward-only policy asks for: that pair takes the
``"upcast"`` route, an f32 contraction of the upcast payloads with TF32
off -- what the JAX package itself does on a backend without an fp8 dot.
The formats choose the route, never a caught error, and
``block_dot.launches_by_route`` counts each block's product by route.
Hopper's tensor cores sum fp8 products in an accumulator of about 14
bits, not in f32 (measured on an H100: up to 1.6 x 2^-14 of the terms'
magnitude against the f32 plain version), so the GEMM route agrees with
the plain one to that, not to f32's summation order.
The partials are accumulated block by block: the weight gradient
contracts over every token of a batch, and its ``[blocks, M, N]``
partials would not fit beside the model.

On CPU tensors :func:`block_dot_ref` runs instead (upcast payloads,
``torch.matmul`` per block); on the card it is the plain version the
GEMM route is held against.

:class:`QuantConfig` and :func:`fp8_linear` are the JAX package's fp8
policy (e4m3 forward, e5m2 gradients, block 128) and its linear layer: a
``torch.autograd.Function`` with the same three policies (both
directions, forward only, backward only).  Master weights stay f32.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["QuantConfig", "resolve_quant", "default_block_size",
           "block_quantize", "rowwise_quantize", "block_dot",
           "block_dot_ref", "block_dot_route", "fp8_dot", "fp8_linear",
           "FP8_MAX", "FP8_DTYPES", "WIRE_ITEMSIZE", "wire_itemsize",
           "error_feedback_default", "symbol_uses_fp8"]

#: largest finite magnitude of each fp8 format
FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}

#: fp8 format -> torch dtype
FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}

#: bytes per element on the wire for each gradient compression format
#: (None = native f32); their use comes with the multi-GPU collectives
WIRE_ITEMSIZE = {None: 4, "bf16": 2, "int8": 1, "fp8": 1}

_GEMM_ALIGN = 16   # cuBLAS fp8: M, N and K multiples of 16


def wire_itemsize(compression: Optional[str], itemsize: int = 4) -> int:
    """Bytes per element on the wire for a gradient bucket."""
    if compression is None:
        return itemsize
    try:
        return WIRE_ITEMSIZE[compression]
    except KeyError:
        raise MXNetError(f"unknown compression {compression!r}")


def _env_flag(name: str, default: Optional[bool]) -> Optional[bool]:
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "off", "false", "no")


def default_block_size() -> int:
    """Contraction-axis block size for fp8/int8 block scales
    (``MXNET_TPU_QUANT_BLOCK``, default 128)."""
    raw = os.environ.get("MXNET_TPU_QUANT_BLOCK", "").strip()
    if not raw:
        return 128
    try:
        block = int(raw)
        if block <= 0:
            raise ValueError
    except ValueError:
        raise MXNetError(
            f"MXNET_TPU_QUANT_BLOCK={raw!r}: expected a positive integer")
    return block


def error_feedback_default(compression: Optional[str]) -> bool:
    """Whether error feedback defaults on for a gradient compression
    format (``MXNET_TPU_QUANT_EF`` overrides): on for the lossy int8 and
    fp8, off for exact f32."""
    if compression is None:
        return False
    env = _env_flag("MXNET_TPU_QUANT_EF", None)
    if env is not None:
        return env
    return compression in ("int8", "fp8")


@dataclass(frozen=True)
class QuantConfig:
    """Low-precision compute policy: ``fwd``/``bwd`` name the fp8 formats
    ("e4m3"/"e5m2") of the forward operands and of the gradients, or None
    to leave that direction in f32; ``block`` is the contraction block."""
    fwd: Optional[str] = "e4m3"
    bwd: Optional[str] = "e5m2"
    block: int = 128

    def __post_init__(self):
        for field, v in (("fwd", self.fwd), ("bwd", self.bwd)):
            if v is not None and v not in FP8_MAX:
                raise MXNetError(
                    f"QuantConfig.{field}={v!r}: expected one of "
                    f"{sorted(FP8_MAX)} or None")
        if self.block <= 0:
            raise MXNetError("QuantConfig.block must be positive")

    @property
    def enabled(self) -> bool:
        return self.fwd is not None or self.bwd is not None

    def describe(self) -> str:
        return f"fp8:{self.fwd}:{self.bwd}:b{self.block}"


def resolve_quant(quant) -> Optional[QuantConfig]:
    """A user's quant spec as a :class:`QuantConfig` (or None): None reads
    ``MXNET_TPU_QUANT``; True, "fp8" or a config."""
    if quant is None:
        if not _env_flag("MXNET_TPU_QUANT", None):
            return None
        quant = True
    if isinstance(quant, QuantConfig):
        return quant if quant.enabled else None
    if quant is False:
        return None
    if quant is True or quant == "fp8":
        return QuantConfig(block=default_block_size())
    raise MXNetError(f"unknown quant spec {quant!r}: expected None, bool, "
                     "'fp8', or a QuantConfig")


# ---------------------------------------------------------------------------
# Scales
# ---------------------------------------------------------------------------

def _scale_of(absmax: torch.Tensor, fmt: str) -> torch.Tensor:
    # the constants are fills on the input's device: ``torch.tensor``
    # would copy them from the host and wait for the card
    f32 = dict(dtype=torch.float32, device=absmax.device)
    return (torch.maximum(absmax, torch.full((), 1e-30, **f32))
            / torch.full((), FP8_MAX[fmt], **f32))


def rowwise_quantize(x: torch.Tensor, fmt: str):
    """Quantize ``[rows, ...]`` to fp8 with one f32 scale per row:
    returns ``(q, scale [rows])`` with ``q * scale ~= x`` rowwise.  The
    row absmax lands on the format's largest finite value, so the cast
    never overflows.  A row is one cached token position in the KV pools:
    its H x head_dim states share a scale."""
    if fmt not in FP8_DTYPES:
        raise MXNetError(f"rowwise_quantize: unknown fp8 format {fmt!r}, "
                         f"expected one of {sorted(FP8_DTYPES)}")
    x32 = x.float()
    absmax = (x32.abs().amax(dim=tuple(range(1, x32.dim())))
              if x32.dim() > 1 else x32.abs())
    scale = _scale_of(absmax, fmt)
    q = x32 / scale.reshape(scale.shape + (1,) * (x32.dim() - 1))
    return q.to(FP8_DTYPES[fmt]), scale


def block_quantize(x2d: torch.Tensor, fmt: str, block: int):
    """Quantize ``[rows, K]`` to fp8 with one f32 scale per (row,
    K-block): returns ``(q [nb, rows, block], scale [nb, rows, 1])``,
    ``K`` zero-padded up to ``nb * block``.  The block absmax lands on the
    format's largest finite value."""
    if fmt not in FP8_DTYPES:
        raise MXNetError(f"block_quantize: unknown fp8 format {fmt!r}, "
                         f"expected one of {sorted(FP8_DTYPES)}")
    rows, k = x2d.shape
    nb = -(-k // block)
    x32 = x2d.float()
    if nb * block != k:
        x32 = torch.nn.functional.pad(x32, (0, nb * block - k))
    xb = x32.reshape(rows, nb, block).transpose(0, 1).contiguous()
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = _scale_of(absmax, fmt)
    return (xb / scale).to(FP8_DTYPES[fmt]), scale


# ---------------------------------------------------------------------------
# The block product
# ---------------------------------------------------------------------------

def _fmt_of(q: torch.Tensor) -> str:
    for fmt, dt in FP8_DTYPES.items():
        if q.dtype == dt:
            return fmt
    raise MXNetError(f"block_dot: {q.dtype} is not an fp8 payload")


def block_dot_route(qa: torch.Tensor, qb: torch.Tensor) -> str:
    """The route of :func:`block_dot` for these payloads: ``"plain"`` on
    the CPU; on the card ``"fp8"`` (cuBLAS's fp8 GEMM) unless both are
    e5m2, which cuBLAS has no GEMM for: ``"upcast"``."""
    if qa.device.type != "cuda":
        return "plain"
    if (_fmt_of(qa), _fmt_of(qb)) == ("e5m2", "e5m2"):
        return "upcast"
    return "fp8"


def _check_operands(qa, sa, qb, sb):
    if qa.dim() != 3 or qb.dim() != 3 or qa.shape[0] != qb.shape[0] \
            or qa.shape[2] != qb.shape[2]:
        raise MXNetError(f"block_dot: payloads {tuple(qa.shape)} and "
                         f"{tuple(qb.shape)} are not [nb, M, B] x "
                         "[nb, N, B]")
    if sa.shape != qa.shape[:2] + (1,) or sb.shape != qb.shape[:2] + (1,):
        raise MXNetError("block_dot: scales must be [nb, rows, 1]")
    if len({t.device for t in (qa, sa, qb, sb)}) != 1:
        raise MXNetError("block_dot: operands on different devices")


def block_dot_ref(qa, sa, qb, sb) -> torch.Tensor:
    """The plain block product: ``sum_kb (qa[kb] @ qb[kb].T) * sa[kb] *
    sb[kb].T`` on the payloads upcast to f32, accumulated block by
    block."""
    _check_operands(qa, sa, qb, sb)
    out = None
    for kb in range(qa.shape[0]):
        part = torch.matmul(qa[kb].float(), qb[kb].float().t())
        part = part * sa[kb] * sb[kb].t()
        out = part if out is None else out + part
    return out


def _pad_rows(q: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """``q [nb, r, B]`` zero-padded to ``[nb, rows, width]`` (through a
    byte view: the fp8 payload's zero is the zero byte)."""
    nb, r, b = q.shape
    if (r, b) == (rows, width):
        return q
    out = torch.zeros((nb, rows, width), dtype=torch.uint8, device=q.device)
    out[:, :r, :b] = q.view(torch.uint8)
    return out.view(q.dtype)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def block_dot(qa, sa, qb, sb) -> torch.Tensor:
    """Block-scaled product of fp8 payloads ``qa [nb, M, B]``, ``qb [nb,
    N, B]`` with scales ``[nb, rows, 1]``: ``[M, N]`` f32.  CPU tensors
    take :func:`block_dot_ref`; on the card each block goes to cuBLAS's
    fp8 GEMM (or, for e5m2 x e5m2, an f32 product with TF32 off), one
    count in ``block_dot.launches_by_route`` per block."""
    route = block_dot_route(qa, qb)
    if route == "plain":
        return block_dot_ref(qa, sa, qb, sb)
    if route == "upcast":
        # the plain product, exact in f32 whatever precision the caller
        # runs under
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            out = block_dot_ref(qa, sa, qb, sb)
        finally:
            torch.set_float32_matmul_precision(prev)
        block_dot.launches_by_route["upcast"] += qa.shape[0]
        return out
    _check_operands(qa, sa, qb, sb)
    nb, m, b = qa.shape
    n = qb.shape[1]
    out = torch.zeros((m, n), dtype=torch.float32, device=qa.device)
    mp, np_, bp = (_round_up(m, _GEMM_ALIGN), _round_up(n, _GEMM_ALIGN),
                   _round_up(b, _GEMM_ALIGN))
    pa, pb = _pad_rows(qa, mp, bp), _pad_rows(qb, np_, bp)
    one = torch.ones((), dtype=torch.float32, device=qa.device)
    sbt = sb.transpose(1, 2)
    for kb in range(nb):
        # qb[kb] is [N, B] row-major, so its transpose is the
        # column-major [B, N] operand cuBLAS wants
        part = torch._scaled_mm(pa[kb], pb[kb].t(), scale_a=one,
                                scale_b=one, out_dtype=torch.float32,
                                use_fast_accum=False)
        block_dot.launches_by_route["fp8"] += 1
        out.add_(part[:m, :n].mul_(sa[kb]).mul_(sbt[kb]))
    return out


block_dot.launches_by_route = {"fp8": 0, "upcast": 0}


def fp8_dot(a: torch.Tensor, b: torch.Tensor, fmt_a: str, fmt_b: str,
            block: int) -> torch.Tensor:
    """Block-scaled quantized ``a @ b.T``: ``[M, K] x [N, K] -> [M, N]``
    f32.  Both operands are quantized here (the lossy step)."""
    qa, sa = block_quantize(a, fmt_a, block)
    qb, sb = block_quantize(b, fmt_b, block)
    return block_dot(qa, sa, qb, sb)


# ---------------------------------------------------------------------------
# fp8 linear: e4m3 forward / e5m2 backward, f32 master weights
# ---------------------------------------------------------------------------

class _FP8Linear(torch.autograd.Function):
    """``x @ w.T`` under an fp8 policy (the JAX package's ``custom_vjp``
    ``_fp8_linear``): the forward product on ``fwd`` payloads (exact f32
    when ``fwd`` is None), the backward's on ``bwd`` gradients against
    ``fwd or bwd`` operands (exact f32 when ``bwd`` is None)."""

    @staticmethod
    def forward(ctx, x, w, fwd, bwd, block):
        ctx.save_for_backward(x, w)
        ctx.policy = (fwd, bwd, block)
        if fwd is None:
            return x.float() @ w.float().t()
        return fp8_dot(x, w, fwd, fwd, block)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        fwd, bwd, block = ctx.policy
        if bwd is None:
            g32 = g.float()
            dx = g32 @ w.float()
            dw = g32.t() @ x.float()
        else:
            wfmt = fwd or bwd
            # dx[n, k] = sum_h g[n, h] w[h, k]: contract H
            dx = fp8_dot(g, w.t(), bwd, wfmt, block)
            # dw[h, k] = sum_n g[n, h] x[n, k]: contract the tokens
            dw = fp8_dot(g.t(), x.t(), bwd, wfmt, block)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def fp8_linear(x: torch.Tensor, w: torch.Tensor,
               cfg: QuantConfig) -> torch.Tensor:
    """``x @ w.T`` (f32) through the fp8 policy ``cfg``: activations and
    weights cast to ``cfg.fwd`` on the forward edge, the incoming gradient
    to ``cfg.bwd`` on the backward edge, block scales on the contraction
    axis, f32 accumulation.  ``w`` is the master weight; it is never
    stored in fp8."""
    return _FP8Linear.apply(x, w, cfg.fwd, cfg.bwd, cfg.block)


def symbol_uses_fp8(sym) -> bool:
    """True when an op of the symbol's graph asks for the fp8 matmul path
    (the trainer then turns on dynamic loss scaling by default)."""
    try:
        nodes = sym._topo()
    except Exception:
        return False
    return any(not node.is_variable
               and str(node.attrs.get("quant", "")) == "fp8"
               for node in nodes)
