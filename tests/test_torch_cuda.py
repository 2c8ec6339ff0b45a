"""The port's CUDA kernels on the card (marker ``cuda``).

These tests import torch and the port only, so they also run where JAX is
not installed.  Run them on a machine with an NVIDIA H100 and nvcc::

    python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere they skip.  Each kernel is held against its plain PyTorch
version on the same CUDA tensors: flash decode (K5) f32 within atol 2e-5
(summation order), bf16 within 1e-2 (summation order and one bf16
rounding of the output); the row softmax (K1) f32 within atol 1e-6 (the
online rescale of the running sum), bf16 within 1e-2; the fused update
(K2) BITWISE, against its plain version and against the unfused
per-parameter update (``chip_smoke.k2_unfused``); flash attention forward
(K3) and backward (K4) with ``chip_smoke.K34_TOL``: f32 within 2e-5
(forward, lse) and 2e-4 (gradients), summation order; bf16 within 2e-2
of ``1 + |plain|`` (``p`` and ``ds`` are rounded to bf16 inside).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch import optimizer
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_update as tfu
from mxnet_tpu_torch.ops import nn_ops as tnn
from mxnet_tpu_torch.parallel import flash_attention as tfa
from mxnet_tpu_torch.serve import flash_decode as tfd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with `pytest -m cuda` on the "
                    "card")
    return torch.device("cuda")


def _operands(dev, seed, *, B, H, hd, BS, nblk, lengths, dtype,
              trash_rows=(), npool=96):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32))
    kp = torch.from_numpy(rng.randn(npool, BS, H, hd).astype(np.float32))
    vp = torch.from_numpy(rng.randn(npool, BS, H, hd).astype(np.float32))
    tables = np.zeros((B, nblk), np.int32)
    lens = np.asarray(lengths, np.int32).copy()
    for b in range(B):
        if b in trash_rows:
            lens[b] = 1
            continue
        used = -(-int(lens[b]) // BS)
        tables[b, :used] = rng.choice(np.arange(1, npool), used,
                                      replace=False)
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(tables).to(dev), torch.from_numpy(lens).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [8, 64, 100, 128, 256])
@pytest.mark.parametrize("split_k", [None, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda, hd, split_k, dtype):
    args = _operands(cuda, hd + (split_k or 0), B=5, H=3, hd=hd, BS=16,
                     nblk=20, lengths=[320, 1, 17, 200, 64], dtype=dtype,
                     trash_rows=(3,))
    before = tfd.flash_decode_attention.launches
    out = tfd.flash_decode_attention(*args, split_k=split_k)
    ref = tfd.flash_decode_attention_ref(*args, split_k=split_k)
    torch.cuda.synchronize()
    assert tfd.flash_decode_attention.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_flash_decode_kernel_rejects_wide_heads(cuda):
    args = _operands(cuda, 0, B=2, H=1, hd=512, BS=4, nblk=3,
                     lengths=[5, 9], dtype=torch.float32)
    with pytest.raises(MXNetError, match="head_dim"):
        tfd.flash_decode_attention(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 1000), (8, 10), (3, 16384),
                                   (37, 1001), (1, 1), (300, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_rows_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.RandomState(shape[1])
    x = (4.0 * rng.randn(*shape)).astype(np.float32)
    x[:, ::5] = -np.inf if shape[1] > 1 else x[:, ::5]
    t = torch.from_numpy(x).to(cuda, dtype)
    before = tnn.softmax_rows.launches
    out = tnn.softmax_rows(t)
    ref = tnn.softmax_rows_ref(t)
    torch.cuda.synchronize()
    assert tnn.softmax_rows.launches == before + 1
    assert out.dtype == dtype and out.shape == t.shape
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    rows = out.float().sum(dim=-1)
    assert (rows - 1).abs().max().item() <= (1e-5 if dtype == torch.float32
                                              else 2e-2)


@pytest.mark.cuda
def test_softmax_rows_kernel_rejects_non_contiguous(cuda):
    x = torch.randn(8, 20, device=cuda)[:, ::2]
    with pytest.raises(MXNetError, match="contiguous"):
        tnn.softmax_rows(x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(chip_smoke.K2_CASES)))
@pytest.mark.parametrize("n", [1, 255, 1003, (1 << 20) + 7])
def test_fused_update_kernel_is_bitwise_unfused(cuda, case, n):
    kind, use_wdvec, use_mult, ok_v, clip = chip_smoke.K2_CASES[case]
    chip_smoke.DEVICE = str(cuda)
    g, w, state, bounds, seg_wd = chip_smoke.k2_operands(
        torch, np, kind, max(n, 8), seed=case)
    g, w, state = g[:n], w[:n], [s[:n] for s in state]
    bounds = [(a, min(b, n)) for a, b in bounds if a < n]
    seg_wd = seg_wd[:len(bounds)]
    f32 = dict(dtype=torch.float32, device=cuda)
    lr = torch.full((), 0.1, **f32)
    t = torch.full((), 2.0, **f32)
    mult = torch.full((), 0.37, **f32) if use_mult else None
    ok = None if ok_v is None else torch.tensor(ok_v, device=cuda)
    wdvec = None
    if use_wdvec:
        wdvec = torch.empty(n, **f32)
        for (a, b), v in zip(bounds, seg_wd):
            wdvec[a:b] = v
    want = chip_smoke.k2_unfused(torch, optimizer, kind, g, w, state,
                                 bounds, seg_wd, lr, t, mult, ok, clip,
                                 use_wdvec, 1e-4, 1.0 / 64)
    scalars = chip_smoke.k2_kernel_args(torch, optimizer, kind, lr, t,
                                        use_wdvec, 1e-4)
    hyper = dict(momentum=0.9, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 wd=0.0 if use_wdvec else 1e-4, rescale_grad=1.0 / 64,
                 clip_gradient=clip)
    plain = tfu.reference_update(g, w, tuple(state), scalars, kind=kind,
                                 mult=mult, ok=ok, wd_vec=wdvec, **hyper)
    kw, ks = w.clone(), [s.clone() for s in state]
    before = tfu.fused_update.launches
    tfu.fused_update(g, kw, tuple(ks), scalars, kind=kind, mult=mult, ok=ok,
                     wd_vec=wdvec, **hyper)
    torch.cuda.synchronize()
    assert tfu.fused_update.launches == before + 1
    for got, a, b in zip([kw] + ks, want, plain):
        assert torch.equal(got.view(torch.int32), a.view(torch.int32))
        assert torch.equal(got.view(torch.int32), b.view(torch.int32))
    if ok_v is False:
        for got, old in zip([kw] + ks, [w] + state):
            assert torch.equal(got.view(torch.int32), old.view(torch.int32))


@pytest.mark.cuda
def test_fused_update_kernel_rejects_non_contiguous(cuda):
    g = torch.zeros(16, device=cuda)[::2]
    lr = torch.full((), 0.1, device=cuda)
    with pytest.raises(MXNetError, match="contiguous"):
        tfu.fused_update(g, torch.zeros(8, device=cuda), (), (lr,),
                         kind="sgd")


# (layout, B, H, Lq, Lk, D, causal, external delta)
K34_SHAPES = [
    ("blhd", 2, 4, 256, 256, 64, True, False),
    ("bhld", 1, 2, 192, 320, 32, False, False),
    ("blhd", 1, 2, 100, 100, 16, True, False),     # ragged tiles
    ("blhd", 1, 2, 128, 128, 256, True, False),
    ("bhld", 1, 1, 64, 64, 8, False, False),
    ("bhld", 2, 2, 256, 256, 100, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(K34_SHAPES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain(cuda, case, dtype):
    layout, B, H, Lq, Lk, D, causal, ext = K34_SHAPES[case]
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.DEVICE = str(cuda)
    q, k, v, do = chip_smoke.attn_operands(torch, np, 40 + case, layout, B,
                                           H, Lq, Lk, D, dtype)
    kw = dict(causal=causal, scale=1.0 / D ** 0.5, layout=layout)
    delta = (torch.randn(B, H, Lq, device=cuda) if ext else None)
    before = tfa.flash_fwd.launches, tfa.flash_bwd.launches
    out, lse = tfa.flash_fwd(q, k, v, **kw)
    grads = tfa.flash_bwd(q, k, v, out, lse, do, delta=delta, **kw)
    ref_out, ref_lse = tfa.flash_fwd_ref(q, k, v, **kw)
    ref_grads = tfa.flash_bwd_ref(q, k, v, out, lse, do, delta=delta, **kw)
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    f32 = dtype == torch.float32
    tol = chip_smoke.K34_TOL
    assert (lse - ref_lse).abs().max().item() <= (
        tol["fwd"] if f32 else tol["bf16_rel"])
    assert chip_smoke.attn_err(torch, out, ref_out, dtype) <= (
        tol["fwd"] if f32 else tol["bf16_rel"])
    for g, r in zip(grads, ref_grads):
        assert g.dtype == dtype and g.shape == r.shape
        assert chip_smoke.attn_err(torch, g, r, dtype) <= (
            tol["bwd"] if f32 else tol["bf16_rel"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_on_misaligned_operands(cuda, dtype):
    """Contiguous operands whose address is not 16-byte aligned take the
    element-wise tile loads."""
    B, H, L, D = 1, 2, 128, 64
    n = B * L * H * D
    base = [torch.randn(n + 1, device=cuda).to(dtype) for _ in range(4)]
    q, k, v, do = (t[1:].view(B, L, H, D) for t in base)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    kw = dict(causal=True, scale=0.125, layout="blhd")
    out, lse = tfa.flash_fwd(q, k, v, **kw)
    grads = tfa.flash_bwd(q, k, v, out, lse, do, **kw)
    ref_out, _ = tfa.flash_fwd_ref(q, k, v, **kw)
    ref_grads = tfa.flash_bwd_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    tol = chip_smoke.K34_TOL
    f32 = dtype == torch.float32
    assert chip_smoke.attn_err(torch, out, ref_out, dtype) <= (
        tol["fwd"] if f32 else tol["bf16_rel"])
    for g, r in zip(grads, ref_grads):
        assert chip_smoke.attn_err(torch, g, r, dtype) <= (
            tol["bwd"] if f32 else tol["bf16_rel"])


@pytest.mark.cuda
def test_flash_attention_autograd_runs_both_kernels(cuda):
    rng = np.random.RandomState(3)
    x = [rng.randn(2, 128, 2, 32).astype(np.float32) for _ in range(3)]
    on_card = [torch.from_numpy(a).to(cuda).requires_grad_() for a in x]
    on_cpu = [torch.from_numpy(a).requires_grad_() for a in x]
    before = tfa.flash_fwd.launches, tfa.flash_bwd.launches
    y = tfa.flash_attention(*on_card, causal=True, layout="blhd")
    (y * y).sum().backward()
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    yc = tfa.flash_attention(*on_cpu, causal=True, layout="blhd")
    (yc * yc).sum().backward()
    assert (y.detach().cpu() - yc.detach()).abs().max().item() <= 2e-5
    for a, b in zip(on_card, on_cpu):
        assert (a.grad.cpu() - b.grad).abs().max().item() <= 2e-4


@pytest.mark.cuda
def test_flash_attention_kernels_reject_non_contiguous(cuda):
    q = torch.randn(1, 64, 2, 16, device=cuda).transpose(1, 2)
    with pytest.raises(MXNetError, match="contiguous"):
        tfa.flash_fwd(q, q, q, causal=False, scale=0.25)
