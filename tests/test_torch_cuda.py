"""The port's CUDA kernels on the card (marker ``cuda``).

These tests import torch and the port only, so they also run where JAX is
not installed.  Run them on a machine with an NVIDIA H100 and nvcc::

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Elsewhere they skip.  Each kernel is held against its plain PyTorch
version on the same CUDA tensors: flash decode (K5) f32 within atol 2e-5
(summation order), bf16 within 1e-2 (summation order and one bf16
rounding of the output); its fp8 instance (K5-fp8) on pools quantized by
``quant.rowwise_quantize`` with the same tolerances by the type of ``q``
(the dequantized values are equal; only the summation order differs), and
the cast to e4m3 on the card equal to the CPU's byte for byte; both
decode forms ("hopper" and "warp") over the same cases and at edges
(8192 positions, wide heads, BS 32), the hopper form bitwise repeatable
and leaving its tickets zero; the row softmax (K1) in both forms ("warp"
and "block") f32 within atol 1e-6 (summation order), bf16 within 1e-2;
the fused update
(K2) BITWISE in both forms, against each other, its plain version and
the unfused per-parameter update (``chip_smoke.k2_unfused``), the hopper
form also over separate gradients at misaligned offsets and pointers
and past one pointer table; flash attention forward
(K3) and backward (K4) with ``chip_smoke.K34_TOL``: f32 within 2e-5
(forward, lse) and 2e-4 (gradients), summation order; bf16 within 2e-2
of ``1 + |plain|`` (``p`` and ``ds`` are rounded to bf16 inside); user
kernels compiled by ``rtc.CudaKernel`` (K6) with ``chip_smoke.RTC_TOL``;
speculative decoding at a small size: n-gram greedy streams equal the plain
engine's on f32 and fp8 pools with no flash-decode launch, and
``scrub_positions`` zeroes the rejected positions in both leaves, byte for
byte as on the CPU; the serving control plane: a two-replica fleet's
streams (greedy and sampled) survive a replica crash and a hot rolling
swap unchanged, with every flash-decode launch in the hopper form;
Deconvolution (cuDNN's transposed convolution, groups, bias, a target
that needs an adjustment of the stride) against the same op on the CPU
within ``chip_smoke.TOL["float32"]`` of ``1 + |CPU value|``; Dropout's
keyed masks on the card: two trainers of one seed draw the same masks
step for step, and an executor's backward uses its forward's mask; the
fp8 block product (``quant.block_dot``) through cuBLAS's fp8 GEMM, and
the e5m2 x e5m2 pair through its upcast route, against its plain version
within ``chip_smoke.FP8_DOT_TOL`` of the terms' magnitude (summation
order), with ``block_quantize`` byte for byte the CPU's; a checkpoint
snapshot that holds its bytes while the in-place update runs on; the
trainer's ``matmul_precision`` names on the card; data parallelism on
the card: ``ShardedTrainer(mesh=data_parallel_mesh())`` bitwise the plain
trainer, int8 with error feedback fused (K2's bucket form over the
reduced buckets) bitwise unfused, and the kvstore and ``psum_compressed``
over two members on the card (exact; the compressed sums and residuals
bitwise the CPU's); the last three ops on the card against the CPU
(``Proposal`` with no synchronizing call, ``ROIPooling`` and its tied
gradient, ``WarpCTC``), and an artifact exported on the CPU served on
the card; tensor and model parallelism: ``group2ctx`` across the host
and the card against one card, the split plan of ``megatron_rules()`` at
a model axis of 1 bitwise the trainer without rules, and (with two
cards) the split plan and the implicit mode's ``sum`` over two cards;
mixture of experts and ring attention: the ring over a one-card seq mesh
bitwise the K3 call of ``flash_attention_stats`` (gradients within
``chip_smoke.P21_RING_GRAD_TOL`` of ``flash_attention``'s), ``MoEFFN``
through the trainer on the card routing every token as the CPU does
(``chip_smoke.p21_compare``), and (with two cards) the LM over a seq
mesh and ``MoEFFN`` over an expert mesh against one card.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch import optimizer
from mxnet_tpu_torch import quant as tquant
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_update as tfu
from mxnet_tpu_torch.ops import nn_ops as tnn
from mxnet_tpu_torch.parallel import flash_attention as tfa
from mxnet_tpu_torch.serve import flash_decode as tfd
from mxnet_tpu_torch.serve import kvcache as tkv


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


def _decode_case(fn, args, form, split_k=None):
    """Run ``fn`` in ``form`` (None: kernel_form's choice); returns the
    output and the form that ran, or None after checking that a forced
    form the operands do not allow raises."""
    q, kp, vp = args[:3]
    best = tfd.kernel_form(kp, vp)
    if form == "hopper" and best != "hopper":
        with pytest.raises(MXNetError, match="form 'hopper'"):
            fn(*args, split_k=split_k, form=form)
        return None, None
    before = dict(fn.launches_by_form)
    out = fn(*args, split_k=split_k, form=form)
    ran = form or best
    assert {f: n - before[f] for f, n in fn.launches_by_form.items()} == {
        f: int(f == ran) for f in before}
    return out, ran


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["warp", "hopper"])
@pytest.mark.parametrize("hd", [8, 64, 100, 128, 256])
@pytest.mark.parametrize("split_k", [None, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda, hd, split_k, dtype, form):
    args = _operands(cuda, hd + (split_k or 0), B=5, H=3, hd=hd, BS=16,
                     nblk=20, lengths=[320, 1, 17, 200, 64], dtype=dtype,
                     trash_rows=(3,))
    before = tfd.flash_decode_attention.launches
    out, ran = _decode_case(tfd.flash_decode_attention, args, form, split_k)
    if out is None:
        return
    ref = tfd.flash_decode_attention_ref(*args, split_k=split_k)
    torch.cuda.synchronize()
    assert tfd.flash_decode_attention.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


# (B, H, hd, BS, columns, lengths): 8192 positions, wide heads, BS 32,
# length 1 and lengths exactly on a block boundary
DECODE_EDGES = [
    (2, 8, 64, 16, 512, [8192, 8191]),
    (3, 4, 128, 16, 24, [1, 16, 384]),
    (2, 2, 256, 16, 12, [32, 191]),
    (3, 8, 64, 32, 20, [640, 1, 96]),
    (2, 4, 128, 32, 9, [288, 33]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["warp", "hopper"])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "fp8"])
@pytest.mark.parametrize("case", range(len(DECODE_EDGES)))
def test_flash_decode_forms_at_edges(cuda, case, pool, form):
    B, H, hd, BS, nblk, lengths = DECODE_EDGES[case]
    dtype = torch.bfloat16 if pool == "bfloat16" else torch.float32
    q, kp, vp, tables, lens = _operands(
        cuda, 40 + case, B=B, H=H, hd=hd, BS=BS, nblk=nblk, lengths=lengths,
        dtype=dtype, npool=B * nblk + 1)
    if pool == "fp8":
        kp, vp = _quantize_pool(kp), _quantize_pool(vp)
    args = (q, kp, vp, tables, lens)
    assert tfd.kernel_form(kp, vp) == "hopper"
    out, _ = _decode_case(tfd.flash_decode_attention, args, form)
    ref = tfd.flash_decode_attention_ref(*args)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


# forced hopper plans (head group, parts, entries a part, stages) at the
# served shape (8 splits of 8 columns): heads split across blocks (a copy
# a position), one part a split, one column a part, a one-stage ring, a
# three-stage ring that wraps
HOPPER_PLANS = [(1, 2, 4, 2), (2, 4, 2, 2), (8, 1, 8, 1), (4, 8, 1, 1),
                (4, 2, 4, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("plan", HOPPER_PLANS)
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "fp8"])
def test_flash_decode_hopper_plans(cuda, monkeypatch, plan, pool):
    dtype = torch.bfloat16 if pool == "bfloat16" else torch.float32
    q, kp, vp, tables, lens = _operands(
        cuda, 91, B=8, H=8, hd=64, BS=16, nblk=64,
        lengths=[1024, 700, 33, 1, 512, 999, 128, 257], dtype=dtype,
        npool=520)
    if pool == "fp8":
        kp, vp = _quantize_pool(kp), _quantize_pool(vp)
    monkeypatch.setattr(tfd, "hopper_plan", lambda *a, **kw: plan)
    out = tfd.flash_decode_attention(q, kp, vp, tables, lens, form="hopper")
    ref = tfd.flash_decode_attention_ref(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float32", "fp8"])
def test_flash_decode_hopper_form_is_repeatable(cuda, pool):
    """Two calls of the hopper form with 8 splits give bitwise equal
    outputs (the in-launch combine sums the partials in a fixed order),
    and leave the ticket buffer zero."""
    q, kp, vp, tables, lens = _operands(
        cuda, 77, B=8, H=8, hd=64, BS=16, nblk=64,
        lengths=[1024, 700, 33, 1, 512, 999, 128, 257], dtype=torch.float32,
        npool=520)
    if pool == "fp8":
        kp, vp = _quantize_pool(kp), _quantize_pool(vp)
    assert tfd.split_plan(64) == (8, 8)
    outs = [tfd.flash_decode_attention(q, kp, vp, tables, lens,
                                       form="hopper") for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    for t in tfd._tickets.values():
        assert int(t.abs().sum()) == 0


@pytest.mark.cuda
def test_flash_decode_kernel_rejects_wide_heads(cuda):
    args = _operands(cuda, 0, B=2, H=1, hd=512, BS=4, nblk=3,
                     lengths=[5, 9], dtype=torch.float32)
    with pytest.raises(MXNetError, match="head_dim"):
        tfd.flash_decode_attention(*args)


def _quantize_pool(pool):
    """An fp8 ``QuantPool`` layer of a [NB, BS, H, hd] pool: one e4m3 row
    and one f32 scale per cached position."""
    nb, bs = pool.shape[:2]
    pay, sc = tquant.rowwise_quantize(pool.reshape((nb * bs,)
                                                   + pool.shape[2:]), "e4m3")
    return tkv.QuantPool(pay.reshape(pool.shape), sc.reshape(nb, bs))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["warp", "hopper"])
@pytest.mark.parametrize("hd", [8, 64, 100, 128, 256])
@pytest.mark.parametrize("split_k", [None, 1, 3])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_fp8_kernel_matches_plain(cuda, hd, split_k, q_dtype,
                                               form):
    q, kp, vp, tables, lens = _operands(
        cuda, 7 * hd + (split_k or 0), B=5, H=3, hd=hd, BS=16, nblk=20,
        lengths=[320, 1, 17, 200, 64], dtype=torch.float32, trash_rows=(3,))
    q = q.to(q_dtype)
    kq, vq = _quantize_pool(kp), _quantize_pool(vp)
    fd = tfd.flash_decode_attention
    before = (fd.launches, fd.launches_fp8)
    out, _ = _decode_case(fd, (q, kq, vq, tables, lens), form, split_k)
    if out is None:
        return
    ref = tfd.flash_decode_attention_ref(q, kq, vq, tables, lens,
                                         split_k=split_k)
    torch.cuda.synchronize()
    assert (fd.launches, fd.launches_fp8) == (before[0], before[1] + 1)
    tol = 2e-5 if q_dtype == torch.float32 else 1e-2
    assert out.dtype == q_dtype
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_fp8_cast_and_pool_ops_on_card_equal_cpu(cuda):
    """The e4m3 cast gives the CPU's bytes on the card, and the pool's
    writes, gathers, scrub and compaction act on fp8 payloads there."""
    rng = np.random.RandomState(3)
    x = (rng.randn(512, 8, 64) * rng.choice([0.01, 1.0, 30.0],
                                            (512, 1, 1))).astype(np.float32)
    qc, sc = tquant.rowwise_quantize(torch.from_numpy(x), "e4m3")
    qg, sg = tquant.rowwise_quantize(torch.from_numpy(x).to(cuda), "e4m3")
    assert torch.equal(qg.view(torch.uint8).cpu(), qc.view(torch.uint8))
    assert torch.equal(sg.cpu().view(torch.int32), sc.view(torch.int32))
    pools = {d: tkv.make_pools(2, 8, 4, 8, 64, quant="fp8", device=d)[0]
             for d in ("cpu", cuda)}
    states = torch.from_numpy(x[:10])
    table = torch.tensor([3, 5, 6], dtype=torch.int32)
    for d, pool in pools.items():
        tkv.write_prefill(pool, 1, states.to(d), table.to(d), 10)
        tkv.write_decode(pool, 0, states[:2].to(d),
                         torch.tensor([2, 7], dtype=torch.int32).to(d),
                         torch.tensor([1, 3], dtype=torch.int32).to(d),
                         torch.tensor([True, True]).to(d))
        tkv.compact_pool(pool, {5: 1, 6: 4})
        tkv.scrub_blocks(pool, [7])
    for a, b in zip(pools["cpu"], pools[cuda]):
        assert torch.equal(a.view(torch.uint8) if a.dtype != torch.float32
                           else a, (b.view(torch.uint8)
                                    if b.dtype != torch.float32 else b).cpu())
    got = tkv._gather_blocks(tkv.layer_view(pools[cuda], 1),
                             table.to(cuda))
    want = tkv._gather_blocks(tkv.layer_view(pools["cpu"], 1), table)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_flash_decode_rejects_mixed_pools_on_card(cuda):
    q, kp, vp, tables, lens = _operands(cuda, 1, B=2, H=2, hd=64, BS=16,
                                        nblk=4, lengths=[20, 33],
                                        dtype=torch.float32)
    with pytest.raises(MXNetError, match="mixed"):
        tfd.flash_decode_attention(q, _quantize_pool(kp), vp, tables, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["warp", "block"])
@pytest.mark.parametrize("shape", [(64, 1000), (8, 10), (3, 16384),
                                   (37, 1001), (1, 1), (300, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_rows_kernel_matches_plain(cuda, shape, dtype, form):
    rng = np.random.RandomState(shape[1])
    x = (4.0 * rng.randn(*shape)).astype(np.float32)
    x[:, ::5] = -np.inf if shape[1] > 1 else x[:, ::5]
    t = torch.from_numpy(x).to(cuda, dtype)
    if form == "warp" and shape[1] > tnn.SOFTMAX_WARP_MAX_COLS:
        with pytest.raises(MXNetError, match="form 'warp'"):
            tnn.softmax_rows(t, form=form)
        return
    before = tnn.softmax_rows.launches
    by_form = dict(tnn.softmax_rows.launches_by_form)
    out = tnn.softmax_rows(t, form=form)
    ref = tnn.softmax_rows_ref(t)
    torch.cuda.synchronize()
    assert tnn.softmax_rows.launches == before + 1
    assert tnn.softmax_rows.launches_by_form[form] == by_form[form] + 1
    assert out.dtype == dtype and out.shape == t.shape
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    rows = out.float().sum(dim=-1)
    assert (rows - 1).abs().max().item() <= (1e-5 if dtype == torch.float32
                                              else 2e-2)


@pytest.mark.cuda
def test_softmax_rows_warp_form_on_a_misaligned_view(cuda):
    """A row base off the 16-byte grid takes the warp form's scalar loads."""
    x = torch.randn(65 * 1000 + 1, device=cuda)[1:].view(65, 1000)
    assert x.data_ptr() % 16 != 0
    out = tnn.softmax_rows(x, form="warp")
    assert (out - tnn.softmax_rows_ref(x)).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_softmax_rows_kernel_rejects_non_contiguous(cuda):
    x = torch.randn(8, 20, device=cuda)[:, ::2]
    with pytest.raises(MXNetError, match="contiguous"):
        tnn.softmax_rows(x)


def _k2_case(cuda, case, n, seed):
    """One ``chip_smoke.K2_CASES`` case over ``n`` elements on the card:
    ``(g, w, state, bounds, unfused result, plain result, kernel args)``,
    ``bounds`` cutting the bucket into 7 parameters (fewer when short)."""
    kind, use_wdvec, use_mult, ok_v, clip = chip_smoke.K2_CASES[case]
    chip_smoke.DEVICE = str(cuda)
    g, w, state, bounds, seg_wd = chip_smoke.k2_operands(
        torch, np, kind, max(n, 8), seed=seed)
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
    kw = dict(momentum=0.9, beta1=0.9, beta2=0.999, epsilon=1e-8,
              wd=0.0 if use_wdvec else 1e-4, rescale_grad=1.0 / 64,
              clip_gradient=clip, kind=kind, mult=mult, ok=ok, wd_vec=wdvec)
    plain = tfu.reference_update(g, w, tuple(state), scalars, **kw)
    return g, w, state, bounds, want, plain, scalars, kw


def _k2_bitwise(got, *refs):
    for ref in refs:
        for a, b in zip(got, ref):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _k2_form_deltas(before):
    return {f: n - before[f]
            for f, n in tfu.fused_update.launches_by_form.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(chip_smoke.K2_CASES)))
@pytest.mark.parametrize("n", [1, 255, 1003, (1 << 20) + 7])
def test_fused_update_kernel_is_bitwise_unfused(cuda, case, n):
    g, w, state, _, want, plain, scalars, kw = _k2_case(cuda, case, n, case)
    kw_, ks = w.clone(), [s.clone() for s in state]
    before = tfu.fused_update.launches
    tfu.fused_update(g, kw_, tuple(ks), scalars, **kw)
    torch.cuda.synchronize()
    assert tfu.fused_update.launches == before + 1
    _k2_bitwise([kw_] + ks, want, plain)
    if chip_smoke.K2_CASES[case][3] is False:
        _k2_bitwise([kw_] + ks, [w] + state)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(chip_smoke.K2_CASES)))
@pytest.mark.parametrize("layout", ["views", "clones", "shifted"])
def test_fused_update_forms_are_bitwise_twins(cuda, case, layout):
    """The hopper form over the bucket's parameters as separate gradients
    (``chip_smoke.k2_segments``: random cuts put chunks off the 16-byte
    grid, "shifted" puts every pointer off it) equals the bucket form
    over the whole bucket, the plain version and the unfused update;
    ok=False leaves every buffer unchanged."""
    n = (1 << 20) + 1003
    g, w, state, bounds, want, plain, scalars, kw = _k2_case(
        cuda, case, n, 50 + case)
    grads = chip_smoke.k2_segments(torch, g, bounds, layout)
    results = {}
    for form in tfu.KERNEL_FORMS:
        kw_, ks = w.clone(), [s.clone() for s in state]
        before = dict(tfu.fused_update.launches_by_form)
        if form == "hopper":
            tfu.fused_update_params(grads, kw_, tuple(ks),
                                    [a for a, _ in bounds], scalars, **kw)
        else:
            tfu.fused_update(g, kw_, tuple(ks), scalars, form=form, **kw)
        torch.cuda.synchronize()
        assert _k2_form_deltas(before) == {f: int(f == form)
                                           for f in tfu.KERNEL_FORMS}
        results[form] = [kw_] + ks
    _k2_bitwise(results["hopper"], results["bucket"], want, plain)
    if chip_smoke.K2_CASES[case][3] is False:
        _k2_bitwise(results["hopper"], [w] + state)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(chip_smoke.K2_CASES)))
def test_fused_update_hopper_form_past_one_table(cuda, case):
    n = 300 * 1000 + 17
    g, w, state, _, want, plain, scalars, kw = _k2_case(cuda, case, n,
                                                        80 + case)
    cuts = chip_smoke.k2_cuts(np, n, 300, seed=case)
    grads = chip_smoke.k2_segments(torch, g, cuts, "clones")
    kw_, ks = w.clone(), [s.clone() for s in state]
    before = dict(tfu.fused_update.launches_by_form)
    tfu.fused_update_params(grads, kw_, tuple(ks), [a for a, _ in cuts],
                            scalars, **kw)
    torch.cuda.synchronize()
    assert _k2_form_deltas(before) == {"hopper": 2, "bucket": 0}
    _k2_bitwise([kw_] + ks, want, plain)


@pytest.mark.cuda
def test_fused_update_kernel_rejects_non_contiguous(cuda):
    g = torch.zeros(16, device=cuda)[::2]
    lr = torch.full((), 0.1, device=cuda)
    with pytest.raises(MXNetError, match="contiguous"):
        tfu.fused_update(g, torch.zeros(8, device=cuda), (), (lr,),
                         kind="sgd")
    with pytest.raises(MXNetError, match="non-contiguous"):
        tfu.fused_update_params([g], torch.zeros(8, device=cuda), (), [0],
                                (lr,), kind="sgd")


# (layout, B, H, Lq, Lk, D, causal, external delta, the bf16 form)
K34_SHAPES = [
    ("blhd", 2, 4, 256, 256, 64, True, False, "hopper"),
    ("bhld", 1, 2, 192, 320, 32, False, False, "mma"),
    ("blhd", 1, 2, 100, 100, 16, True, False, "mma"),     # ragged tiles
    ("blhd", 1, 2, 128, 128, 256, True, False, "fma"),
    ("bhld", 1, 1, 64, 64, 8, False, False, "mma"),
    ("bhld", 2, 2, 256, 256, 100, True, True, "mma"),
    # the hopper form's edges: ragged 128-row tiles, cross lengths, D 128,
    # a tile shorter than one block
    ("blhd", 2, 2, 192, 192, 64, True, False, "hopper"),
    ("bhld", 1, 2, 200, 328, 64, False, True, "hopper"),
    ("blhd", 1, 2, 256, 256, 128, True, False, "hopper"),
    ("bhld", 1, 2, 320, 200, 128, False, False, "hopper"),
    ("blhd", 1, 1, 64, 64, 64, False, False, "hopper"),
]


def _form_deltas(before):
    return [{f: n - old[f] for f, n in fn.launches_by_form.items()
             if n != old[f]}
            for fn, old in zip((tfa.flash_fwd, tfa.flash_bwd), before)]


def _forms_now():
    return (dict(tfa.flash_fwd.launches_by_form),
            dict(tfa.flash_bwd.launches_by_form))


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(K34_SHAPES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain(cuda, case, dtype):
    layout, B, H, Lq, Lk, D, causal, ext, form = K34_SHAPES[case]
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.DEVICE = str(cuda)
    q, k, v, do = chip_smoke.attn_operands(torch, np, 40 + case, layout, B,
                                           H, Lq, Lk, D, dtype)
    kw = dict(causal=causal, scale=1.0 / D ** 0.5, layout=layout)
    delta = (torch.randn(B, H, Lq, device=cuda) if ext else None)
    before = tfa.flash_fwd.launches, tfa.flash_bwd.launches
    forms = _forms_now()
    out, lse = tfa.flash_fwd(q, k, v, **kw)
    grads = tfa.flash_bwd(q, k, v, out, lse, do, delta=delta, **kw)
    ref_out, ref_lse = tfa.flash_fwd_ref(q, k, v, **kw)
    ref_grads = tfa.flash_bwd_ref(q, k, v, out, lse, do, delta=delta, **kw)
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    f32 = dtype == torch.float32
    want = "fma" if f32 else form
    assert _form_deltas(forms) == [{want: 1}, {want: 1}]
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
    element-wise tile loads: the mma form for bf16 (TMA needs 16-byte
    alignment), fma for f32."""
    B, H, L, D = 1, 2, 128, 64
    n = B * L * H * D
    base = [torch.randn(n + 1, device=cuda).to(dtype) for _ in range(4)]
    q, k, v, do = (t[1:].view(B, L, H, D) for t in base)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    kw = dict(causal=True, scale=0.125, layout="blhd")
    forms = _forms_now()
    out, lse = tfa.flash_fwd(q, k, v, **kw)
    grads = tfa.flash_bwd(q, k, v, out, lse, do, **kw)
    ref_out, _ = tfa.flash_fwd_ref(q, k, v, **kw)
    ref_grads = tfa.flash_bwd_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    want = "mma" if dtype == torch.bfloat16 else "fma"
    assert _form_deltas(forms) == [{want: 1}, {want: 1}]
    with pytest.raises(MXNetError, match="form 'hopper'"):
        tfa.flash_fwd(q, k, v, form="hopper", **kw)
    tol = chip_smoke.K34_TOL
    f32 = dtype == torch.float32
    assert chip_smoke.attn_err(torch, out, ref_out, dtype) <= (
        tol["fwd"] if f32 else tol["bf16_rel"])
    for g, r in zip(grads, ref_grads):
        assert chip_smoke.attn_err(torch, g, r, dtype) <= (
            tol["bwd"] if f32 else tol["bf16_rel"])


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True], ids=["delta_kernel",
                                                    "external_delta"])
def test_flash_bwd_hopper_form_is_deterministic(cuda, ext):
    """Two runs of K4's hopper form on the same inputs give bitwise equal
    gradients (no atomics)."""
    chip_smoke.DEVICE = str(cuda)
    q, k, v, do = chip_smoke.attn_operands(torch, np, 77, "blhd", 2, 4, 512,
                                           512, 64, torch.bfloat16)
    kw = dict(causal=True, scale=0.125, layout="blhd")
    out, lse = tfa.flash_fwd(q, k, v, **kw)
    delta = torch.randn(2, 4, 512, device=cuda) if ext else None
    forms = _forms_now()
    first = tfa.flash_bwd(q, k, v, out, lse, do, delta=delta, **kw)
    second = tfa.flash_bwd(q, k, v, out, lse, do, delta=delta, **kw)
    torch.cuda.synchronize()
    assert _form_deltas(forms)[1] == {"hopper": 2}
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_forced_mma_form_at_a_hopper_shape_matches_plain(cuda, causal):
    """``form="mma"`` runs the mma.sync kernels where kernel_form would
    pick the hopper form, and they still match the plain versions."""
    chip_smoke.DEVICE = str(cuda)
    q, k, v, do = chip_smoke.attn_operands(torch, np, 78, "blhd", 2, 4, 256,
                                           256, 64, torch.bfloat16)
    assert tfa.kernel_form(q.dtype, 64, q, k, v) == "hopper"
    kw = dict(causal=causal, scale=0.125, layout="blhd")
    forms = _forms_now()
    out, lse = tfa.flash_fwd(q, k, v, form="mma", **kw)
    grads = tfa.flash_bwd(q, k, v, out, lse, do, form="mma", **kw)
    ref_out, ref_lse = tfa.flash_fwd_ref(q, k, v, **kw)
    ref_grads = tfa.flash_bwd_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert _form_deltas(forms) == [{"mma": 1}, {"mma": 1}]
    tol = chip_smoke.K34_TOL["bf16_rel"]
    assert (lse - ref_lse).abs().max().item() <= tol
    assert chip_smoke.attn_err(torch, out, ref_out, torch.bfloat16) <= tol
    for g, r in zip(grads, ref_grads):
        assert chip_smoke.attn_err(torch, g, r, torch.bfloat16) <= tol


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


# ---------------------------------------------------------------------------
# K6: user CUDA kernels through mxnet_tpu_torch.rtc.CudaKernel
# (chip_smoke.RTC_TOL: f32 within 1e-6 of max(1, |plain|), the softmax
# within 1e-6 absolute, bf16 within 1e-2 absolute on inputs in [-1, 1])
# ---------------------------------------------------------------------------

RTC_CASES = ["axpb", "axpb_view", "axpb_bf16", "dbl", "ref_exp",
             "softmax_100x10", "softmax_7x1000", "softmax_3x5"]


def _rtc_case(case, dev, kern):
    rng = np.random.RandomState(len(case))
    u = lambda *s: torch.from_numpy(  # noqa: E731
        rng.uniform(-1, 1, s).astype(np.float32)).to(dev)
    if case == "axpb":
        x, y = u(8, 128), u(8, 128)
        return kern["axpb"](x, y)[0], kern["axpb"].reference(x, y)[0], \
            "float32"
    if case == "axpb_view":
        big = u(64, 96)
        v = big[5:37]
        return kern["axpb"](v, v)[0], kern["axpb"].reference(v, v)[0], \
            "float32"
    if case == "axpb_bf16":
        x, y = u(1000, 333).bfloat16(), u(1000, 333).bfloat16()
        return kern["axpb_bf16"](x, y)[0], \
            kern["axpb_bf16"].reference(x, y)[0], "bfloat16"
    if case == "dbl":
        x = u(2, 128)
        return kern["dbl"](x)[0], x * 2.0, "float32"
    if case == "ref_exp":
        x = u(10)
        return kern["ref_exp"](x)[0], torch.exp(x * 5.0), "float32"
    n, c = (int(v) for v in case.split("_")[1].split("x"))
    x = 4.0 * u(n, c)
    geo = dict(grid=(n,), block=(chip_smoke.RTC_ROW_BLOCK,))
    (p,) = kern["softmax_fwd"](x, **geo)
    lab = torch.from_numpy(rng.randint(0, c, n).astype(np.float32)).to(dev)
    (dx,) = kern["softmax_bwd"](p, lab, **geo)
    got = torch.cat([p.flatten(), dx.flatten()])
    want = torch.cat([chip_smoke.softmax_plain(torch, x)[0].flatten(),
                      chip_smoke.softmax_ce_bwd_plain(torch, p, lab)[0]
                      .flatten()])
    return got, want, "softmax"


@pytest.mark.cuda
@pytest.mark.parametrize("case", RTC_CASES)
def test_rtc_kernels_match_plain(cuda, case):
    from mxnet_tpu_torch import rtc
    kern = chip_smoke.rtc_kernels(torch, rtc)
    got, want, kind = _rtc_case(case, cuda, kern)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert chip_smoke.rtc_err(torch, got, want, kind) <= \
        chip_smoke.RTC_TOL[kind]
    assert sum(k.launches for k in kern.values()) >= 1


@pytest.mark.cuda
def test_rtc_cache_hits_without_a_rebuild(cuda):
    from mxnet_tpu_torch import rtc
    k1 = rtc.CudaKernel("dbl", chip_smoke.RTC_DBL)
    x = torch.arange(512, dtype=torch.float32, device=cuda)
    k1(x)
    k1(x)
    assert len(k1._compiled) == 1 and k1.launches == 2
    k1(x[:100])                               # a new shape only reloads
    assert len(k1._compiled) == 2
    k2 = rtc.CudaKernel("dbl", chip_smoke.RTC_DBL)
    k2(x)
    assert k2.build_info["cached"] and k2.build_info["seconds"] == 0.0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_rtc_nvcc_error_is_an_mxnet_error(cuda):
    from mxnet_tpu_torch import rtc
    bad = rtc.CudaKernel("broken_t", 'extern "C" __global__ void broken_t('
                         'const float* x, float* o, long long n) '
                         '{ o[0] = undefined_name; }')
    with pytest.raises(MXNetError, match="undefined_name"):
        bad(torch.zeros(4, device=cuda))
    assert bad.launches == 0


@pytest.mark.cuda
def test_rtc_softmax_head_equals_softmax_output_on_card(cuda):
    import mxnet_tpu_torch as mxt
    from mxnet_tpu_torch import rtc
    kern = chip_smoke.rtc_kernels(torch, rtc)
    op = chip_smoke.rtc_softmax_op(mxt.operator, kern["softmax_fwd"],
                                   kern["softmax_bwd"])
    shapes = dict(data=(16, chip_smoke.MLP_IN), softmax_label=(16,))
    ex = chip_smoke.rtc_mlp(mxt, op).simple_bind(mxt.gpu(0), **shapes)
    with mxt.name.NameManager():
        ref = mxt.models.mlp().simple_bind(mxt.gpu(0), **shapes)
    params = chip_smoke.mlp_params(np, ex)
    X, Y = chip_smoke.mlp_data(np)
    for e in (ex, ref):
        e.copy_params_from(params)
        e.forward(is_train=True, data=X[:16], softmax_label=Y[:16])
        e.backward()
    assert kern["softmax_fwd"].launches == kern["softmax_bwd"].launches == 1
    np.testing.assert_allclose(ex.outputs[0].asnumpy(),
                               ref.outputs[0].asnumpy(), rtol=1e-5,
                               atol=1e-7)
    for n in params:
        g = ref.grad_dict[n].asnumpy()
        np.testing.assert_allclose(ex.grad_dict[n].asnumpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


# ---------------------------------------------------------------------------
# Speculative decoding on the card
# ---------------------------------------------------------------------------

SPEC_CFG = dict(heads=4, block_size=4, num_blocks=64, max_batch=4,
                max_prompt_len=16, max_seq_len=48, prompt_bucket_min=8)
SPEC_PROMPTS = [[1, 2, 3], [10, 11, 12, 13, 14, 15], [20, 21],
                [30, 31, 32, 33], [9, 9, 9], [5, 6, 7, 5, 6, 7, 5]]
SPEC_NEW = [10, 8, 12, 6, 12, 9]


def _spec_params():
    """Small LM weights whose greedy streams vary from token to token with
    wide argmax margins (``tests/test_torch_serve.py``'s recipe): identity
    norms, an lm head mapping each token's embedding to a permuted
    successor."""
    from mxnet_tpu_torch.models.transformer import init_params
    p = init_params(61, 2, 32, seed=0)
    rng = np.random.RandomState(1)
    perm = rng.permutation(61)
    p = {k: (v * 2.6 if v.ndim == 2 else v) for k, v in p.items()}
    for k in p:
        if k.endswith("_gamma"):
            p[k][:] = 1
        elif k.endswith("_beta"):
            p[k][:] = 0
    p["embed_weight"] = rng.randn(61, 32).astype(np.float32)
    p["lm_head_weight"] = p["embed_weight"][np.argsort(perm)].copy()
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "fp8"])
def test_speculative_greedy_equals_plain_on_card(cuda, kv_quant):
    """n-gram speculation on the card emits the plain engine's greedy
    streams (K5 or K5-fp8 attention) through the verify step's dense
    attention, and launches no flash-decode kernel."""
    from mxnet_tpu_torch.serve import Engine, EngineConfig
    params = _spec_params()
    kws = [dict(max_new_tokens=n) for n in SPEC_NEW]
    fd = tfd.flash_decode_attention

    def serve(speculate):
        eng = Engine(params, EngineConfig(speculate=speculate, spec_k=4,
                                          kv_quant=kv_quant, **SPEC_CFG),
                     device=cuda)
        ids = [eng.submit(p, **kw) for p, kw in zip(SPEC_PROMPTS, kws)]
        before = fd.launches + fd.launches_fp8
        outs = [eng.result(i) for i in ids]
        return eng, outs, fd.launches + fd.launches_fp8 - before

    plain, want, plain_launches = serve(False)
    assert plain_launches == 2 * plain.counters["decode_steps"] > 0
    spec, got, spec_launches = serve(True)
    assert got == want
    assert spec_launches == 0
    assert spec.counters["decode_steps"] == spec.counters[
        "kernel_launches"] == 0
    assert spec.counters["verify_steps"] > 0
    assert spec.stats()["speculate"]["accepted"] > 0
    assert spec.alloc.num_used == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "fp8"])
def test_scrub_positions_zeroes_rejected_positions_on_card(cuda, kv_quant):
    """``write_spec`` then ``scrub_positions`` on the card: the rejected
    positions are zero in both leaves (payload bytes and scale) of every
    layer, the kept ones hold their states, and the pools equal the CPU's
    byte for byte."""
    rng = np.random.RandomState(8)
    states = torch.from_numpy(rng.randn(2, 2, 3, 2, 16).astype(np.float32))
    slots = torch.tensor([[1, 1, 2], [3, 3, 3]], dtype=torch.int32)
    offs = torch.tensor([[2, 3, 0], [0, 1, 2]], dtype=torch.int32)
    scrub = torch.tensor([[False, True, True], [False, False, True]])
    sslots = torch.where(scrub, slots, 0)
    leaves = []
    for dev in (torch.device("cpu"), cuda):
        pools = tkv.make_pools(2, 6, 4, 2, 16, quant=kv_quant, device=dev)
        for layer in range(2):
            for j in range(2):
                tkv.write_spec(pools[j], layer, states[layer, j].to(dev),
                               slots.to(dev), offs.to(dev))
        for pool in pools:
            tkv.scrub_positions(pool, sslots.to(dev), offs.to(dev))
        leaves.append([t.cpu() for pool in pools for t in tkv._leaves(pool)])
    for cpu_leaf, card_leaf in zip(*leaves):
        assert torch.equal(cpu_leaf.view(torch.uint8),
                           card_leaf.view(torch.uint8))
        for b in range(2):
            for c in range(3):
                entry = card_leaf[:, slots[b, c], offs[b, c]]
                assert bool((entry == 0).all()) == bool(scrub[b, c])


# ---------------------------------------------------------------------------
# The serving control plane on the card
# ---------------------------------------------------------------------------

ROUTER_KW = [dict(max_new_tokens=n, temperature=(0.8 if i % 2 else 0.0),
                  top_k=(5 if i % 2 else 0), seed=100 + i)
             for i, n in enumerate(SPEC_NEW)]


def _card_fleet(cuda, params, chaos=None, swap_at=None):
    """Two replicas on the card serve SPEC_PROMPTS (greedy and sampled
    rows); with ``swap_at``, a hot rolling swap of fresh copies of the
    same weights after that many router steps.  Returns the streams, the
    router and the K5 launches by form over the run."""
    from mxnet_tpu_torch.chaos import ChaosSpec
    from mxnet_tpu_torch.serve import EngineConfig, Router, RouterConfig
    fd = tfd.flash_decode_attention
    router = Router(params, EngineConfig(**SPEC_CFG),
                    RouterConfig(replicas=2),
                    chaos={i: ChaosSpec(c) for i, c in (chaos or {}).items()},
                    device=cuda)
    router.warmup()
    before = dict(fd.launches_by_form)
    ids = [router.submit(p, **kw) for p, kw in zip(SPEC_PROMPTS, ROUTER_KW)]
    summary = None
    if swap_at is not None:
        for _ in range(swap_at):
            router.step()
        summary = router.rolling_swap({k: np.array(v, copy=True)
                                       for k, v in params.items()})
    router.run()
    forms = {f: fd.launches_by_form[f] - before[f] for f in before}
    return ([list(router.request(i).tokens) for i in ids], router, forms,
            summary)


@pytest.mark.cuda
def test_router_crash_failover_on_card(cuda):
    """A replica crashes mid-stream on the card: every stream, greedy and
    sampled, equals the clean fleet's, and every K5 launch ran the hopper
    form on both replicas."""
    params = _spec_params()
    ref, clean, ref_forms, _ = _card_fleet(cuda, params)
    assert [rep.state for rep in clean.replicas] == ["healthy"] * 2
    assert clean.stats()["failovers"] == 0
    got, router, forms, _ = _card_fleet(
        cuda, params, chaos={0: {"serve_crash": {4}}})
    assert got == ref
    # the death is the injected one, not a fault the router contained
    assert router.replicas[0].death_cause == "crash"
    assert router.replicas[0].death_error == "ChaosError"
    assert router.replicas[1].state == "healthy"
    assert router.stats()["failovers"] >= 1
    assert router.replicas[1].engine.alloc.num_used == 0
    for f in (ref_forms, forms):
        assert f["hopper"] > 0 and f["warp"] == 0


@pytest.mark.cuda
def test_router_hot_rolling_swap_on_card(cuda):
    """A hot rolling swap of the same weights mid-stream on the card
    leaves every stream unchanged, swaps both replicas, and K5 stays in
    the hopper form."""
    params = _spec_params()
    ref, _, _, _ = _card_fleet(cuda, params)
    got, router, forms, summary = _card_fleet(cuda, params, swap_at=3)
    assert summary["mode"] == "hot" and len(summary["swap_ms"]) == 2
    assert [rep.state for rep in router.replicas] == ["healthy"] * 2
    assert router.stats()["failovers"] == 0
    assert got == ref
    assert [rep.engine.swap_count for rep in router.replicas] == [1, 1]
    assert forms["hopper"] > 0 and forms["warp"] == 0


# ---------------------------------------------------------------------------
# The training loop: device prefetch, the accuracy carry, fit
# ---------------------------------------------------------------------------

def _mlp_trainer(dev, batch=64):
    from mxnet_tpu_torch import models, name
    from mxnet_tpu_torch.parallel import ShardedTrainer
    with name.NameManager():
        sym = models.mlp()
    tr = ShardedTrainer(sym, optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9},
                        guard=True, device=dev, seed=0)
    return tr.bind({"data": (batch, 784)}, {"softmax_label": (batch,)})


def _mlp_data(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 784).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


@pytest.mark.cuda
def test_device_prefetch_batches_equal_a_synchronous_copy_under_load(cuda):
    """``DevicePrefetchIter`` over ``place_batch`` stages each batch on its
    side stream while a long kernel holds the consumer stream; every batch,
    read on the consumer stream after that kernel, equals a synchronous
    copy of the host batch bit for bit (no read before the copy landed, no
    staged buffer reused while the consumer still reads it)."""
    from mxnet_tpu_torch import io
    tr = _mlp_trainer(cuda)
    x, y = _mlp_data(64 * 12)
    pf = io.DevicePrefetchIter(io.NDArrayIter(x, y, batch_size=64),
                               place_fn=tr.place_batch, device=cuda,
                               depth=3)
    got = []
    for b in pf:
        torch.cuda._sleep(20_000_000)           # ~10 ms on the consumer
        got.append({k: v.clone() for k, v in b.items()})
        # churn the allocator while the copies are in flight
        torch.empty(64 * 784 * 4, device=cuda).fill_(float("nan"))
    torch.cuda.synchronize()
    assert pf._stream is not None and len(got) == 12
    for i, g in enumerate(got):
        for k, host in (("data", x), ("softmax_label", y)):
            want = torch.from_numpy(host[i * 64:(i + 1) * 64]).to(cuda)
            assert torch.equal(g[k].view(torch.int32),
                               want.view(torch.int32)), (i, k)
    pf.close()


@pytest.mark.cuda
def test_step_acc_carry_equals_a_host_recount(cuda):
    tr = _mlp_trainer(cuda)
    x, y = _mlp_data(64 * 4, seed=1)
    carry = torch.zeros((), dtype=torch.int32, device=cuda)
    hits = 0
    for i in range(4):
        sl = slice(i * 64, (i + 1) * 64)
        heads, carry = tr._step_acc({"data": x[sl], "softmax_label": y[sl]},
                                    carry)
        hits += int((heads[0].cpu().numpy().argmax(1)
                     == y[sl].astype(np.int32)).sum())
    assert carry.dtype == torch.int32 and carry.device.type == "cuda"
    assert int(carry) == hits


@pytest.mark.cuda
def test_async_accuracy_of_host_labels_never_syncs(cuda):
    """``fit``'s ``Accuracy`` facade on a symbol with no label names folds
    host labels into its carry with no synchronizing call (the labels go
    to the card from pinned memory, asynchronously); the drain equals a
    host recount."""
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.parallel.trainer import _AsyncMetric
    rng = np.random.RandomState(3)
    preds = [rng.rand(64, 10).astype(np.float32) for _ in range(4)]
    labels = [rng.randint(0, 10, 64).astype(np.float32) for _ in range(4)]
    m = _AsyncMetric(metric.Accuracy(), cuda)
    on_card = [torch.from_numpy(p).to(cuda) for p in preds]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for p, lbl in zip(on_card, labels):
            m.update_async([lbl], [p])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = metric.Accuracy()
    for p, lbl in zip(preds, labels):
        host.update([lbl], [p])
    assert m.get() == host.get()
    assert (m.inner.sum_metric, m.inner.num_inst) == (host.sum_metric,
                                                      host.num_inst)


@pytest.mark.cuda
def test_fit_on_card_equals_the_bare_step_loop(cuda):
    """``fit`` (prefetch on a side stream, the accuracy fold, a
    ``FactorScheduler``) leaves the state of a bare ``step`` loop over the
    same batches, bit for bit, and its accuracy is the host recount."""
    from mxnet_tpu_torch import io, lr_scheduler, metric
    x, y = _mlp_data(64 * 6, seed=2)
    fit_tr, bare = _mlp_trainer(cuda), _mlp_trainer(cuda)
    for tr in (fit_tr, bare):
        tr.optimizer.lr_scheduler = lr_scheduler.FactorScheduler(3, 0.5)
        tr.optimizer.lr_scheduler.base_lr = 0.1
    acc = metric.Accuracy()
    fit_tr.fit(io.NDArrayIter(x, y, batch_size=64), eval_metric=acc,
               num_epoch=2)
    host = metric.Accuracy()
    for _ in range(2):
        host.reset()
        for i in range(6):
            sl = slice(i * 64, (i + 1) * 64)
            heads = bare.step({"data": x[sl], "softmax_label": y[sl]})
            host.update([y[sl]], heads)
    assert (acc.sum_metric, acc.num_inst) == (host.sum_metric,
                                              host.num_inst)
    for a, b in ((fit_tr._flat_w, bare._flat_w),
                 (fit_tr._flat_state[0], bare._flat_state[0])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # FactorScheduler(3, 0.5) has halved three times by update 12
    assert float(fit_tr._lr_dev) == float(bare._lr_dev) == float(
        np.float32(0.1 * 0.5 ** 3))


@pytest.mark.cuda
@pytest.mark.parametrize("params,shape", [
    (dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), num_filter=8,
          num_group=2, no_bias=False, target_shape=(34, 34)), (4, 6, 16, 16)),
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
          num_filter=4), (2, 3, 9, 7)),
])
def test_deconvolution_on_card_equals_cpu(cuda, params, shape):
    from mxnet_tpu_torch import symbol as S
    from mxnet_tpu_torch.context import cpu, gpu
    net = S.Deconvolution(S.Variable("data"), name="op", **params)
    arg_shapes, out_shapes, _ = net.infer_shape(data=shape)
    rng = np.random.RandomState(0)
    vals = {a: rng.uniform(-1, 1, s).astype(np.float32)
            for a, s in zip(net.list_arguments(), arg_shapes)}
    head = rng.uniform(-1, 1, out_shapes[0]).astype(np.float32)
    res = []
    for ctx in (cpu(), gpu(0)):
        ex = net.simple_bind(ctx, data=shape)
        out = ex.forward(is_train=True, **vals)[0].asnumpy()
        ex.backward([head])
        res.append([out] + [ex.grad_dict[a].asnumpy() for a in sorted(vals)])
    for got, want in zip(res[1], res[0]):
        assert got.shape == want.shape
        err = float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))
        assert err <= chip_smoke.TOL["float32"], err


@pytest.mark.cuda
def test_dropout_keyed_replay_on_card(cuda):
    from mxnet_tpu_torch import name as tname, random as trandom
    from mxnet_tpu_torch import symbol as S
    from mxnet_tpu_torch.context import gpu
    from mxnet_tpu_torch.parallel import ShardedTrainer

    def trainer():
        with tname.NameManager():
            net = S.FullyConnected(S.Dropout(S.Variable("data"), p=0.5),
                                   num_hidden=10, name="fc")
            net = S.SoftmaxOutput(net, name="softmax")
        tr = ShardedTrainer(net, "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9}, guard=True,
                            device="cuda", seed=3)
        rng = np.random.RandomState(0)
        return tr.bind({"data": (64, 512)}, {"softmax_label": (64,)},
                       arg_params={"fc_weight": (0.05 * rng.randn(10, 512))
                                   .astype(np.float32),
                                   "fc_bias": np.zeros(10, np.float32)})

    rng = np.random.RandomState(1)
    batch = {"data": rng.rand(64, 512).astype(np.float32),
             "softmax_label": rng.randint(0, 10, 64).astype(np.float32)}
    a, b = trainer(), trainer()
    for _ in range(4):
        ha, hb = a.step(batch)[0], b.step(batch)[0]
        assert torch.equal(ha, hb)
    assert torch.equal(a._params["fc_weight"], b._params["fc_weight"])
    # the executor's backward draws the forward's mask
    with tname.NameManager():
        drop = S.Dropout(S.Variable("data"), p=0.5)
    ex = drop.simple_bind(gpu(0), data=(256, 256))
    ones = np.ones((256, 256), np.float32)
    trandom.seed(5)
    out = ex.forward(is_train=True, data=ones)[0].asnumpy()
    ex.backward([np.ones((256, 256), np.float32)])
    np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(), out)
    assert abs((out != 0).mean() - 0.5) < 0.01


# ---------------------------------------------------------------------------
# Long training runs: the fp8 block product, the snapshot, matmul precision
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(chip_smoke.FP8_DOT_CASES)))
def test_block_dot_routes_match_plain(cuda, case):
    """Each block through cuBLAS's fp8 GEMM (or, for e5m2 x e5m2, the
    upcast f32 product) within ``chip_smoke.FP8_DOT_TOL`` of the terms'
    magnitude (summation order) of the plain version on the same
    payloads, one route count a block; ``block_quantize`` on the card
    byte for byte the CPU's."""
    name, (m, k), (n, _), (fa_, fb_) = chip_smoke.FP8_DOT_CASES[case]
    rng = np.random.RandomState(case)
    host = [(rng.randn(*s) * rng.choice([0.01, 1.0, 30.0], (s[0], 1)))
            .astype(np.float32) for s in ((m, k), (n, k))]
    qs = []
    for x, fmt in zip(host, (fa_, fb_)):
        qc, sc = tquant.block_quantize(torch.from_numpy(x), fmt, 128)
        qg, sg = tquant.block_quantize(torch.from_numpy(x).to(cuda), fmt,
                                       128)
        assert torch.equal(qg.view(torch.uint8).cpu(), qc.view(torch.uint8))
        assert torch.equal(sg.cpu().view(torch.int32), sc.view(torch.int32))
        qs.append((qg, sg))
    (qa, sa), (qb, sb) = qs
    route = "upcast" if (fa_, fb_) == ("e5m2", "e5m2") else "fp8"
    assert tquant.block_dot_route(qa, qb) == route
    before = dict(tquant.block_dot.launches_by_route)
    got = tquant.block_dot(qa, sa, qb, sb)
    torch.cuda.synchronize()
    assert (tquant.block_dot.launches_by_route[route] - before[route]
            == qa.shape[0])
    ref = tquant.block_dot_ref(qa, sa, qb, sb)
    mag = sum(torch.matmul(qa[i].float().abs(), qb[i].float().abs().t())
              * sa[i] * sb[i].t() for i in range(qa.shape[0]))
    assert got.shape == (m, n)
    assert bool(((got - ref).abs() <= chip_smoke.FP8_DOT_TOL * mag).all())


@pytest.mark.cuda
def test_snapshot_survives_the_next_in_place_update(cuda, tmp_path):
    """The fused update writes weights and moments in place: a save's
    snapshot must hold the bytes of the moment it was taken even when the
    next steps run before the background write lands."""
    from mxnet_tpu_torch import name as tname
    from mxnet_tpu_torch import symbol as S
    from mxnet_tpu_torch.checkpoint import CheckpointManager, load_arrays
    from mxnet_tpu_torch.parallel import ShardedTrainer
    with tname.NameManager():
        net = S.FullyConnected(S.Variable("data"), num_hidden=4096,
                               name="fc")
        net = S.SoftmaxOutput(net, name="softmax")
    tr = ShardedTrainer(net, "adam", {"learning_rate": 0.1},
                        device="cuda").bind({"data": (64, 4096)},
                                            {"softmax_label": (64,)})
    assert tr._fused_route == "hopper"
    rng = np.random.RandomState(0)
    batch = tr.place_batch({"data": rng.rand(64, 4096).astype(np.float32),
                            "softmax_label": rng.randint(0, 10, 64)
                            .astype(np.float32)})
    tr.step(batch)
    want = {k: v.detach().cpu().numpy().copy()
            for k, v in tr._state_arrays().items()}
    mgr = CheckpointManager(str(tmp_path))
    real = mgr._writer.submit

    def late(fn):                      # the write starts after 5 steps
        for _ in range(5):
            tr.step(batch)
        torch.cuda.synchronize()
        real(fn)

    mgr._writer.submit = late
    tr.save_state(mgr)
    mgr.close()
    got = load_arrays(mgr.step_path(1))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    assert not np.array_equal(want["param:fc_weight"],
                              tr._params["fc_weight"].detach().cpu().numpy())


@pytest.mark.cuda
def test_matmul_precision_scope_on_card(cuda):
    """Each JAX precision name inside the scope, and the global setting
    restored after: "float32"/"highest" give the full float32 product,
    "tensorfloat32"/"high" the TF32 product; "bfloat16"/"default" give
    what torch's "medium" gives on this card (``chip_smoke``'s phase 16
    prints which), within bf16's precision of the full product."""
    from mxnet_tpu_torch.parallel.trainer import matmul_precision_scope
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(256, 512).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(512, 256).astype(np.float32)).to(cuda)
    prev = (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    full = a @ b
    torch.set_float32_matmul_precision("high")
    tf32 = a @ b
    torch.set_float32_matmul_precision("highest")
    mag = a.abs() @ b.abs()
    try:
        assert not torch.equal(full, tf32)
        for name, want in (("float32", full), ("highest", full),
                           ("tensorfloat32", tf32), ("high", tf32),
                           ("bfloat16", None), ("default", None)):
            with matmul_precision_scope(name):
                got = a @ b
                assert torch.backends.cudnn.allow_tf32 == (want is not full)
            if want is None:
                assert bool(((got - full).abs() <= 2 ** -7 * mag).all())
            else:
                assert torch.equal(got, want), name
            assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]


# ---------------------------------------------------------------------------
# Programs: steps captured as CUDA graphs
# ---------------------------------------------------------------------------

def _graph_trainer(cuda, **kw):
    from mxnet_tpu_torch import symbol as S
    from mxnet_tpu_torch.parallel import ShardedTrainer
    net = S.FullyConnected(data=S.Variable("data"), num_hidden=256,
                           name="fc1")
    net = S.Activation(data=net, act_type="relu")
    net = S.FullyConnected(data=net, num_hidden=10, name="fc2")
    sym = S.SoftmaxOutput(data=net, name="softmax")
    tr = ShardedTrainer(sym, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                        guard=True, clip_global_norm=1.0, device=cuda, **kw)
    return tr.bind({"data": (64, 128)}, {"softmax_label": (64,)})


def _graph_batches(n):
    rng = np.random.RandomState(0)
    return [{"data": rng.rand(64, 128).astype(np.float32),
             "softmax_label": rng.randint(0, 10, 64).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.cuda
def test_captured_trainer_steps_bitwise_eager(cuda):
    """A captured step (K1, K2 inside the graph) equals the eager step
    bit for bit, its launches are counted on every replay, and compile()
    leaves the state as it found it."""
    eager, comp = _graph_trainer(cuda), _graph_trainer(cuda)
    before = [t.clone() for t in comp._state_tensors()]
    info = comp.compile(programs=("train",))[0]
    assert info["source"] == "capture"
    assert all(torch.equal(a, b) for a, b in
               zip(before, comp._state_tensors()))
    counts = []
    for tr in (eager, comp):
        chip_smoke.reset_train_counts(tnn.softmax_rows, tfu.fused_update)
        heads = [tr.step(b)[0] for b in _graph_batches(3)]
        torch.cuda.synchronize()
        counts.append((tnn.softmax_rows.launches,
                       tfu.fused_update.launches))
    assert counts[0] == counts[1] == (3, 3)
    assert comp.aot_stats == {"hits": 3, "fallbacks": 0}
    for a, b in zip(eager._state_tensors(), comp._state_tensors()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_capture_failure_raises_naming_the_program(cuda):
    from mxnet_tpu_torch import compile_cache as cc
    x = torch.ones(4, device=cuda)

    def syncing():
        return x * float(x.sum().item())   # a device-to-host read
    with pytest.raises(MXNetError, match="capture of program 'syncs'"):
        cc.CapturedProgram("syncs", syncing, cuda).build()


@pytest.mark.cuda
def test_engine_replays_and_trace_lists_the_decode_kernel(cuda, tmp_path):
    """After warmup every decode step replays its graph: K5's launches
    are ``num_layers`` a step, and a profiler trace of the replays lists
    the hand-written kernel itself."""
    import glob
    import json
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.models.transformer import init_params
    from mxnet_tpu_torch.serve import Engine, EngineConfig
    cfg = EngineConfig(heads=4, block_size=16, num_blocks=64, max_batch=4,
                       max_seq_len=128, max_prompt_len=64)
    params = init_params(97, 2, 128, seed=0)
    eager, eng = (Engine(params, cfg, device=cuda) for _ in range(2))
    assert {i["source"] for i in eng.warmup()} == {"capture"}
    prompts = [[(5 * i + j) % 96 + 1 for j in range(9 + 7 * i)]
               for i in range(4)]
    streams = []
    for e in (eager, eng):
        ids = [e.submit(p, max_new_tokens=12) for p in prompts]
        streams.append([e.result(i) for i in ids])
    assert streams[0] == streams[1]
    assert eng.aot_stats["eager_steps"] == 0
    ids = [eng.submit(p, max_new_tokens=12) for p in prompts]
    while any(r.prefilled < r.prefill_target or not r.tokens
              for r in eng.sched.running) or eng.sched.queue:
        eng.step()
    fd = tfd.flash_decode_attention
    before, steps = fd.launches, eng.counters["decode_steps"]
    with profiler.trace(str(tmp_path)):
        eng.step()
        eng.step()
        torch.cuda.synchronize()
    steps = eng.counters["decode_steps"] - steps
    assert steps == 2 and fd.launches - before == 2 * steps
    (path,) = glob.glob(str(tmp_path / "trace.*.json"))
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    assert sum("decode_hopper_kernel" in n for n in names) == 2 * steps
    for i in ids:
        eng.cancel(i)


@pytest.mark.cuda
def test_background_capture_equals_foreground(cuda):
    """``compile(background=True)`` captures on a daemon thread the
    program a foreground compile captures: the same steps, bit for
    bit."""
    fg, bg = _graph_trainer(cuda), _graph_trainer(cuda)
    assert fg.compile()[0]["source"] == "capture"
    th = bg.compile(background=True)
    th.join(timeout=300)
    assert not th.is_alive() and bg.compile_info[0]["source"] == "capture"
    for b in _graph_batches(2):
        assert torch.equal(fg.step(b)[0], bg.step(b)[0])
    for a, b in zip(fg._state_tensors(), bg._state_tensors()):
        assert torch.equal(a, b)
    assert bg.aot_stats["hits"] == 2


@pytest.mark.cuda
def test_executor_programs_on_card_equal_eager(cuda):
    """``Executor.warmup`` captures fwd_False, fwd_True and fb; a
    training forward and backward replayed equal the eager executor's
    outputs, gradients and moving statistics bit for bit."""
    from mxnet_tpu_torch import symbol as S
    from mxnet_tpu_torch.context import gpu
    net = S.FullyConnected(data=S.Variable("data"), num_hidden=64,
                           name="fc1")
    net = S.BatchNorm(data=net, name="bn1")
    net = S.FullyConnected(data=S.Activation(data=net, act_type="relu"),
                           num_hidden=10, name="fc2")
    sym = S.SoftmaxOutput(data=net, name="softmax")
    rng = np.random.RandomState(0)
    init = {n: (0.1 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(),
                            sym.infer_shape(data=(32, 16))[0])}
    exes = []
    for warm in (False, True):
        ex = sym.simple_bind(gpu(0), data=(32, 16))
        for n, v in init.items():
            ex.arg_dict[n][:] = v
        if warm:
            assert {i["source"] for i in ex.warmup()} == {"capture"}
            assert ex.program_cache_size() == 3
        exes.append(ex)
    for step in range(2):
        x = rng.rand(32, 16).astype(np.float32)
        y = rng.randint(0, 10, 32).astype(np.float32)
        outs = []
        for ex in exes:
            o = ex.forward(is_train=True, data=x, softmax_label=y)[0]
            ex.backward()
            outs.append(o.data.clone())
        assert torch.equal(outs[0], outs[1])
        for n in exes[0].grad_dict:
            assert torch.equal(exes[0].grad_dict[n].data,
                               exes[1].grad_dict[n].data), n
        for n in exes[0].aux_dict:
            assert torch.equal(exes[0].aux_dict[n].data,
                               exes[1].aux_dict[n].data), n


# ---------------------------------------------------------------------------
# Data parallelism in one process: the mesh trainer and the collectives
# ---------------------------------------------------------------------------

def _bn_mlp():
    from mxnet_tpu_torch import name, sym as S
    with name.NameManager():
        net = S.BatchNorm(data=S.Variable("data"), name="bn1",
                          fix_gamma=False)
        net = S.FullyConnected(data=net, num_hidden=64, name="fc1")
        net = S.Activation(data=net, act_type="relu")
        net = S.FullyConnected(data=net, num_hidden=10, name="fc2")
        return S.SoftmaxOutput(data=net, name="softmax")


def _dp_trainer(sym, **kw):
    from mxnet_tpu_torch.parallel import ShardedTrainer
    tr = ShardedTrainer(sym, optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9, "wd": 1e-4},
                        guard=True, clip_global_norm=5.0, seed=0, **kw)
    return tr.bind({"data": (64, 784)}, {"softmax_label": (64,)})


def _dp_state(tr):
    out = {f"p:{n}": p.detach().clone() for n, p in tr._params.items()}
    for n, st in tr.opt_state_by_param().items():
        out.update({f"o:{n}:{i}": t.clone() for i, t in enumerate(st)})
    out.update({f"a:{n}": v.clone() for n, v in tr._aux.items()})
    for i, res in enumerate(tr._ef_res):
        out.update({f"e:{i}:{b}": r.clone() for b, r in enumerate(res)})
    return out


@pytest.mark.cuda
def test_mesh_trainer_on_card_bitwise_the_plain_trainer(cuda):
    """The default data mesh spans every card; over one card (the whole
    default mesh on a one-card machine) ``ShardedTrainer(mesh=...)``
    steps bitwise like the trainer placed by ``device``: weights,
    momentum, moving statistics; K2 once a step in the hopper form.
    Both take the one step path: this holds the mesh's placement, not
    another step."""
    from mxnet_tpu_torch.parallel import data_parallel_mesh
    assert data_parallel_mesh().size == torch.cuda.device_count()
    sym = _bn_mlp()
    x, y = _mlp_data(64 * 3, seed=4)
    states = []
    first = torch.device("cuda", 0)
    for kw in ({"device": first}, {"mesh": data_parallel_mesh(1)}):
        tr = _dp_trainer(sym, **kw)
        assert tr.mesh.size == 1 and tr.device == first
        tfu.fused_update.launches_by_form["hopper"] = 0
        for i in range(3):
            tr.step({"data": x[i * 64:(i + 1) * 64],
                     "softmax_label": y[i * 64:(i + 1) * 64]})
        torch.cuda.synchronize()
        assert tfu.fused_update.launches_by_form["hopper"] == 3
        states.append(_dp_state(tr))
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


@pytest.mark.cuda
def test_int8_explicit_fused_bitwise_unfused_on_card(cuda):
    """int8 with error feedback on the card: the fused update launches
    K2's bucket form once a reduced bucket a step, and the state
    (residuals included) is bitwise the unfused update's."""
    from mxnet_tpu_torch.parallel import data_parallel_mesh
    sym = _bn_mlp()
    x, y = _mlp_data(64 * 3, seed=5)
    states = []
    for fused in (True, False):
        tr = _dp_trainer(sym, mesh=data_parallel_mesh(1),
                         grad_compression="int8", fused_update=fused,
                         grad_bucket_bytes=64 << 10)
        assert tr.error_feedback and tr._fused == fused
        tfu.fused_update.launches_by_form["bucket"] = 0
        for i in range(3):
            tr.step({"data": x[i * 64:(i + 1) * 64],
                     "softmax_label": y[i * 64:(i + 1) * 64]})
        torch.cuda.synchronize()
        if fused:
            assert tfu.fused_update.launches_by_form["bucket"] == \
                3 * len(tr._fused_plan.buckets) > 3
        states.append(_dp_state(tr))
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int8_unfused", "zero"])
def test_one_member_mesh_modes_captured_bitwise_eager(cuda, mode):
    """One member's step is captured as a CUDA graph in every mode: int8
    with error feedback (fused: K2's bucket form over the reduced
    buckets; unfused) and ZeRO.  Replays leave the state (residuals and
    ZeRO slices included) bitwise an eager twin's, and the capture's
    warm-up leaves no trace in it."""
    from mxnet_tpu_torch.parallel import data_parallel_mesh
    kw = ({"shard_optimizer": True} if mode == "zero" else
          {"grad_compression": "int8", "grad_bucket_bytes": 64 << 10,
           "fused_update": mode == "int8"})
    sym = _bn_mlp()
    x, y = _mlp_data(64 * 3, seed=6)
    states = []
    for capture in (True, False):
        tr = _dp_trainer(sym, mesh=data_parallel_mesh(1), **kw)
        if capture:
            info = tr.compile(programs=("train",))[0]
            assert info["source"] == "capture", info
        for i in range(3):
            tr.step({"data": x[i * 64:(i + 1) * 64],
                     "softmax_label": y[i * 64:(i + 1) * 64]})
        torch.cuda.synchronize()
        assert tr.aot_stats["hits"] == (3 if capture else 0)
        states.append(_dp_state(tr))
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("compression", [None, "bf16", "int8", "fp8"])
def test_kvstore_and_psum_compressed_over_card_members(cuda, compression):
    """Two members on the card: the kvstore's push and pull reduce them
    exactly (a co-resident tree sum); ``psum_compressed`` over the two is
    bitwise the same reduction on the CPU (int8 and fp8 residuals
    included), exact on integer-valued data for None and bf16."""
    from mxnet_tpu_torch import kvstore, ndarray
    from mxnet_tpu_torch.context import gpu
    from mxnet_tpu_torch.parallel.collectives import psum_compressed
    rng = np.random.RandomState(6)
    integer = compression in (None, "bf16")
    host = [(rng.randint(-8, 9, 5000) if integer else rng.randn(5000))
            .astype(np.float32) for _ in range(2)]
    res = [(0.01 * rng.randn(5000)).astype(np.float32) for _ in range(2)]
    kv = kvstore.create("device", compression=compression)
    with gpu(0):
        kv.init(0, ndarray.zeros((5000,)))
        kv.push(0, [ndarray.array(h) for h in host])
        out = ndarray.zeros((5000,))
        kv.pull(0, out=out)
    assert torch.equal(out.data.cpu(), torch.from_numpy(host[0] + host[1]))
    on_card = psum_compressed([torch.from_numpy(h).to(cuda) for h in host],
                              compression, residuals=[
                                  torch.from_numpy(r).to(cuda) for r in res])
    on_cpu = psum_compressed([torch.from_numpy(h) for h in host],
                             compression, residuals=[
                                 torch.from_numpy(r) for r in res])
    for card, cpu in zip(on_card, on_cpu):
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)
    if integer:
        plain = psum_compressed([torch.from_numpy(h).to(cuda)
                                 for h in host], compression)
        assert torch.equal(plain[0].cpu(),
                           torch.from_numpy(host[0] + host[1]))


def _op(name, raw, *inputs):
    from mxnet_tpu_torch.ops import registry
    op = registry.get_op(name)
    return op.forward(registry.OpContext(), op.parse_params(raw), *inputs)


@pytest.mark.cuda
def test_detection_ops_on_card_match_cpu(cuda):
    """``Proposal`` on the card selects what it selects on the CPU (scores
    with ties and boxes the size filter drops: the same scores bitwise,
    the boxes within rtol 1e-6, atol 1e-5 of ``exp``'s last bit) and
    makes no synchronizing call; ``ROIPooling``'s forward is bitwise the
    CPU's and its gradient over tied maxima equal within 1e-6."""
    rng = np.random.RandomState(0)
    a = 2
    cls = torch.from_numpy((np.round(rng.rand(4, 2 * a, 16, 16) * 4) / 4)
                           .astype(np.float32))
    bbox = torch.from_numpy((rng.randn(4, 4 * a, 16, 16) * 0.5)
                            .astype(np.float32))
    bbox[:, 2::4, :3] = -6.0
    info = torch.tensor([[64.0, 64.0, 1.0]] * 4)
    raw = dict(feature_stride=4, scales=(3.0, 5.0), ratios=(1.0,),
               rpn_pre_nms_top_n=128, rpn_post_nms_top_n=8, threshold=0.7,
               rpn_min_size=4, output_score=True)
    want = _op("Proposal", raw, cls, bbox, info)
    args = [t.to(cuda) for t in (cls, bbox, info)]
    _op("Proposal", raw, *args)                 # anchors copied once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _op("Proposal", raw, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6, atol=1e-5)
    data = torch.from_numpy(np.round(rng.rand(4, 8, 16, 16) * 3)
                            .astype(np.float32))
    rois = got[0].cpu()
    g = torch.from_numpy(rng.rand(32, 8, 4, 4).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda):
        d = data.to(dev, copy=True).requires_grad_()
        out = _op("ROIPooling", dict(pooled_size=(4, 4), spatial_scale=0.25),
                  d, rois.to(dev))
        out.backward(g.to(dev))
        outs.append((out.detach().cpu(), d.grad.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_warpctc_on_card_matches_cpu(cuda):
    """``WarpCTC``'s forward (softmax) and backward (the CTC gradient
    through the recursion) on the card against the CPU, f32 within 1e-5
    of each array's largest magnitude (summation order)."""
    rng = np.random.RandomState(1)
    data = torch.from_numpy(rng.randn(20 * 8, 11).astype(np.float32))
    label = torch.from_numpy(rng.randint(0, 11, 8 * 4).astype(np.float32))
    g = torch.from_numpy(rng.rand(20 * 8, 11).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda):
        d = data.to(dev, copy=True).requires_grad_()
        out = _op("WarpCTC", dict(input_length=20, label_length=4), d,
                  label.to(dev))
        out.backward(g.to(dev))
        outs.append((out.detach().cpu(), d.grad.cpu()))
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
def test_export_traced_on_cpu_serves_on_card(cuda, tmp_path):
    """An artifact ``export_model`` traced on the CPU serves on the card,
    within 2e-5 of the ``Predictor``'s K1 path on the card."""
    from mxnet_tpu_torch import predictor, symbol as S
    from mxnet_tpu_torch.context import gpu
    net = S.SoftmaxOutput(data=S.FullyConnected(
        data=S.Variable("data"), num_hidden=10, name="fc"), name="softmax")
    rng = np.random.RandomState(2)
    arg = {"fc_weight": rng.randn(10, 7).astype(np.float32),
           "fc_bias": rng.randn(10).astype(np.float32)}
    out = str(tmp_path / "m.mxtpt")
    predictor.export_model(net, arg, {}, {"data": (4, 7)}, out)
    x = rng.rand(4, 7).astype(np.float32)
    exp = predictor.load_exported(out)
    assert exp.device.type == "cuda"
    ref = predictor.Predictor(net.tojson(),
                              {f"arg:{k}": v for k, v in arg.items()},
                              {"data": (4, 7)}, ctx=gpu(0)).predict(data=x)
    np.testing.assert_allclose(exp.predict(data=x)[0], ref[0], rtol=0,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# Tensor and model parallelism on the card (chip_smoke.py phase 20)
# ---------------------------------------------------------------------------

def _group_mlp(mx):
    S = mx.symbol
    with mx.name.NameManager():
        with mx.AttrScope(ctx_group="host"):
            net = S.FullyConnected(data=S.Variable("data"), num_hidden=64,
                                   name="fc1")
            net = S.Activation(data=net, act_type="relu", name="relu1")
        with mx.AttrScope(ctx_group="card"):
            net = S.FullyConnected(data=net, num_hidden=10, name="fc2")
            return S.SoftmaxOutput(data=net, name="softmax")


@pytest.mark.cuda
def test_group2ctx_host_and_card_match_one_card(cuda):
    """``group2ctx`` across the host and the card: fc1's weight and
    gradient on the host, fc2's on the card, one crossing each way, and
    outputs and gradients equal to the executor wholly on the card within
    ``chip_smoke.TOL["float32"]`` (one product runs on the host)."""
    import mxnet_tpu_torch as mx
    sym = _group_mlp(mx)
    rng = np.random.RandomState(20)
    args = {"fc1_weight": rng.randn(64, 32), "fc1_bias": rng.randn(64),
            "fc2_weight": rng.randn(10, 64), "fc2_bias": rng.randn(10)}
    x = rng.randn(16, 32).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    res = []
    for g2c in ({"host": mx.cpu(0), "card": mx.gpu(0)}, None):
        ex = sym.simple_bind(ctx=mx.gpu(0), group2ctx=g2c, data=(16, 32),
                             softmax_label=(16,))
        ex.copy_params_from({k: v.astype(np.float32)
                             for k, v in args.items()})
        c0 = tnn.cross_device_copy.crossings
        g0 = tnn.cross_device_copy.grad_crossings
        ex.forward(is_train=True, data=x, softmax_label=y)
        ex.backward()
        if g2c is not None:
            assert ex.arg_dict["fc1_weight"].data.device.type == "cpu"
            assert ex.grad_dict["fc1_weight"].data.device.type == "cpu"
            assert ex.arg_dict["fc2_weight"].data.device.type == "cuda"
            assert tnn.cross_device_copy.crossings - c0 == 1
            assert tnn.cross_device_copy.grad_crossings - g0 == 1
        res.append((ex.outputs[0].asnumpy(),
                    {k: ex.grad_dict[k].asnumpy() for k in args}))
    tol = chip_smoke.TOL["float32"]
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=tol, atol=tol)
    for k in args:
        np.testing.assert_allclose(res[0][1][k], res[1][1][k], rtol=tol,
                                   atol=tol, err_msg=k)


@pytest.mark.cuda
def test_split_plan_at_tp1_bitwise_plain_trainer_on_card(cuda):
    """A small LM (vocab 256, 2 layers, d 128, 2 heads, seq 1024: the
    flash path, K3/K4 in the hopper form) over a ``{"data": 1, "model":
    1}`` mesh with ``megatron_rules()``: the split plan, and 2 bf16 Adam
    steps bitwise the trainer without rules (deterministic
    algorithms)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import (ShardedTrainer, make_mesh,
                                          megatron_rules)
    b, l = 2, 1024
    sym = models.get_symbol("transformer-lm", vocab_size=256, num_layers=2,
                            d_model=128, heads=2, batch_size=b, seq_len=l,
                            loss_head=True)
    arg_shapes, _, _ = sym.infer_shape(data=(b, l), softmax_label=(b, l))
    rng = np.random.RandomState(2)
    args = {n: rng.uniform(-0.07, 0.07, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    trainers = []
    for rules in (megatron_rules(), None):
        kw = ({"mesh": make_mesh({"data": 1, "model": 1}, [mx.gpu(0)])}
              if rules is not None else {"device": "cuda:0"})
        tr = ShardedTrainer(sym, "adam", {"learning_rate": 1e-3},
                            compute_dtype="bfloat16", fused_update=False,
                            rules=rules, **kw)
        tr.bind({"data": (b, l)}, {"softmax_label": (b, l)},
                arg_params=args)
        trainers.append(tr)
    assert trainers[0]._tp_plan.plan == "split"
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for step in range(2):
            toks = rng.randint(0, 256, (b, l + 1))
            batch = {"data": toks[:, :-1].astype(np.float32),
                     "softmax_label": toks[:, 1:].astype(np.float32)}
            h0 = tfa.flash_fwd.launches_by_form["hopper"]
            ha = trainers[0].step(batch)[0]
            torch.cuda.synchronize()
            assert tfa.flash_fwd.launches_by_form["hopper"] - h0 == 2
            hb = trainers[1].step(batch)[0]
            assert torch.equal(ha.view(torch.int32), hb.view(torch.int32))
    finally:
        torch.use_deterministic_algorithms(det)
    pa, pb = trainers[0].get_params()[0], trainers[1].get_params()[0]
    for n in pb:
        np.testing.assert_array_equal(pa[n].asnumpy().view(np.int32),
                                      pb[n].asnumpy().view(np.int32), n)


@pytest.mark.cuda
def test_tp_and_implicit_sum_over_two_cards(cuda):
    """Where two cards exist: the split plan over ``{"data": 1, "model":
    2}`` against one card (heads within 2e-2: bf16 partial sums in
    another order), and ``MakeLoss(sum(...))`` over
    ``data_parallel_mesh(2)`` against one card (rtol 1e-4, atol 1e-5)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import (ShardedTrainer, data_parallel_mesh,
                                          make_mesh, megatron_rules)
    b, l = 2, 1024
    sym = models.get_symbol("transformer-lm", vocab_size=256, num_layers=2,
                            d_model=128, heads=4, batch_size=b, seq_len=l,
                            loss_head=True)
    arg_shapes, _, _ = sym.infer_shape(data=(b, l), softmax_label=(b, l))
    rng = np.random.RandomState(3)
    args = {n: rng.uniform(-0.07, 0.07, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    toks = rng.randint(0, 256, (b, l + 1))
    batch = {"data": toks[:, :-1].astype(np.float32),
             "softmax_label": toks[:, 1:].astype(np.float32)}
    heads = []
    for mesh, rules in ((make_mesh({"data": 1}, [mx.gpu(0)]), None),
                        (make_mesh({"data": 1, "model": 2},
                                   [mx.gpu(0), mx.gpu(1)]), megatron_rules())):
        tr = ShardedTrainer(sym, "sgd", {"learning_rate": 0.1},
                            compute_dtype="bfloat16", mesh=mesh, rules=rules)
        tr.bind({"data": (b, l)}, {"softmax_label": (b, l)},
                arg_params=args)
        heads.append(tr.step(batch)[0].float().cpu())
    assert tr._tp_plan.plan == "split"
    np.testing.assert_allclose(heads[1].numpy(), heads[0].numpy(),
                               atol=2e-2)
    sym = chip_smoke.p20_sum_net(mx)
    x = rng.randn(64, 512).astype(np.float32)
    out = []
    for n in (1, 2):
        tr = ShardedTrainer(sym, "sgd", {"learning_rate": 1e-3},
                            mesh=data_parallel_mesh(n))
        tr.bind({"data": (64, 512)})
        out.append((tr.step({"data": x})[0].cpu().numpy(),
                    {k: v.asnumpy() for k, v in tr.get_params()[0].items()}))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-4, atol=1e-5)
    for k in out[0][1]:
        np.testing.assert_allclose(out[1][1][k], out[0][1][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_ring_over_one_card_is_the_k3_call(cuda, causal):
    """``ring_self_attention`` over a ``{"seq": 1}`` mesh of the card
    (bf16, B 2, H 2, L 1024, d 64): its forward is bitwise the K3 call of
    ``flash_attention_stats`` (one ring step merges with an empty carry),
    K3 and K4 launch once each in the hopper form, and its gradients are
    within ``chip_smoke.P21_RING_GRAD_TOL`` of their largest magnitude of
    ``flash_attention``'s."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import make_mesh, ring_self_attention
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(2, 2, 1024, 64, device=cuda, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    mesh = make_mesh({"seq": 1}, [mx.gpu(0)])
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    h3 = tfa.flash_fwd.launches_by_form["hopper"]
    h4 = tfa.flash_bwd.launches_by_form["hopper"]
    out = ring_self_attention(qs, ks, vs, mesh, causal=causal)
    grads = torch.autograd.grad(out, (qs, ks, vs), do)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches_by_form["hopper"] - h3 == 1
    assert tfa.flash_bwd.launches_by_form["hopper"] - h4 == 1
    assert torch.equal(out.detach(),
                       tfa.flash_attention_stats(q, k, v, causal=causal)[0])
    qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(tfa.flash_attention(qf, kf, vf, causal=causal),
                              (qf, kf, vf), do)
    for a, b in zip(grads, ref):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= \
            chip_smoke.P21_RING_GRAD_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_trainer_on_card_matches_cpu(cuda, top_k):
    """``MoEFFN`` (8 experts of hidden 256, the aux head) over 512 tokens
    at d 128 through ``ShardedTrainer`` on the card and on the CPU, 3 SGD
    steps in f32 with TF32 off: the same experts for every token, heads
    within ``chip_smoke.P21_HEAD_TOL`` and updates within
    ``chip_smoke.P21_UPDATE_TOL`` of their largest magnitude."""
    import mxnet_tpu_torch as mx
    saved = (chip_smoke.P21_TOKENS, chip_smoke.P21_MOE, chip_smoke.DEVICE,
             torch.backends.cuda.matmul.allow_tf32)
    chip_smoke.P21_TOKENS = (2, 256, 128)
    chip_smoke.P21_MOE = dict(chip_smoke.P21_MOE, hidden_size=256)
    chip_smoke.DEVICE = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with mx.name.NameManager():
            sym = chip_smoke.p21_moe_symbol(mx, top_k)
        args, batches = chip_smoke.p21_moe_args(np, sym, seed=2)
        card = chip_smoke.p21_moe_run(torch, np, sym, args, batches,
                                      device=mx.gpu(0))
        host = chip_smoke.p21_moe_run(torch, np, sym, args, batches,
                                      device="cpu")
        chip_smoke.p21_compare(torch, card, host, args, f"top-{top_k}",
                               top_k)
    finally:
        (chip_smoke.P21_TOKENS, chip_smoke.P21_MOE, chip_smoke.DEVICE,
         torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.cuda
def test_seq_and_expert_meshes_over_two_cards(cuda):
    """Where two cards exist: a small LM (seq 1024, the flash ring over
    two shards of 512) over ``{"seq": 2}`` against one card (heads within
    2e-2: bf16), and ``MoEFFN`` over ``{"expert": 2}`` (a capacity that
    drops nothing) against one card (``chip_smoke.p21_compare``)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh
    b, l = 2, 1024
    sym = models.get_symbol("transformer-lm", vocab_size=256, num_layers=2,
                            d_model=128, heads=2, batch_size=b, seq_len=l,
                            loss_head=True)
    arg_shapes, _, _ = sym.infer_shape(data=(b, l), softmax_label=(b, l))
    rng = np.random.RandomState(4)
    args = {n: rng.uniform(-0.07, 0.07, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    toks = rng.randint(0, 256, (b, l + 1))
    batch = {"data": toks[:, :-1].astype(np.float32),
             "softmax_label": toks[:, 1:].astype(np.float32)}
    heads = []
    for mesh in (make_mesh({"data": 1}, [mx.gpu(0)]),
                 make_mesh({"seq": 2}, [mx.gpu(0), mx.gpu(1)])):
        tr = ShardedTrainer(sym, "sgd", {"learning_rate": 0.1},
                            compute_dtype="bfloat16", mesh=mesh)
        tr.bind({"data": (b, l)}, {"softmax_label": (b, l)},
                arg_params=args)
        heads.append(tr.step(batch)[0].float().cpu())
    np.testing.assert_allclose(heads[1].numpy(), heads[0].numpy(),
                               atol=2e-2)
    saved = (chip_smoke.P21_TOKENS, chip_smoke.P21_MOE, chip_smoke.DEVICE)
    chip_smoke.P21_TOKENS = (2, 256, 128)
    chip_smoke.P21_MOE = dict(chip_smoke.P21_MOE, hidden_size=256)
    chip_smoke.DEVICE = "cuda"
    try:
        with mx.name.NameManager():
            msym = chip_smoke.p21_moe_symbol(mx, 2, cf=4.0)
        margs, batches = chip_smoke.p21_moe_args(np, msym, seed=3)
        one = chip_smoke.p21_moe_run(torch, np, msym, margs, batches,
                                     mesh=make_mesh({"data": 1}, [mx.gpu(0)]))
        two = chip_smoke.p21_moe_run(
            torch, np, msym, margs, batches,
            mesh=make_mesh({"expert": 2}, [mx.gpu(0), mx.gpu(1)]))
        chip_smoke.p21_compare(torch, two, one, margs, "expert mesh", 2,
                               routes=False)
    finally:
        chip_smoke.P21_TOKENS, chip_smoke.P21_MOE, chip_smoke.DEVICE = saved
