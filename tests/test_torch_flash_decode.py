"""Flash-decode of the PyTorch port (mxnet_tpu_torch/serve/flash_decode.py)
against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version
(``flash_decode_attention_ref``), the same split-K function the CUDA
kernel computes.  It is held against the JAX kernel run in interpret mode
and against ``kvcache.paged_attention(impl="dense")`` at the serve tests'
size (head_dim 8, 4 heads, block_size 4, 12 table columns), over ragged
lengths, every split count and engine-style trash rows.  Tolerance:
rtol 1e-5, atol 1e-6 (f32, summation order only).  fp8 pools
(``QuantPool``, quantized on each side by its own ``rowwise_quantize``,
which agree bitwise) go through the same comparison with the same
tolerance: the dequantized values are equal, only the summation order
differs.  The kernels themselves are held against the plain version on
the card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.serve import kvcache as jkv
from mxnet_tpu.serve.flash_decode import default_split_k as jax_split_k
from mxnet_tpu.serve.flash_decode import flash_decode_attention as jax_flash
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu.quant import rowwise_quantize as jax_quantize
from mxnet_tpu_torch.quant import rowwise_quantize
from mxnet_tpu_torch.serve import flash_decode as tfd
from mxnet_tpu_torch.serve import kvcache as tkv

H, HD, BS, NBLK = 4, 8, 4, 12


def _setup(seed, lengths, trash_rows=(), npool=64):
    """Paged operands as numpy arrays: random pools, distinct random blocks
    per row; rows in ``trash_rows`` are padded as the engine pads them
    (table of trash slots, length 1)."""
    rng = np.random.RandomState(seed)
    b = len(lengths)
    q = rng.randn(b, H, HD).astype(np.float32)
    kp = rng.randn(npool, BS, H, HD).astype(np.float32)
    vp = rng.randn(npool, BS, H, HD).astype(np.float32)
    tables = np.zeros((b, NBLK), np.int32)
    lens = np.asarray(lengths, np.int32)
    free = iter(rng.permutation(np.arange(1, npool)))
    for i in range(b):
        if i in trash_rows:
            lens[i] = 1
            continue
        tables[i, :-(-int(lens[i]) // BS)] = [
            next(free) for _ in range(-(-int(lens[i]) // BS))]
    return q, kp, vp, tables, lens


def _jax(args):
    q, kp, vp, tables, lens = args
    return (jnp.asarray(q, jnp.float32), jnp.asarray(kp, jnp.float32),
            jnp.asarray(vp, jnp.float32), jnp.asarray(tables, jnp.int32),
            jnp.asarray(lens, jnp.int32))


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


CASES = {
    "ragged": dict(lengths=[37, 5, 48, 19]),
    "one_position": dict(lengths=[1]),
    "full_tables": dict(lengths=[48, 48]),
    "trash_rows": dict(lengths=[30, 9, 9, 12], trash_rows=(1, 2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("split_k", [None, 1, 2, 3, 8])
def test_plain_version_matches_jax_kernel(case, split_k):
    args = _setup(sum(map(ord, case)), **CASES[case])
    want = np.asarray(jax_flash(*_jax(args), split_k=split_k,
                                interpret=True))
    dense = np.asarray(jkv.paged_attention(*_jax(args), impl="dense"))
    before = tfd.flash_decode_attention.launches
    got = tfd.flash_decode_attention(*_torch(args), split_k=split_k)
    assert tfd.flash_decode_attention.launches == before   # no kernel on CPU
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-6)


def test_split_plan_matches_jax():
    for n in list(range(1, 70)) + [1024]:
        assert tfd.default_split_k(n) == jax_split_k(n)
    assert tfd.split_plan(12) == (2, 6)
    assert tfd.split_plan(20, 3) == (3, 7)        # trash-padded tail
    assert tfd.split_plan(4, 8) == (4, 1)         # capped at the columns
    with pytest.raises(MXNetError):
        tfd.split_plan(12, 0)


def test_wrapper_rejects_bad_inputs():
    q, kp, vp, tables, lens = _torch(_setup(3, [9, 4]))
    with pytest.raises(MXNetError, match="int32"):
        tfd.flash_decode_attention(q, kp, vp, tables.long(), lens)
    with pytest.raises(MXNetError, match="int32"):
        tfd.flash_decode_attention(q, kp, vp, tables, lens.long())
    with pytest.raises(MXNetError, match="lengths"):
        tfd.flash_decode_attention(q, kp, vp, tables, lens[:1])
    with pytest.raises(MXNetError, match="tables"):
        tfd.flash_decode_attention(q, kp, vp, tables[:1], lens)
    with pytest.raises(MXNetError, match="heads"):
        tfd.flash_decode_attention(q[:, :2], kp, vp, tables, lens)
    with pytest.raises(MXNetError, match="dtype"):
        tfd.flash_decode_attention(q, kp, vp.bfloat16(), tables, lens)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        tfd.flash_decode_attention(q.double(), kp, vp, tables, lens)


def test_bf16_pool_plain_version_tracks_f32():
    """bf16 pools read through the plain version stay near the f32 answer
    (bf16 rounding of K/V and of the output only)."""
    q, kp, vp, tables, lens = _torch(_setup(5, [37, 5, 48, 19]))
    f32 = tfd.flash_decode_attention(q, kp, vp, tables, lens)
    bf = tfd.flash_decode_attention(q.bfloat16(), kp.bfloat16(),
                                    vp.bfloat16(), tables, lens)
    assert bf.dtype == torch.bfloat16
    assert (bf.float() - f32).abs().max().item() < 5e-2


def _quant_pools(args):
    """The JAX and the port's fp8 ``QuantPool`` layers of the K and V
    pools of ``args``."""
    q, kp, vp, tables, lens = args
    out = {}
    for name, quant, mod, arr in (
            ("jax", jax_quantize, jkv, jnp.asarray),
            ("torch", rowwise_quantize, tkv, torch.from_numpy)):
        pools = []
        for p in (kp, vp):
            nb, bs = p.shape[:2]
            pay, sc = quant(arr(p.reshape(nb * bs, H, HD)), "e4m3")
            pools.append(mod.QuantPool(pay.reshape(p.shape),
                                       sc.reshape(nb, bs)))
        out[name] = pools
    return out


@pytest.mark.parametrize("case", ["ragged", "trash_rows", "full_tables"])
@pytest.mark.parametrize("split_k", [None, 1, 3])
def test_fp8_plain_version_matches_jax_kernel(case, split_k):
    """K5-fp8's plain version against the JAX kernel's quantized branch
    run in interpret mode and against ``paged_attention(impl="dense")`` on
    the same fp8 pools; no kernel launches on the CPU."""
    args = _setup(sum(map(ord, case)) + 1, **CASES[case])
    pools = _quant_pools(args)
    q, _, _, tables, lens = _jax(args)
    want = np.asarray(jax_flash(q, *pools["jax"], tables, lens,
                                split_k=split_k, interpret=True))
    dense = np.asarray(jkv.paged_attention(q, *pools["jax"], tables, lens,
                                           impl="dense"))
    tq, _, _, ttab, tlen = _torch(args)
    fd = tfd.flash_decode_attention
    before = (fd.launches, fd.launches_fp8)
    got = fd(tq, *pools["torch"], ttab, tlen, split_k=split_k)
    assert (fd.launches, fd.launches_fp8) == before
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-6)
    if case != "trash_rows":
        # the fp8 read against the f32 read: attention averages rounding
        # over many positions (a length-1 trash row reads one position,
        # up to 2**-4 of its row maximum off)
        f32 = tfd.flash_decode_attention_ref(*_torch(args), split_k=split_k)
        assert (got - f32).abs().max().item() < 0.05


def test_fp8_wrapper_rejects_mixed_and_bad_pools():
    args = _setup(9, [9, 4])
    kq, vq = _quant_pools(args)["torch"]
    q, kp, vp, tables, lens = _torch(args)
    with pytest.raises(MXNetError, match="mixed"):
        tfd.flash_decode_attention(q, kq, vp, tables, lens)
    with pytest.raises(MXNetError, match="mixed"):
        tfd.flash_decode_attention_ref(q, kp, vq, tables, lens)
    with pytest.raises(MXNetError, match="scales"):
        tfd.flash_decode_attention(q, kq, tkv.QuantPool(vq.payload,
                                                        vq.scale[:, :2]),
                                   tables, lens)
    with pytest.raises(MXNetError, match="float8_e4m3fn"):
        tfd.flash_decode_attention(
            q, kq, tkv.QuantPool(vq.payload.float().to(torch.float8_e5m2),
                                 vq.scale), tables, lens)


def _view16(t, offset_elems=0):
    """A copy of ``t`` whose base lies ``offset_elems`` elements past a
    64-byte boundary."""
    flat = torch.empty(t.numel() + 64, dtype=t.dtype)
    start = (-(flat.data_ptr() % 64) // t.element_size()) % 64 + offset_elems
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("hd,dtype,offset,want", [
    (8, torch.float32, 0, "hopper"),        # 32-byte head slices
    (64, torch.float32, 0, "hopper"),
    (64, torch.bfloat16, 0, "hopper"),
    (8, torch.bfloat16, 0, "hopper"),       # 16 bytes: the least slice
    (100, torch.float32, 0, "hopper"),      # 400 bytes
    (100, torch.bfloat16, 0, "warp"),       # 200 bytes
    (6, torch.float32, 0, "warp"),          # 24 bytes
    (64, torch.float32, 1, "warp"),         # base 4 bytes off the grid
    (64, torch.bfloat16, 8, "hopper"),      # base 16 bytes off: aligned
    (64, torch.bfloat16, 4, "warp"),        # base 8 bytes off
])
def test_kernel_form_by_alignment(hd, dtype, offset, want):
    pool = _view16(torch.randn(6, BS, H, hd).to(dtype), offset)
    other = _view16(torch.randn(6, BS, H, hd).to(dtype))
    assert tfd.kernel_form(pool, other) == want
    assert tfd.kernel_form(other, pool) == want
    assert tfd.kernel_form(other, other) == (
        "hopper" if (hd * pool.element_size()) % 16 == 0 else "warp")


@pytest.mark.parametrize("hd,bs,offset,want", [
    (64, 4, 0, "hopper"),
    (16, 16, 0, "hopper"),
    (8, 4, 0, "warp"),        # 8-byte e4m3 head slices
    (100, 4, 0, "warp"),      # 100 bytes
    (64, 6, 0, "warp"),       # scale rows of 24 bytes
    (64, 4, 2, "warp"),       # a scale base 8 bytes off the grid
])
def test_kernel_form_fp8_pools(hd, bs, offset, want):
    pay = torch.randn(6, bs, H, hd).to(torch.float8_e4m3fn)
    scale = _view16(torch.rand(6, bs), offset)
    kq = tkv.QuantPool(pay, scale)
    vq = tkv.QuantPool(pay.clone(), _view16(torch.rand(6, bs)))
    assert tfd.kernel_form(kq, vq) == want


def test_kernel_form_refuses_a_stage_past_the_ring():
    """One head's ring stage (K and V rows of one table entry) must fit
    64 KB: a 256-wide f32 head with 64-position blocks takes 128 KB."""
    pool = torch.randn(2, 64, 1, 256)
    assert tfd.kernel_form(pool, pool) == "warp"
    assert tfd.kernel_form(pool[:, :32].contiguous(),
                           pool[:, :32].contiguous()) == "hopper"


def test_form_argument_is_validated_on_cpu():
    """``form=`` forces an allowed form (the CPU runs the plain version
    either way) and refuses one the operands do not allow; no form
    stands in for another, and nothing is counted on the CPU."""
    q, kp, vp, tables, lens = _torch(_setup(3, [9, 4]))
    fd = tfd.flash_decode_attention
    before = (fd.launches, dict(fd.launches_by_form))
    ref = tfd.flash_decode_attention_ref(q, kp, vp, tables, lens)
    for form in (None, "warp", "hopper"):
        assert torch.equal(fd(q, kp, vp, tables, lens, form=form), ref)
    mis = _view16(kp, 1)
    with pytest.raises(MXNetError, match="form 'hopper'"):
        fd(q, mis, vp, tables, lens, form="hopper")
    with pytest.raises(MXNetError, match="form 'fast'"):
        fd(q, kp, vp, tables, lens, form="fast")
    assert torch.equal(fd(q, mis, vp, tables, lens, form="warp"), ref)
    assert (fd.launches, fd.launches_by_form) == before


@pytest.mark.parametrize("args,want", [
    # the served decode shape: every pool type takes all 8 heads a block
    # (one contiguous copy an entry); f32's 64 KB stages leave one block
    # an SM and 2 parts a split, bf16 and fp8 two blocks and 4 parts
    ((8, 8, 64, 16, 4, False, 8, 8), (8, 2, 4, 2)),
    ((8, 8, 64, 16, 2, False, 8, 8), (8, 4, 2, 2)),
    ((8, 8, 64, 16, 1, True, 8, 8), (8, 4, 2, 2)),
    # 8192 positions a request: longer parts, deeper rings
    ((8, 8, 64, 16, 4, False, 8, 64), (8, 2, 32, 2)),
    ((8, 8, 64, 16, 2, False, 8, 64), (8, 4, 16, 3)),
    ((8, 8, 64, 16, 1, True, 8, 64), (8, 4, 16, 4)),
    # a 256-wide f32 head: one head a block (32 KB stages)
    ((5, 3, 256, 16, 4, False, 3, 7), (1, 4, 2, 2)),
    # one request, one split: no more parts than columns
    ((1, 8, 64, 16, 4, False, 1, 1), (8, 1, 1, 1)),
    # a split of 5000 columns is cut to at most 2048 a block
    ((64, 8, 64, 16, 4, False, 1, 5000), (8, 3, 1667, 2)),
])
def test_hopper_plan(args, want):
    group, parts, entries, stages = got = tfd.hopper_plan(*args)
    assert got == want
    b, h, hd, bs, esize, quantized, splits, bps = args
    assert h % group == 0 and 1 <= group <= 8
    assert (parts - 1) * entries < bps <= parts * entries
    assert entries <= 2048 and 1 <= stages <= 4
    stage = 2 * bs * group * hd * esize + (8 * bs if quantized else 0)
    assert stage <= 64 << 10 and stages * stage <= 128 << 10


def test_scratch_is_one_allocation():
    acc, m, l = tfd._scratch(3, 5, 4, 8, "cpu")
    assert (acc.shape, m.shape, l.shape) == ((3, 5, 4, 8), (3, 5, 4),
                                             (3, 5, 4))
    assert acc.is_contiguous() and m.is_contiguous() and l.is_contiguous()
    base = acc.untyped_storage().data_ptr()
    assert m.untyped_storage().data_ptr() == base == \
        l.untyped_storage().data_ptr()
    assert m.data_ptr() == acc.data_ptr() + acc.numel() * 4
    assert l.data_ptr() == m.data_ptr() + m.numel() * 4
