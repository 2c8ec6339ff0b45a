"""Flash attention of the PyTorch port (mxnet_tpu_torch/parallel/
flash_attention.py, ring_attention.py) against the JAX package on the CPU.

Where ``kernel_ok`` admits a shape, the port runs the plain versions of
kernels K3/K4 (``flash_fwd_ref``/``flash_bwd_ref``) on CPU tensors; they
are held against the JAX functions with ``interpret=True``, which run the
Pallas kernels' own decomposition (forward kernel, dq and dk/dv kernels
under the ``custom_vjp``).  The JAX side is given ``block_k`` equal to the
port's key tile, so the online softmax walks the same tiles.  Shapes that
fail ``kernel_ok`` take the blockwise or dense path on both sides.

Tolerances (as in tests/test_flash_attention.py for f32): forward and
``lse`` within rtol/atol 2e-5, gradients of ``sum(y cos y)`` within 2e-4
(summation order of XLA and ATen).  bf16: within 2e-2 relative to
``1 + |ref|`` (two bf16 units in the last place: ``p`` and ``ds`` are
rounded to bf16 inside, and a value on a rounding boundary may round
either way after an f32 summation-order difference).  Inputs are made
with numpy and pinned to f32/bf16 on both sides (importing mxnet_tpu
enables x64).
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu  # noqa: F401  (x64 on, as in every parity test)
from mxnet_tpu.parallel import flash_attention as jfa

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import flash_attention as tfa
# the port's `parallel.ring_attention` attribute is the function, as
# the JAX package's is: the module comes from sys.modules
tra = sys.modules["mxnet_tpu_torch.parallel.ring_attention"]

# the JAX package's `parallel.ring_attention` attribute is the function
jra = sys.modules["mxnet_tpu.parallel.ring_attention"]

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype, tol32, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol32, atol=tol32,
                                   err_msg=what)
    else:
        err = (np.abs(got - want) / (1.0 + np.abs(want))).max()
        assert err <= 2e-2, f"{what}: {err}"


def _arrays(rng, shapes, scale=1.0):
    return [(scale * rng.randn(*s)).astype(np.float32) for s in shapes]


def _jax_grads(fn, arrays, jdt):
    def loss(*xs):
        y = fn(*xs).astype(jnp.float32)
        return jnp.sum(y * jnp.cos(y))
    xs = [jnp.asarray(a).astype(jdt) for a in arrays]
    y = fn(*xs)
    return y, jax.grad(loss, argnums=tuple(range(len(xs))))(*xs)


def _torch_grads(fn, arrays, tdt):
    xs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays]
    y = fn(*xs)
    yf = y.float()
    (yf * torch.cos(yf)).sum().backward()
    return y.detach(), [x.grad for x in xs]


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_flash_attention_matches_jax_interpret(layout, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    b, h, l, d = 1, 2, 128, 16
    shape = (b, h, l, d) if layout == "bhld" else (b, l, h, d)
    qkv = _arrays(np.random.RandomState(2 * (layout == "blhd") + causal),
                  [shape] * 3)
    tile = tfa.kernel_tile(d)
    jy, jg = _jax_grads(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=causal, block_k=tile, interpret=True,
        layout=layout), qkv, jdt)
    before = tfa.flash_fwd.launches, tfa.flash_bwd.launches
    ty, tg = _torch_grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, causal=causal, layout=layout), qkv, tdt)
    assert ty.dtype == tdt
    # CPU tensors run the plain versions: no launch is counted
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches) == before
    _close(_f32(ty), _f32(jy), dtype, 2e-5, "out")
    for n, a, e in zip("qkv", tg, jg):
        assert a.dtype == tdt
        _close(_f32(a), _f32(e), dtype, 2e-4, f"d{n}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cross_attention_lq_ne_lk(dtype):
    jdt, tdt = DTYPES[dtype]
    qkv = _arrays(np.random.RandomState(4),
                  [(1, 64, 2, 32), (1, 192, 2, 32), (1, 192, 2, 32)])
    jy, jg = _jax_grads(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=False, block_k=64, interpret=True, layout="blhd"),
        qkv, jdt)
    ty, tg = _torch_grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, causal=False, layout="blhd"), qkv, tdt)
    _close(_f32(ty), _f32(jy), dtype, 2e-5, "out")
    for n, a, e in zip("qkv", tg, jg):
        _close(_f32(a), _f32(e), dtype, 2e-4, f"d{n}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_stats_matches_jax_interpret(causal):
    # l = 64: the key tile of the port and the JAX block are both 64
    q, k, v = (jnp.asarray(a) for a in _arrays(
        np.random.RandomState(5), [(2, 2, 64, 16)] * 3))
    jo, jl = jfa.flash_attention_stats(q, k, v, causal=causal,
                                       interpret=True)
    to, tl = tfa.flash_attention_stats(
        *(torch.tensor(np.asarray(a)) for a in (q, k, v)), causal=causal)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 2, 64)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("external_delta", [False, True],
                         ids=["delta_from_out", "external_delta"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_block_bwd_matches_jax_interpret(causal,
                                                         external_delta):
    rng = np.random.RandomState(6 + causal)
    q, k, v, do = _arrays(rng, [(1, 2, 128, 16)] * 4)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jl = jfa.flash_attention_stats(jq, jk, jv, causal=causal,
                                       interpret=True)
    delta = None
    if external_delta:
        delta = (0.5 * rng.randn(1, 2, 128)).astype(np.float32)
    want = jfa.flash_attention_block_bwd(
        jq, jk, jv, jo, jl, jdo, causal=causal, interpret=True,
        delta=None if delta is None else jnp.asarray(delta))
    got = tfa.flash_attention_block_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jl)),
        torch.from_numpy(do), causal=causal,
        delta=None if delta is None else torch.from_numpy(delta))
    for n, a, e in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{n}")


# shapes that fail kernel_ok: (q shape, k shape, causal, block_k)
FALLBACKS = {
    "no_block_divisor_dense": ((1, 2, 100, 16), (1, 2, 100, 16), True,
                               None),
    "small_block_blockwise": ((1, 2, 96, 16), (1, 2, 96, 16), True, 32),
    "causal_lq_ne_lk_blockwise": ((1, 2, 64, 16), (1, 2, 128, 16), True,
                                  None),
    "head_dim_over_256": ((1, 1, 64, 272), (1, 1, 64, 272), False, None),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_flash_attention_fallback_paths_match_jax(case):
    qs, ks, causal, bk = FALLBACKS[case]
    qkv = _arrays(np.random.RandomState(len(case)), [qs, ks, ks], 0.5)
    jy, jg = _jax_grads(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=causal, block_k=bk), qkv, jnp.float32)
    dense0 = tra.local_attention.dense_calls
    blockwise0 = tra.blockwise_attention.calls
    ty, tg = _torch_grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, causal=causal, block_k=bk), qkv, torch.float32)
    dense = tra.local_attention.dense_calls - dense0
    blockwise = tra.blockwise_attention.calls - blockwise0
    assert (dense, blockwise) == ((1, 0) if case.endswith("dense")
                                  else (0, 1))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    for n, a, e in zip("qkv", tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{n}")


def test_stats_and_block_bwd_fallbacks_match_jax():
    """l = 100 has no block: both take the blockwise stats and the plain
    block backward."""
    rng = np.random.RandomState(8)
    q, k, v, do = _arrays(rng, [(1, 2, 100, 8)] * 4)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jl = jfa.flash_attention_stats(jq, jk, jv, causal=True)
    to, tl = tfa.flash_attention_stats(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    want = jfa.flash_attention_block_bwd(jq, jk, jv, jo, jl, jdo,
                                         causal=True)
    got = tfa.flash_attention_block_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)), to, tl,
        torch.from_numpy(do), causal=True)
    for n, a, e in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{n}")


@pytest.mark.parametrize("block_size", [None, 0, 64])
@pytest.mark.parametrize("offsets", [False, True])
def test_local_and_blockwise_attention_match_jax(block_size, offsets):
    q, k, v = _arrays(np.random.RandomState(9), [(1, 2, 128, 16)] * 3)
    kw = dict(causal=True, block_size=block_size)
    if offsets:
        kw.update(q_offset=128, kv_offset=64)
    want = jra.local_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    got = tra.local_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_blockwise_attention_with_stats_matches_jax():
    q, k, v = _arrays(np.random.RandomState(10), [(2, 1, 64, 8)] * 3)
    jo, jl = jra.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     16, causal=True, return_stats=True)
    to, tl = tra.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), 16, causal=True,
        return_stats=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="divisible"):
        tra.blockwise_attention(torch.zeros(1, 1, 8, 4),
                                torch.zeros(1, 1, 10, 4),
                                torch.zeros(1, 1, 10, 4), 4)


@pytest.mark.parametrize("bad, match", [
    (dict(q=torch.zeros(1, 2, 64, 8, dtype=torch.float64)),
     "float32 or bfloat16"),
    (dict(k=torch.zeros(1, 3, 64, 8), v=torch.zeros(1, 3, 64, 8)),
     "k has shape"),
    (dict(q=torch.zeros(1, 1, 64, 300), k=torch.zeros(1, 1, 64, 300),
          v=torch.zeros(1, 1, 64, 300)), "head_dim"),
    (dict(causal=True, q=torch.zeros(1, 2, 32, 8)), "Lq == Lk"),
    (dict(layout="lbhd"), "layout"),
])
def test_kernel_wrappers_reject(bad, match):
    kw = dict(q=torch.zeros(1, 2, 64, 8), k=torch.zeros(1, 2, 64, 8),
              v=torch.zeros(1, 2, 64, 8), causal=False, scale=0.5,
              layout="bhld")
    kw.update(bad)
    with pytest.raises(MXNetError, match=match):
        tfa.flash_fwd(kw.pop("q"), kw.pop("k"), kw.pop("v"), **kw)


def test_bwd_wrapper_checks_row_statistics():
    q = torch.zeros(1, 2, 64, 8)
    with pytest.raises(MXNetError, match="lse must be"):
        tfa.flash_bwd(q, q, q, q, torch.zeros(1, 2, 63), q, causal=False,
                      scale=0.5)
    with pytest.raises(MXNetError, match="delta must be"):
        tfa.flash_bwd(q, q, q, q, torch.zeros(1, 2, 64), q, causal=False,
                      scale=0.5, delta=torch.zeros(2, 64))


def _aligned(shape, dtype, offset=0):
    """A contiguous tensor ``offset`` elements into a fresh buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


# (dtype, head dim, element offset of k) -> the form kernel_form picks
FORMS = [
    (torch.bfloat16, 64, 0, "hopper"), (torch.bfloat16, 128, 0, "hopper"),
    (torch.bfloat16, 64, 1, "mma"), (torch.bfloat16, 128, 3, "mma"),
    (torch.bfloat16, 8, 0, "mma"), (torch.bfloat16, 32, 0, "mma"),
    (torch.bfloat16, 100, 0, "mma"), (torch.bfloat16, 256, 0, "fma"),
    (torch.bfloat16, 160, 0, "fma"), (torch.float32, 64, 0, "fma"),
    (torch.float32, 128, 0, "fma"), (torch.float32, 16, 0, "fma"),
]


@pytest.mark.parametrize("dtype, d, offset, form", FORMS,
                         ids=[f"{str(f[0])[6:]}-d{f[1]}-off{f[2]}"
                              for f in FORMS])
def test_kernel_form_picks_by_type_head_dim_and_alignment(dtype, d, offset,
                                                          form):
    """hopper only when every tensor given starts on a 16-byte boundary:
    an aligned q beside a misaligned k does not qualify."""
    q = _aligned((1, 2, 64, d), dtype)
    k = _aligned((1, 2, 64, d), dtype, offset)
    assert q.data_ptr() % 16 == 0 and (k.data_ptr() % 16 == 0) == (
        offset == 0)
    assert tfa.kernel_form(dtype, d, q, k) == form


# (dtype, head dim, element offset, form) that the wrappers refuse
REFUSED = [
    (torch.float32, 64, 0, "hopper"), (torch.float32, 64, 0, "mma"),
    (torch.bfloat16, 32, 0, "hopper"), (torch.bfloat16, 100, 0, "hopper"),
    (torch.bfloat16, 64, 1, "hopper"), (torch.bfloat16, 256, 0, "mma"),
    (torch.bfloat16, 256, 0, "hopper"), (torch.bfloat16, 64, 0, "wgmma"),
]


@pytest.mark.parametrize("dtype, d, offset, form", REFUSED,
                         ids=[f"{str(f[0])[6:]}-d{f[1]}-off{f[2]}-{f[3]}"
                              for f in REFUSED])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_kernel_wrappers_refuse_a_form_the_operands_do_not_allow(
        which, dtype, d, offset, form):
    q, k, v, out, do = (_aligned((1, 2, 64, d), dtype, offset)
                        for _ in range(5))
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(MXNetError, match=f"form {form!r}"):
        if which == "fwd":
            tfa.flash_fwd(q, k, v, causal=True, scale=0.5, form=form)
        else:
            tfa.flash_bwd(q, k, v, out, lse, do, causal=True, scale=0.5,
                          form=form)


@pytest.mark.parametrize("form", ["hopper", "mma", "fma"])
def test_allowed_forms_run_the_plain_versions_on_cpu(form):
    """A form the operands allow is accepted on CPU tensors, which run
    the plain versions whatever the form (no launch is counted)."""
    rng = np.random.RandomState(12)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 64, 64).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, scale=0.125)
    counts = (dict(tfa.flash_fwd.launches_by_form),
              dict(tfa.flash_bwd.launches_by_form))
    out, lse = tfa.flash_fwd(q, k, v, form=form, **kw)
    grads = tfa.flash_bwd(q, k, v, out, lse, do, form=form, **kw)
    ref_out, ref_lse = tfa.flash_fwd_ref(q, k, v, **kw)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    for g, r in zip(grads, tfa.flash_bwd_ref(q, k, v, out, lse, do, **kw)):
        assert torch.equal(g, r)
    assert (tfa.flash_fwd.launches_by_form,
            tfa.flash_bwd.launches_by_form) == counts


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_versions_with_internal_delta_match_jax_kernels_bf16(causal):
    """At a shape the hopper form takes (bf16, D 64, tiles of 64), the
    plain versions, with ``delta`` computed inside, against the JAX
    package's forward and backward Pallas kernels in interpret mode."""
    rng = np.random.RandomState(13 + causal)
    q, k, v, do = _arrays(rng, [(1, 2, 128, 64)] * 4)
    scale = 0.125
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)[0]
                       for a in (q, k, v, do))
    jout, jlse8 = jfa._flash_fwd_pallas(jq, jk, jv, causal, scale, 64, 64,
                                        interpret=True)
    jlse = jlse8[:, 0, :]
    jgrads = jfa._flash_bwd_pallas(jq, jk, jv, jout, jlse, jdo, causal,
                                   scale, 64, 64, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    tout, tlse = tfa.flash_fwd_ref(tq, tk, tv, causal=causal, scale=scale)
    _close(_f32(tout[0]), _f32(jout), "bfloat16", 0, "out")
    np.testing.assert_allclose(tlse[0].numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)
    tgrads = tfa.flash_bwd_ref(tq, tk, tv, tout, tlse, tdo, causal=causal,
                               scale=scale)
    for n, a, e in zip("qkv", tgrads, jgrads):
        assert a.dtype == torch.bfloat16
        _close(_f32(a[0]), _f32(e), "bfloat16", 0, f"d{n}")


def test_mesh_is_not_ported():
    """A sequence mesh can be made and scoped, and ring attention over it
    is ported (tests/test_torch_ring.py): ``ring_self_attention`` over
    two CPU contexts equals the JAX ring over two devices (and dense
    attention); ``ring_attention`` itself runs only inside a mesh
    member's step."""
    from mxnet_tpu_torch.parallel import current_mesh, default_mesh, \
        make_mesh
    mesh = make_mesh({"seq": 2}, [mxt.cpu(0), mxt.cpu(1)])
    assert mesh.shape == {"seq": 2}
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(1, 2, 16, 4).astype(np.float32) for _ in range(3))
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    jmesh = jmake_mesh({"seq": 2}, jax.devices()[:2])
    want = jra.ring_self_attention(*map(jnp.asarray, (q, k, v)), jmesh,
                                   causal=True)
    with default_mesh(mesh):
        assert current_mesh() is mesh
        got = tra.ring_self_attention(*map(torch.from_numpy, (q, k, v)),
                                      mesh, causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
        with pytest.raises(MXNetError, match="inside a mesh member"):
            tra.ring_attention(*map(torch.from_numpy, (q, k, v)))
