"""Ring attention in the PyTorch port (``parallel/ring_attention.py``'s
ring functions, the ``RingAttention`` op under a ``seq`` mesh,
``ShardedTrainer`` over ``seq`` axes) against the JAX package, after
``tests/test_ring_attention.py``, ``tests/test_ring_flash.py`` and
``tests/test_transformer_sp.py``.

The port's meshes are CPU contexts ``cpu(0)`` ... ``cpu(7)``; the JAX
side runs on the 8 virtual CPU devices ``tests/conftest.py`` gives it.
On the CPU the flash ring's steps take the plain versions of K3 and K4
(``flash_fwd_ref``, ``flash_bwd_ref``).

Tolerances, as stated in each test: the ring against one device's dense
attention and against the JAX ring, ``test_ring_attention.py``'s rtol
2e-5 / atol 2e-5 (outputs) and 5e-5 (gradients); the flash ring
``test_ring_flash.py``'s rtol 2e-4 / atol 2e-5 and, for gradients, rtol
3e-4 / atol 3e-5; trainers ``test_transformer_sp.py``'s rtol 2e-4 /
atol 2e-4.
"""
import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu import random as jrandom
from mxnet_tpu._compat import shard_map
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import (ShardedTrainer, default_mesh,
                                      make_mesh, ring_attention,
                                      ring_self_attention)
from mxnet_tpu_torch.parallel import flash_attention as tfa

# ``parallel.ring_attention`` is the function in both packages
jra = sys.modules["mxnet_tpu.parallel.ring_attention"]
tra = sys.modules["mxnet_tpu_torch.parallel.ring_attention"]

RING = dict(rtol=2e-5, atol=2e-5)
RING_GRAD = dict(rtol=5e-5, atol=5e-5)
FLASH = dict(rtol=2e-4, atol=2e-5)
FLASH_GRAD = dict(rtol=3e-4, atol=3e-5)
TRAIN = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


@pytest.fixture(autouse=True)
def _keep_port_random_state():
    """Restore the port's global key sequence and device generators after
    the test, so the test files that run after this one in the same
    process draw what they would draw without it."""
    from mxnet_tpu_torch import random as port_random
    saved = dict(port_random._state)
    gens = {d: g.get_state() for d, g in port_random._generators.items()}
    yield
    port_random._state.update(saved)
    for d in list(port_random._generators):
        if d in gens:
            port_random._generators[d].set_state(gens[d])
        else:
            del port_random._generators[d]


def tmesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, [mxt.cpu(i) for i in range(n)])


def jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(axes, jax.devices()[:n])


def _qkv(b=2, h=3, l=32, d=8, seed=0, scale=0.5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, h, l, d) * scale).astype(np.float32)
            for _ in range(3)]


def _port_grads(fn, arrays, loss):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    loss(out).backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_ring_self_attention_matches_local_and_jax(sp, causal):
    """``ring_self_attention`` over ``{"seq": sp}`` (shards of 32 / sp
    positions: the dense per-step ring) against one device's
    ``local_attention`` and against the JAX ring over ``sp`` devices,
    with the gradients of ``sum(out^2)``."""
    arrays = _qkv(b=1, h=2, l=32, d=4, seed=3)
    mesh = tmesh({"seq": sp})
    out, grads = _port_grads(
        lambda q, k, v: ring_self_attention(q, k, v, mesh, causal=causal),
        arrays, lambda o: (o ** 2).sum())
    ref, rgrads = _port_grads(
        lambda q, k, v: tra.local_attention(q, k, v, causal=causal),
        arrays, lambda o: (o ** 2).sum())
    jm = jmesh({"seq": sp})

    def jloss(q, k, v):
        o = jra.ring_self_attention(q, k, v, jm, causal=causal)
        return (o ** 2).sum(), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(out, ref, **RING)
    np.testing.assert_allclose(out, np.asarray(jout), **RING)
    for n, g, r, j in zip("qkv", grads, rgrads, jgrads):
        np.testing.assert_allclose(g, r, **RING_GRAD, err_msg=f"d{n}")
        np.testing.assert_allclose(g, np.asarray(j), **RING_GRAD,
                                   err_msg=f"d{n} (JAX)")


def _jax_ring(mesh, causal):
    spec = JP(None, None, "seq", None)
    return shard_map(functools.partial(jra.ring_attention, axis_name="seq",
                                       causal=causal),
                     mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sp", [2, 4])
def test_flash_ring_matches_dense(sp, causal):
    """L = 256 over ``sp`` members: each shard (128 or 64 positions)
    admits the flash ring, whose steps run the plain versions of K3 and
    K4 here; output and the gradients of ``sum(tanh(out))`` against dense
    attention and the JAX flash ring.  No dense attention runs."""
    arrays = _qkv(b=2, h=2, l=256, d=32, seed=0, scale=0.3)
    mesh = tmesh({"seq": sp})
    dense0 = tra.local_attention.dense_calls
    blocks0 = tra.blockwise_attention.calls
    out, grads = _port_grads(
        lambda q, k, v: ring_self_attention(q, k, v, mesh, causal=causal),
        arrays, lambda o: torch.tanh(o).sum())
    assert tra.local_attention.dense_calls == dense0
    assert tra.blockwise_attention.calls == blocks0
    ref, rgrads = _port_grads(
        lambda q, k, v: tra.local_attention(q, k, v, causal=causal),
        arrays, lambda o: torch.tanh(o).sum())
    np.testing.assert_allclose(out, ref, **FLASH)
    for n, g, r in zip("qkv", grads, rgrads):
        np.testing.assert_allclose(g, r, **FLASH_GRAD, err_msg=f"d{n}")
    fn = _jax_ring(jmesh({"seq": sp}), causal)
    jq = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(out, np.asarray(jax.jit(fn)(*jq)), **FLASH)
    if sp == 4:
        jgrads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jnp.tanh(
            fn(q, k, v))), argnums=(0, 1, 2)))(*jq)
        for n, g, j in zip("qkv", grads, jgrads):
            np.testing.assert_allclose(g, np.asarray(j), **FLASH_GRAD,
                                       err_msg=f"d{n} (JAX)")


def test_flash_ring_merges_per_step_statistics(monkeypatch):
    """The flash ring calls ``flash_attention_stats`` once a visiting
    block it attends (a causal ring skips the later blocks: member ``r``
    attends ``r + 1`` of the 4, 10 calls in all) and
    ``flash_attention_block_bwd`` as often, each with the global
    ``delta``."""
    calls = {"stats": 0, "bwd": 0, "delta": 0}
    stats, block_bwd = tfa.flash_attention_stats, tfa.flash_attention_block_bwd

    def counting_stats(*a, **kw):
        calls["stats"] += 1
        return stats(*a, **kw)

    def counting_bwd(*a, **kw):
        calls["bwd"] += 1
        calls["delta"] += kw.get("delta") is not None
        return block_bwd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_stats", counting_stats)
    monkeypatch.setattr(tfa, "flash_attention_block_bwd", counting_bwd)
    arrays = _qkv(b=1, h=1, l=256, d=16, seed=2)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = ring_self_attention(*ts, tmesh({"seq": 4}), causal=True)
    out.sum().backward()
    assert calls == {"stats": 10, "bwd": 10, "delta": 10}


def test_tiny_shards_take_the_dense_fallback():
    """``test_ring_flash.py``'s tiny shards (16 positions at sp = 4,
    under the kernel's block floor): the dense per-step ring, exact
    against dense attention."""
    arrays = _qkv(b=2, h=2, l=64, d=32, seed=0, scale=0.3)
    ts = [torch.tensor(a) for a in arrays]
    out = ring_self_attention(*ts, tmesh({"seq": 4}), batch_axis=None,
                              causal=True)
    ref = tra.local_attention(*ts, causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-6)
    assert not tra._flash_gate(ts[0][:, :, :16], ts[1][:, :, :16],
                               ts[2][:, :, :16], None, tra.NEG_INF)
    assert tra._flash_gate(ts[0], ts[1], ts[2], None, tra.NEG_INF)
    assert not tra._flash_gate(ts[0], ts[1], ts[2], None, -1e9)


def test_data_seq_mesh_shards_the_batch():
    """``{"data": 2, "seq": 2}``: the batch cut over ``data`` and the
    sequence over ``seq``; against dense attention and the JAX ring."""
    arrays = _qkv(b=4, h=2, l=32, d=8, seed=5)
    ts = [torch.tensor(a) for a in arrays]
    out = ring_self_attention(*ts, tmesh({"data": 2, "seq": 2}), causal=True)
    ref = tra.local_attention(*ts, causal=True)
    jout = jra.ring_self_attention(*map(jnp.asarray, arrays),
                                   jmesh({"data": 2, "seq": 2}), causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **RING)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **RING)


def test_ring_attention_outside_a_member_raises():
    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(MXNetError, match="inside a mesh member"):
        ring_attention(q, q, q)


def test_op_under_a_seq_mesh_matches_jax():
    """``RingAttention(layout="blhd", causal=True)`` through
    ``simple_bind`` under ``default_mesh({"seq": 4})`` (the op transposes
    to ``[B, H, L, D]`` and runs ``ring_self_attention``) against the
    JAX executor's single-device attention, forward and input
    gradients (the JAX executor binds its arguments to one device, so it
    runs the op without the mesh)."""
    from mxnet_tpu_torch import ndarray as tnd
    from mxnet_tpu import ndarray as jnd

    def net(S):
        return S.RingAttention(query=S.Variable("q"), key=S.Variable("k"),
                               value=S.Variable("v"), causal=True,
                               layout="blhd", name="att")
    rng = np.random.RandomState(6)
    vals = {n: rng.randn(2, 32, 2, 8).astype(np.float32) * 0.5
            for n in "qkv"}
    head = rng.randn(2, 32, 2, 8).astype(np.float32)
    shapes = {n: (2, 32, 2, 8) for n in "qkv"}
    jex = net(mx.symbol).simple_bind(mx.cpu(), **shapes)
    jout = jex.forward(is_train=True, **vals)[0].asnumpy()
    jex.backward([jnd.array(head)])
    dense0 = tra.local_attention.dense_calls
    with default_mesh(tmesh({"seq": 4})):
        tex = net(mxt.symbol).simple_bind(mxt.cpu(), **shapes)
        tout = tex.forward(is_train=True, **vals)[0].asnumpy()
        tex.backward([tnd.array(head, ctx=mxt.cpu())])
    assert tra.local_attention.dense_calls == dense0
    np.testing.assert_allclose(tout, jout, **RING)
    for n in "qkv":
        np.testing.assert_allclose(tex.grad_dict[n].asnumpy(),
                                   jex.grad_dict[n].asnumpy(), **RING_GRAD,
                                   err_msg=n)


def _lm(pkg, b, l):
    return pkg.get_symbol("transformer-lm", vocab_size=32, num_layers=2,
                          d_model=16, heads=2, batch_size=b, seq_len=l)


def _lm_run(trainer_cls, sym, mesh, args, batch, steps, jax_side):
    shapes = ({"data": batch["data"].shape},
              {"softmax_label": batch["data"].shape})
    if jax_side:
        t = trainer_cls(sym, optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1}, mesh=mesh)
        t.bind(*shapes, arg_params={k: jnp.asarray(v)
                                    for k, v in args.items()})
    else:
        t = trainer_cls(sym, "sgd", {"learning_rate": 0.1}, mesh=mesh)
        t.bind(*shapes, arg_params=args)
    out = None
    for _ in range(steps):
        out = t.step(batch)
    arg, _ = t.get_params()
    return np.asarray(out[0]), {n: v.asnumpy() for n, v in arg.items()}


@pytest.mark.parametrize("axes,b,l,steps", [
    ({"data": 2, "seq": 4}, 4, 32, 3), ({"seq": 8}, 2, 64, 2)])
def test_lm_trainer_over_seq_mesh(axes, b, l, steps):
    """``test_transformer_sp.py``'s LM (vocab 32, 2 layers, d 16, 2 heads)
    over a seq mesh: each seq group holds the same rows, its members run
    the ring over their shards and gather the outputs; every position's
    gradient is counted once.  Heads and parameters against one device
    (port) and against the JAX trainer on the same mesh."""
    with mx.name.NameManager(), mxt.name.NameManager():
        jsym, tsym = _lm(jmodels, b, l), _lm(tmodels, b, l)
    arg_shapes, _, _ = tsym.infer_shape(data=(b, l), softmax_label=(b, l))
    rng = np.random.RandomState(11)
    args = {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    rng = np.random.RandomState(0)
    x = rng.randint(0, 32, (b, l)).astype(np.float32)
    batch = {"data": x, "softmax_label": np.roll(x, -1, axis=1)}
    out_sp, p_sp = _lm_run(ShardedTrainer, tsym, tmesh(axes), args, batch,
                           steps, False)
    out_1, p_1 = _lm_run(ShardedTrainer, tsym, tmesh({"data": 1}), args,
                         batch, steps, False)
    out_j, p_j = _lm_run(JaxTrainer, jsym, jmesh(axes), args, batch, steps,
                         True)
    np.testing.assert_allclose(out_sp, out_1, **TRAIN)
    np.testing.assert_allclose(out_sp, out_j, **TRAIN)
    for n in p_1:
        np.testing.assert_allclose(p_sp[n], p_1[n], **TRAIN, err_msg=n)
        np.testing.assert_allclose(p_sp[n], p_j[n], **TRAIN, err_msg=n)
