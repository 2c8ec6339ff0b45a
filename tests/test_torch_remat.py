"""Recompute scopes of the PyTorch port (``graph_eval.eval_symbol``:
``remat_scope`` runs and ``force_mirroring`` nodes under
``torch.utils.checkpoint``) against the port without scopes and against
the JAX package's ``jax.checkpoint`` scopes, on the CPU.

* ``transformer_lm(remat=True)``: heads and parameters after SGD steps
  BITWISE equal to the port's ``remat=False`` (the recompute repeats the
  same operations), and within the trainer tolerance of the JAX
  package's ``remat=True`` trainer (heads rtol 1e-4, parameters rtol
  1e-4 / atol 1e-6: XLA's and ATen's summation order).
* A Dropout inside a scope draws its mask from the node's generator
  inside the recomputed function: the recompute's mask equals the
  forward's (``nn_ops.dropout_mask`` recorded), and the step equals the
  scope-free step bitwise.
* BatchNorm's moving statistics in a scope are updated once: equal to
  the scope-free trainer's after each step, bitwise.
* ``force_mirroring`` on one node: bitwise the plain step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.attribute import AttrScope
from mxnet_tpu_torch.ops import nn_ops as tnn
from mxnet_tpu_torch.parallel import ShardedTrainer

V, NL, D, H, B, S = 61, 2, 32, 2, 2, 128
SGD = {"learning_rate": 0.05, "momentum": 0.9}


@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


def _lm_both(remat):
    kw = dict(vocab_size=V, num_layers=NL, d_model=D, heads=H,
              batch_size=B, seq_len=S, loss_head=True, attn_block_size=64,
              remat=remat)
    with mx.name.NameManager(), mxt.name.NameManager():
        return (jmodels.get_symbol("transformer-lm", **kw),
                tmodels.get_symbol("transformer-lm", **kw))


def _params(sym, shapes, seed=0):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: ((1.0 + 0.1 * rng.randn(*s)) if n.endswith("_gamma")
                else 0.1 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _lm_batches(n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.randint(0, V, (B, S + 1))
        out.append({"data": t[:, :-1].astype(np.float32),
                    "softmax_label": t[:, 1:].astype(np.float32)})
    return out


def _port(sym, args, **kw):
    tr = ShardedTrainer(sym, "sgd", dict(SGD), device="cpu", **kw)
    return tr.bind({"data": (B, S)}, {"softmax_label": (B, S)},
                   arg_params=args)


def test_lm_remat_is_bitwise_the_plain_lm_and_matches_jax():
    (js, ts), (_, tplain) = _lm_both(True), _lm_both(False)
    assert '"__remat_scope__": "layer0"' in ts.tojson()
    args = _params(ts, dict(data=(B, S), softmax_label=(B, S)))
    tr, plain = _port(ts, args), _port(tplain, args)
    jt = JaxTrainer(js, optimizer="sgd", optimizer_params=dict(SGD),
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    jt.bind({"data": (B, S)}, {"softmax_label": (B, S)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()})
    for i, batch in enumerate(_lm_batches(2)):
        th, ph = tr.step(batch)[0], plain.step(batch)[0]
        jh = np.asarray(jt.step(batch)[0])
        assert torch.equal(th, ph), f"heads, step {i}"
        np.testing.assert_allclose(th.numpy(), jh, rtol=1e-4, atol=0)
    jargs = jt.get_params()[0]
    for n, p in tr._params.items():
        assert torch.equal(p, plain._params[n]), n
        np.testing.assert_allclose(p.detach().numpy(), jargs[n].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def _scoped_net(op, scope=True, mirror=False):
    """data -> fc1 -> op -> fc2 -> softmax, fc1..fc2 in one remat scope
    (or the op alone force-mirrored)."""
    S_ = tsym
    with mxt.name.NameManager():
        data = S_.Variable("data")
        with (AttrScope(remat_scope="block") if scope else AttrScope()):
            net = S_.FullyConnected(data, num_hidden=16, name="fc1")
            with (AttrScope(force_mirroring="True") if mirror
                  else AttrScope()):
                net = op(net)
            net = S_.FullyConnected(net, num_hidden=4, name="fc2")
        return S_.SoftmaxOutput(net, name="softmax")


def _small(sym, seed=3, **kw):
    rng = np.random.RandomState(seed)
    args = {"fc1_weight": 0.3 * rng.randn(16, 8), "fc1_bias": np.zeros(16),
            "fc2_weight": 0.3 * rng.randn(4, 16), "fc2_bias": np.zeros(4)}
    args = {k: np.asarray(v, np.float32) for k, v in args.items()}
    if "bn_gamma" in sym.list_arguments():
        args.update(bn_gamma=np.ones(16, np.float32),
                    bn_beta=np.zeros(16, np.float32))
    tr = ShardedTrainer(sym, "sgd", dict(SGD), device="cpu", seed=11, **kw)
    return tr.bind({"data": (32, 8)}, {"softmax_label": (32,)},
                   arg_params=args)


def _small_batches(n, seed=4):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(32, 8).astype(np.float32),
             "softmax_label": rng.randint(0, 4, 32).astype(np.float32)}
            for _ in range(n)]


def test_dropout_in_a_scope_recomputes_its_mask(monkeypatch):
    masks = []
    real = tnn.dropout_mask

    def recording(x, keep, generator):
        m = real(x, keep, generator)
        masks.append(m.clone())
        return m

    monkeypatch.setattr(tnn, "dropout_mask", recording)

    def drop(x):
        return tsym.Dropout(x, p=0.5, name="drop")

    scoped, plain = (_small(_scoped_net(drop, scope=s)) for s in (True,
                                                                   False))
    for batch in _small_batches(3):
        masks.clear()
        hs = scoped.step(batch)[0]
        assert len(masks) == 2          # the forward and the recompute
        assert torch.equal(masks[0], masks[1])
        assert 0.3 < masks[0].float().mean().item() < 0.7
        masks.clear()
        hp = plain.step(batch)[0]
        assert len(masks) == 1
        assert torch.equal(hs, hp)
    for n, p in scoped._params.items():
        assert torch.equal(p, plain._params[n]), n


def test_batchnorm_in_a_scope_updates_its_statistics_once():
    def bn(x):
        return tsym.BatchNorm(x, name="bn", fix_gamma=False)

    scoped, plain = (_small(_scoped_net(bn, scope=s)) for s in (True,
                                                                 False))
    assert sorted(scoped._aux) == ["bn_moving_mean", "bn_moving_var"]
    for batch in _small_batches(3):
        assert torch.equal(scoped.step(batch)[0], plain.step(batch)[0])
        for n, v in scoped._aux.items():
            assert torch.equal(v, plain._aux[n]), n
    # updated, and once a step: 0.9 momentum moved the mean off zero by
    # what one update of three steps gives
    assert scoped._aux["bn_moving_mean"].abs().sum() > 0


def test_force_mirroring_one_node_is_bitwise_the_plain_step():
    def act(x):
        return tsym.Activation(x, act_type="tanh", name="act")

    mirrored = _small(_scoped_net(act, scope=False, mirror=True))
    plain = _small(_scoped_net(act, scope=False))
    node = [n for n in mirrored.symbol._topo() if n.name == "act"][0]
    assert node.anno_attrs()["force_mirroring"] == "True"
    for batch in _small_batches(3):
        assert torch.equal(mirrored.step(batch)[0], plain.step(batch)[0])
    for n, p in mirrored._params.items():
        assert torch.equal(p, plain._params[n]), n
