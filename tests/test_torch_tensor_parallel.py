"""Tensor parallelism of the PyTorch port in one process
(``ShardedTrainer(rules=...)`` over ``{"data": D, "model": T}`` meshes of
CPU contexts) against the JAX package's ``tests/test_megatron_tp.py``,
the tensor-parallel test of ``tests/test_parallel.py``,
``tests/test_zero.py::test_zero_composes_with_megatron_tp`` and the JAX
trainer over the same virtual meshes.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
gives it (GSPMD partitions its one program); the port's members are as
many CPU contexts, each holding only its piece of every rule-sharded
parameter, meeting along the model axis by the plan the trainer records
(gather or split, ``parallel/tensor_parallel.py``).

Tolerances, as stated in each test:

* Megatron TP against one device (both packages): the JAX test's heads
  rtol 2e-4 / atol 2e-5 and parameters rtol 5e-4 / atol 5e-5;
* the port against the JAX trainer on the same mesh: heads rtol 1e-4 /
  atol 1e-5, parameters rtol 1e-4 / atol 1e-6 (f32 summation order of
  XLA's partitioned products against ATen's);
* the MLP rules test: the JAX test's rtol 2e-5 / atol 2e-6;
* a restored trainer against the one it was saved from: bitwise.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel import megatron_rules as jmegatron_rules

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import (PartitionSpec as P, ShardedTrainer,
                                      ShardingRules, collectives,
                                      make_mesh, megatron_rules)
# the port's `parallel.ring_attention` attribute is the function, as
# the JAX package's is: the module comes from sys.modules
tra = sys.modules["mxnet_tpu_torch.parallel.ring_attention"]

TP_HEAD = dict(rtol=2e-4, atol=2e-5)
TP_PARAM = dict(rtol=5e-4, atol=5e-5)
JAX_HEAD = dict(rtol=1e-4, atol=1e-5)
JAX_PARAM = dict(rtol=1e-4, atol=1e-6)
VOCAB, D_MODEL, B, L = 32, 16, 8, 8


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


def cpus(n):
    return [mxt.cpu(i) for i in range(n)]


def tmesh(axes):
    return make_mesh(axes, cpus(int(np.prod(list(axes.values())))))


def jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(axes, jax.devices()[:n])


def _lms(layers=2, heads=2, b=B, l=L):
    kw = dict(vocab_size=VOCAB, num_layers=layers, d_model=D_MODEL,
              heads=heads, batch_size=b, seq_len=l)
    with mx.name.NameManager(), mxt.name.NameManager():
        return (jmodels.get_symbol("transformer-lm", **kw),
                tmodels.get_symbol("transformer-lm", **kw))


def _init_params(sym, shapes, seed=11):
    """The JAX test's parameters: uniform(-0.1, 0.1) from ``seed``."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _lm_batches(steps, b=B, l=L, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        toks = rng.randint(0, VOCAB, (b, l)).astype(np.float32)
        out.append({"data": toks, "softmax_label": np.roll(toks, -1, 1)})
    return out


SGD = {"learning_rate": 0.2, "momentum": 0.9}


def _pair(jsym, tsym, axes, rules, args, b=B, l=L, opt="sgd",
          opt_params=SGD, **kw):
    """The JAX and the port trainer over meshes of ``axes``, bound with
    the same parameters."""
    shapes = ({"data": (b, l)}, {"softmax_label": (b, l)})
    jt = JaxTrainer(jsym, mesh=jmesh(axes),
                    rules=jmegatron_rules() if rules else None,
                    optimizer=opt, optimizer_params=dict(opt_params), **kw)
    jt.bind(*shapes, arg_params={k: jnp.asarray(v) for k, v in args.items()})
    tt = ShardedTrainer(tsym, opt, dict(opt_params), mesh=tmesh(axes),
                        rules=megatron_rules() if rules else None, **kw)
    tt.bind(*shapes, arg_params=args)
    return jt, tt


def _close_params(got, want, tol, what, skip=()):
    for n in want:
        if n in skip:
            continue
        np.testing.assert_allclose(got[n].asnumpy(), want[n].asnumpy(),
                                   err_msg=f"{what} {n}", **tol)


# ---------------------------------------------------------------------------
# tests/test_megatron_tp.py, on both sides
# ---------------------------------------------------------------------------

NAMES = ["layer0_q_weight", "layer1_ffn1_bias", "layer0_proj_weight",
         "layer1_ffn2_weight", "embed_weight", "lm_head_weight",
         "lm_head_bias", "layer0_ln1_gamma", "layer0_proj_bias",
         "layer1_k_bias", "final_ln_beta"]


def test_megatron_rules_cover_transformer_params():
    """The JAX test's specs, and every name's spec equal to the JAX
    preset's (layernorms and row-parallel biases stay replicated)."""
    spec = megatron_rules().spec_for
    assert spec("layer0_q_weight") == P("model", None)
    assert spec("layer1_ffn1_bias") == P("model")
    assert spec("layer0_proj_weight") == P(None, "model")
    assert spec("layer1_ffn2_weight") == P(None, "model")
    assert spec("embed_weight") == P("model", None)
    assert spec("lm_head_weight") == P("model", None)
    assert spec("layer0_ln1_gamma") == P()
    assert spec("layer0_proj_bias") == P()
    jspec = jmegatron_rules().spec_for
    for n in NAMES:
        assert tuple(spec(n)) == tuple(jspec(n)), n
    custom = ShardingRules([(r"fc\d+_weight", P("model", None))])
    assert custom.spec_for("fc2_weight") == P("model", None)
    assert custom.spec_for("fc2_bias") == P()


# (mesh axes, heads, the plan): heads=2 does not split over 4 members,
# so GSPMD's cut inside a head is computed by gathering the pieces
TP_CASES = {"gather": ({"data": 2, "model": 4}, 2),
            "split": ({"data": 2, "model": 2}, 2)}


@pytest.mark.parametrize("plan", sorted(TP_CASES))
def test_megatron_tp_matches_single_device(plan, monkeypatch):
    """Megatron TP over a data x model mesh against one device, in both
    packages, over 3 SGD-momentum steps (the JAX test's bounds: heads
    rtol 2e-4 / atol 2e-5, parameters rtol 5e-4 / atol 5e-5), and the
    port against the JAX trainer over the same virtual mesh (heads rtol
    1e-4 / atol 1e-5, parameters rtol 1e-4 / atol 1e-6).  Each member
    holds a quarter (a half) of q's rows and of its momentum; the plan is
    recorded; under split each member's attention sees ``heads / tp``
    heads."""
    axes, heads = TP_CASES[plan]
    tp = axes["model"]
    jsym, tsym = _lms(heads=heads)
    shapes = {"data": (B, L), "softmax_label": (B, L)}
    args = _init_params(tsym, shapes)
    jt, tt = _pair(jsym, tsym, axes, True, args)
    jref, tref = _pair(jsym, tsym, {"data": 1}, False, args)
    info = [i for i in tt.compile_info if i["kind"] == "tensor_parallel"]
    assert info and info[-1]["plan"] == plan
    assert set(info[-1]["params"].values()) == {plan}
    for i in range(8 if tp == 4 else 4):
        piece = tt._member_params(i)["layer0_q_weight"]
        assert tuple(piece.shape) == (D_MODEL // tp, D_MODEL)
    assert tuple(tt._piece_state["layer0_q_weight"][1].shape) == \
        (D_MODEL // tp, D_MODEL)
    seen = []
    dense = tra.local_attention

    def spy(q, k, v, **kw):
        seen.append(q.shape[1])
        return dense(q, k, v, **kw)
    spy.dense_calls = 0     # the dense path counts on the module's name
    for batch in _lm_batches(3):
        jh = np.asarray(jt.step(batch)[0])
        monkeypatch.setattr(tra, "local_attention", spy)
        th = tt.step(batch)[0].numpy()
        monkeypatch.undo()
        rh = tref.step(batch)[0].numpy()
        np.testing.assert_allclose(np.asarray(jref.step(batch)[0]), jh,
                                   **TP_HEAD)
        np.testing.assert_allclose(th, rh, **TP_HEAD)
        np.testing.assert_allclose(th, jh, **JAX_HEAD)
    assert set(seen) == {heads // tp if plan == "split" else heads}
    targ = tt.get_params()[0]
    _close_params(targ, tref.get_params()[0], TP_PARAM, "port TP vs one")
    _close_params(targ, jt.get_params()[0], JAX_PARAM, "port vs JAX TP")


def test_split_plan_reports_why_it_gathers():
    """A vocabulary the model axis does not divide takes the gather plan,
    the pass's reason recorded; every other Megatron parameter too."""
    kw = dict(vocab_size=30, num_layers=1, d_model=16, heads=4,
              batch_size=4, seq_len=8)
    with mxt.name.NameManager():
        sym = tmodels.get_symbol("transformer-lm", **kw)
    tr = ShardedTrainer(sym, "sgd", mesh=tmesh({"data": 1, "model": 4}),
                        rules=megatron_rules())
    with pytest.raises(MXNetError, match="does not split"):
        tr.bind({"data": (4, 8)}, {"softmax_label": (4, 8)})
    tr = ShardedTrainer(sym, "sgd", mesh=tmesh({"data": 2, "model": 2}),
                        rules=megatron_rules())
    tr.bind({"data": (4, 8)}, {"softmax_label": (4, 8)})
    assert tr._tp_plan.plan == "split" and tr._tp_plan.reason is None
    rules = ShardingRules([(r"_(q|k|v)_weight$", P("model", None))])
    tr = ShardedTrainer(sym, "sgd", mesh=tmesh({"data": 2, "model": 2}),
                        rules=rules)
    tr.bind({"data": (4, 8)}, {"softmax_label": (4, 8)})
    assert tr._tp_plan.plan == "gather"
    assert "bias is not" in tr._tp_plan.reason


# ---------------------------------------------------------------------------
# tests/test_parallel.py::test_sharded_trainer_tensor_parallel
# ---------------------------------------------------------------------------

def _mlp(S):
    data = S.Variable("data")
    fc1 = S.FullyConnected(data=data, name="fc1", num_hidden=16)
    act = S.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = S.FullyConnected(data=act, name="fc2", num_hidden=4)
    return S.SoftmaxOutput(data=fc2, name="softmax")


def _toy_batch(n=32, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    w = rs.randn(8, 4).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    return x, y


def test_sharded_trainer_tensor_parallel():
    """fc weights cut over the model axis of a 4 x 2 mesh compute the
    one-device math (the JAX test's rtol 2e-5 / atol 2e-6) and the JAX
    trainer's over the same mesh (rtol 1e-4 / atol 1e-6), through the
    gather plan (fc1's bias is replicated beside its cut weight)."""
    with mx.name.NameManager(), mxt.name.NameManager():
        jsym, tsym = _mlp(mx.sym), _mlp(mxt.sym)
    x, y = _toy_batch(16, seed=1)
    arg_shapes, _, _ = tsym.infer_shape(data=(16, 8), softmax_label=(16,))
    rs = np.random.RandomState(11)
    args = {n: rs.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    trules = ShardingRules([(r"fc\d+_weight", P("model", None))])
    jrules = mx.parallel.ShardingRules(
        [(r"fc\d+_weight", jax.sharding.PartitionSpec("model", None))])

    def run(pkg, trainer, mesh, rules):
        tr = trainer(tsym if pkg is mxt else jsym, optimizer="sgd",
                     optimizer_params={"learning_rate": 0.05}, mesh=mesh,
                     rules=rules)
        tr.bind({"data": (16, 8)}, {"softmax_label": (16,)},
                arg_params=(args if pkg is mxt else
                            {k: jnp.asarray(v) for k, v in args.items()}))
        for _ in range(2):
            tr.step({"data": x, "softmax_label": y})
        return tr

    ref = run(mxt, ShardedTrainer, tmesh({"data": 1}), None)
    tp = run(mxt, ShardedTrainer, tmesh({"data": 4, "model": 2}), trules)
    jtp = run(mx, JaxTrainer, jmesh({"data": 4, "model": 2}), jrules)
    assert tp._tp_plan.plan == "gather"
    assert tuple(tp._params["fc1_weight"].shape) == (8, 8)
    _close_params(tp.get_params()[0], ref.get_params()[0],
                  dict(rtol=2e-5, atol=2e-6), "TP vs one")
    _close_params(tp.get_params()[0], jtp.get_params()[0], JAX_PARAM,
                  "port vs JAX")


# ---------------------------------------------------------------------------
# tests/test_zero.py::test_zero_composes_with_megatron_tp
# ---------------------------------------------------------------------------

def test_zero_composes_with_megatron_tp():
    """ZeRO cuts rule-replicated parameters' state over data; TP
    parameters keep their Megatron spec, and the composed step trains
    (finite heads, gamma moves) and matches the JAX trainer's over the
    same mesh after 2 Adam steps (parameters rtol 1e-4 / atol 1e-6, the
    k biases skipped: their exact gradient is 0, so Adam scales rounding
    noise in both packages)."""
    jsym, tsym = _lms(layers=1, b=4)
    shapes = {"data": (4, L), "softmax_label": (4, L)}
    args = _init_params(tsym, shapes, seed=3)
    adam = {"learning_rate": 1e-2}
    jt, tr = _pair(jsym, tsym, {"data": 4, "model": 2}, True, args, b=4,
                   opt="adam", opt_params=adam, shard_optimizer=True)
    assert tr._zero_specs["layer0_q_weight"] == P("model", None)
    assert tr._zero_specs["layer0_ln1_gamma"] == P("data")
    assert tuple(tr._zero_state[0]["layer0_ln1_gamma"][0].shape) == (4,)
    before = tr.get_params()[0]["layer0_ln1_gamma"].asnumpy().copy()
    for batch in _lm_batches(2, b=4):
        heads = tr.step(batch)
        jt.step(batch)
        assert np.all(np.isfinite(heads[0].numpy()))
    after = tr.get_params()[0]
    assert not np.allclose(before, after["layer0_ln1_gamma"].asnumpy())
    _close_params(after, jt.get_params()[0], JAX_PARAM, "ZeRO+TP",
                  skip=("layer0_k_bias",))


# ---------------------------------------------------------------------------
# The JAX package's gates for TP, placement, checkpoints
# ---------------------------------------------------------------------------

def test_tp_gates_match_jax():
    """Compression refuses rule-sharded parameters (as JAX's trainer
    does), the fused update is off with JAX's reason in
    ``compile_info`` (``fused_update=True`` raises), a spec over another
    axis is taken (each data member holds its half of the embedding;
    parity: ``tests/test_torch_combined_meshes.py``), a spec over an axis
    the mesh lacks is refused, and the rules go into the program key."""
    _, tsym = _lms(layers=1, b=4)
    shapes = ({"data": (4, L)}, {"softmax_label": (4, L)})
    mesh = tmesh({"data": 2, "model": 2})
    with pytest.raises(MXNetError, match="tensor-parallel rules shard"):
        ShardedTrainer(tsym, "sgd", mesh=mesh, rules=megatron_rules(),
                       grad_compression="int8").bind(*shapes)
    with pytest.raises(MXNetError, match="tensor-parallel param sharding"):
        ShardedTrainer(tsym, "sgd", mesh=mesh, rules=megatron_rules(),
                       fused_update=True).bind(*shapes)
    with pytest.raises(MXNetError, match="rules must be"):
        ShardedTrainer(tsym, "sgd", mesh=mesh, rules=object())
    over_data = ShardedTrainer(tsym, "sgd", mesh=mesh, rules=ShardingRules(
        [("embed_weight", P("data", None))]))
    over_data.bind(*shapes)
    assert over_data._tp_plan is None
    assert [tuple(over_data._member_params(i)["embed_weight"].shape)
            for i in range(4)] == [(VOCAB // 2, D_MODEL)] * 4
    with pytest.raises(MXNetError, match="lacks"):
        ShardedTrainer(tsym, "sgd", mesh=mesh, rules=ShardingRules(
            [("embed_weight", P("seq", None))])).bind(*shapes)
    tr = ShardedTrainer(tsym, "sgd", mesh=mesh, rules=megatron_rules())
    tr.bind(*shapes)
    assert not tr._fused
    fused = [i for i in tr.compile_info if i["kind"] == "fused_update"]
    assert fused and "tensor-parallel param sharding" in fused[0]["reason"]
    plain = ShardedTrainer(tsym, "sgd", mesh=mesh, fused_update=False)
    plain.bind(*shapes)
    spec = {n: torch.empty((4, L), device="meta")
            for n in ("data", "softmax_label")}
    k1 = tr._program_key("train", spec)
    k2 = plain._program_key("train", spec)
    assert k1 != k2


def test_model_axis_without_rules_is_data_parallel():
    """A data x model mesh without rules replicates every parameter:
    each model group repeats the same rows, and the steps equal those of
    the data mesh (bitwise: the same sums in the same order)."""
    with mxt.name.NameManager():
        sym = _mlp(mxt.sym)
    x, y = _toy_batch(16, seed=2)

    def run(axes):
        tr = ShardedTrainer(sym, "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9},
                            mesh=tmesh(axes), seed=5)
        tr.bind({"data": (16, 8)}, {"softmax_label": (16,)})
        heads = [tr.step({"data": x, "softmax_label": y})[0]
                 for _ in range(2)]
        return heads, tr.get_params()[0]

    (ha, pa), (hb, pb) = run({"data": 2, "model": 2}), run({"data": 2})
    assert all(torch.equal(a, b) for a, b in zip(ha, hb))
    for n in pa:
        np.testing.assert_array_equal(pa[n].asnumpy(), pb[n].asnumpy())


def test_tp_save_state_restores_into_a_data_trainer(tmp_path):
    """A TP trainer's checkpoint holds whole arrays under the JAX names:
    it restores into a data-only trainer (another mesh shape) and back
    into a TP trainer, and each continues the saved run (bitwise: the
    same pieces update alike)."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    _, tsym = _lms(layers=1, b=4)
    shapes = ({"data": (4, L)}, {"softmax_label": (4, L)})
    args = _init_params(tsym, {"data": (4, L), "softmax_label": (4, L)})
    batches = _lm_batches(3, b=4, seed=4)

    def trainer(axes, rules):
        tr = ShardedTrainer(tsym, "sgd", dict(SGD), mesh=tmesh(axes),
                            rules=rules, fused_update=False)
        return tr.bind(*shapes, arg_params=args)

    tp = trainer({"data": 2, "model": 2}, megatron_rules())
    tp.step(batches[0])
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tp.save_state(mgr, blocking=True)
    mgr.wait_until_finished()
    dp = trainer({"data": 2}, None)
    dp.restore_state(mgr)
    tp2 = trainer({"data": 2, "model": 2}, megatron_rules())
    tp2.restore_state(mgr)
    for n, v in tp.get_params()[0].items():
        np.testing.assert_array_equal(dp.get_params()[0][n].asnumpy(),
                                      v.asnumpy())
    for n, st in tp.opt_state_by_param().items():
        for a, b in zip(st, dp.opt_state_by_param()[n]):
            assert torch.equal(a, b), n
    h1 = tp.step(batches[1])[0]
    h2 = tp2.step(batches[1])[0]
    assert torch.equal(h1, h2)
    hd = dp.step(batches[1])[0]
    np.testing.assert_allclose(hd.numpy(), h1.numpy(), **TP_HEAD)
    for n, v in tp.get_params()[0].items():
        np.testing.assert_array_equal(tp2.get_params()[0][n].asnumpy(),
                                      v.asnumpy())
    mgr.close()


def test_tp_recompute_scope_matches_plain():
    """The split plan inside recompute scopes (``remat=True``): the
    backward's replay reuses the forward's meetings, and the step equals
    the one without scopes (bitwise)."""
    kw = dict(vocab_size=VOCAB, num_layers=1, d_model=D_MODEL, heads=2,
              batch_size=4, seq_len=L)
    shapes = ({"data": (4, L)}, {"softmax_label": (4, L)})
    out = []
    for remat in (True, False):
        with mxt.name.NameManager():
            sym = tmodels.get_symbol("transformer-lm", remat=remat, **kw)
        args = _init_params(sym, {"data": (4, L), "softmax_label": (4, L)})
        tr = ShardedTrainer(sym, "sgd", dict(SGD),
                            mesh=tmesh({"data": 2, "model": 2}),
                            rules=megatron_rules())
        tr.bind(*shapes, arg_params=args)
        assert tr._tp_plan.plan == "split"
        heads = [tr.step(b)[0] for b in _lm_batches(2, b=4)]
        out.append((heads, tr.get_params()[0]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0]))
    for n, v in out[0][1].items():
        np.testing.assert_array_equal(v.asnumpy(), out[1][1][n].asnumpy())


# ---------------------------------------------------------------------------
# Collectives along one axis of a 2-D mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["data", "model"])
def test_axis_collectives_exact(axis):
    """psum, pmax, all-gather and reduce-scatter over the groups of one
    axis of a 2 x 4 mesh, on integer values (exact), counted by axis."""
    from mxnet_tpu_torch.parallel import mesh as tmesh_mod
    mesh = tmesh({"data": 2, "model": 4})
    groups = tmesh_mod.axis_groups(mesh, axis)
    assert len(groups) == 8 // mesh.shape[axis]
    other = 1 - mesh.axis_names.index(axis)
    for g in groups:
        # the members of a group share their other coordinate
        cs = [np.unravel_index(i, mesh.devices.shape) for i in g]
        assert len({c[other] for c in cs}) == 1
    parts = [torch.full((4, 2), float(i + 1)) for i in range(8)]
    with collectives.count_collectives() as stats:
        s = collectives.over_axis(groups, collectives.psum, parts, axis)
        m = collectives.over_axis(groups, collectives.pmax, parts, axis)
        g = collectives.over_axis(groups, collectives.all_gather, parts,
                                  axis, dim=1)
        r = collectives.over_axis(groups, collectives.reduce_scatter, parts,
                                  axis, dim=0)
    assert stats.by_axis() == {axis: 4 * len(groups)}
    for grp in groups:
        vals = [i + 1.0 for i in grp]
        for i in grp:
            np.testing.assert_array_equal(s[i].numpy(), sum(vals))
            np.testing.assert_array_equal(m[i].numpy(), max(vals))
            assert tuple(g[i].shape) == (4, 2 * len(grp))
            np.testing.assert_array_equal(
                g[i].numpy(), np.repeat(vals, 2)[None].repeat(4, 0))
            assert tuple(r[i].shape) == (4 // len(grp), 2)
            np.testing.assert_array_equal(r[i].numpy(), sum(vals))
