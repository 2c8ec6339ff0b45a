"""``ShardedTrainer`` of the PyTorch port over meshes that combine split
axes (model with seq, a pipe axis beside others, expert beside model, seq
or pipe) and over rule specs that cut parameters over an axis other than
model or expert, against the JAX trainer on the same mesh and against the
port on one device.

The port's meshes are CPU contexts ``cpu(0)`` ... ``cpu(7)``; the JAX
side runs on the 8 virtual CPU devices ``tests/conftest.py`` gives it.
Parameters and batches are numpy arrays from a seed, carried across by
name; SGD at rate 0.1 (with momentum 0.9 where ZeRO holds a state), 3
steps.

* The LM is ``tests/test_torch_ring.py``'s (vocab 32, 2 layers, d 16, 2
  heads, batch 4 x 32), under ``megatron_rules`` where the mesh has a
  model axis (the split plan: each model coordinate's seq group runs the
  ring over its local heads).  Tolerance ``test_torch_ring.py``'s
  ``TRAIN``, rtol 2e-4 / atol 2e-4, against both references.
* The MoE net is ``tests/test_torch_moe.py``'s (``MoEFFN`` with E=4,
  d=8, h=16, Switch top-1 at capacity factor 4.0, batch 8) with the
  expert rules ``moe_expert\\d_(weight|bias) -> P("expert")``, and the
  two-axis spec ``P("expert", None, "model")``.  Tolerances
  ``test_torch_moe.py``'s: against the JAX trainer heads rtol 1e-4 /
  atol 1e-5 (``JAX_HEAD``), parameters rtol 1e-4 / atol 1e-6
  (``JAX_PARAM``); against one device rtol 2e-4 / atol 2e-4
  (``ONE_DEVICE``).

Beside the parity cases: a checkpoint of a ``{"model": 2, "seq": 2}``
trainer resumes bitwise, ``get_params``/``set_params`` round-trip its
pieces, ``compile()`` runs it eagerly with its reason, and
``grad_compression`` over a seq or expert axis is refused with the
reason (the JAX trainer fails there too).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import ShardingRules as JRules
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel import megatron_rules as jmegatron_rules

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import PartitionSpec as P
from mxnet_tpu_torch.parallel import (ShardedTrainer, ShardingRules,
                                      make_mesh, megatron_rules)
from mxnet_tpu_torch.parallel.collectives import count_collectives

TRAIN = dict(rtol=2e-4, atol=2e-4)
JAX_HEAD = dict(rtol=1e-4, atol=1e-5)
JAX_PARAM = dict(rtol=1e-4, atol=1e-6)
ONE_DEVICE = dict(rtol=2e-4, atol=2e-4)

B, L, VOCAB = 4, 32, 32
E, D, H, B_MOE = 4, 8, 16, 8
STEPS = 3
EXPERT_RULES = [(r"moe_expert\d_(weight|bias)", ("expert",))]


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


def _rules(spec, jax_side):
    """``"megatron"``, None, or ``[(pattern, spec tuple), ...]`` as either
    package's rules."""
    if spec is None:
        return None
    if spec == "megatron":
        return jmegatron_rules() if jax_side else megatron_rules()
    if jax_side:
        return JRules([(pat, JP(*s)) for pat, s in spec])
    return ShardingRules([(pat, P(*s)) for pat, s in spec])


def _params_of(tr):
    arg, _ = tr.get_params()
    return {n: v.asnumpy() for n, v in arg.items()}


def _run(sym_fn, shapes, args, batches, axes, spec, jax_side, opt, **kw):
    """The JAX (``jax_side``) or the port trainer over a mesh of ``axes``
    bound with ``args`` and stepped over ``batches``; returns the last
    step's heads (numpy), the parameters and the trainer."""
    pkg = mx if jax_side else mxt
    with pkg.name.NameManager():
        sym = sym_fn(pkg)
    if jax_side:
        tr = JaxTrainer(sym, optimizer="sgd", optimizer_params=opt,
                        mesh=jmesh(axes), rules=_rules(spec, True), **kw)
        tr.bind(*shapes, arg_params={k: jnp.asarray(v)
                                     for k, v in args.items()})
    else:
        tr = ShardedTrainer(sym, "sgd", opt, mesh=tmesh(axes),
                            rules=_rules(spec, False), **kw)
        tr.bind(*shapes, arg_params=args)
    heads = None
    for bt in batches:
        heads = [np.asarray(h) for h in tr.step(bt)]
    return heads, _params_of(tr), tr


# ---------------------------------------------------------------------------
# The transformer LM
# ---------------------------------------------------------------------------

def _lm(pkg):
    models = jmodels if pkg is mx else tmodels
    return models.get_symbol("transformer-lm", vocab_size=VOCAB,
                             num_layers=2, d_model=16, heads=2,
                             batch_size=B, seq_len=L)


LM_SHAPES = ({"data": (B, L)}, {"softmax_label": (B, L)})


def _lm_args():
    with mxt.name.NameManager():
        sym = _lm(mxt)
    arg_shapes, _, _ = sym.infer_shape(data=(B, L), softmax_label=(B, L))
    rng = np.random.RandomState(11)
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def _lm_batches(steps=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        x = rng.randint(0, VOCAB, (B, L)).astype(np.float32)
        out.append({"data": x, "softmax_label": np.roll(x, -1, axis=1)})
    return out


def _lm_run(axes, spec, jax_side, opt=None, steps=STEPS, **kw):
    return _run(_lm, LM_SHAPES, _lm_args(), _lm_batches(steps), axes, spec,
                jax_side, opt or {"learning_rate": 0.1}, **kw)


_ONE = {}


def _one_device(kind, opt_key, fn):
    """The port on one device, once per net, optimizer and microbatch
    count (the reference of every case of that kind)."""
    if (kind, opt_key) not in _ONE:
        _ONE[(kind, opt_key)] = fn()
    return _ONE[(kind, opt_key)]


MOMENTUM = {"learning_rate": 0.1, "momentum": 0.9}

LM_CASES = [
    ("model2-seq2", {"model": 2, "seq": 2}, "megatron", {}),
    ("data2-model2-seq2", {"data": 2, "model": 2, "seq": 2}, "megatron",
     {}),
    ("data2-seq2-pipe2", {"data": 2, "seq": 2, "pipe": 2}, None, {}),
    ("model2-pipe2", {"model": 2, "pipe": 2}, "megatron", {}),
    ("model2-seq2-pipe2", {"model": 2, "seq": 2, "pipe": 2}, "megatron",
     {}),
    ("data2-model2-seq2-zero-accum2", {"data": 2, "model": 2, "seq": 2},
     "megatron", {"shard_optimizer": True, "grad_accum": 2}),
    # rule specs over another axis (the JAX trainer trains each)
    ("embed-over-data", {"data": 2, "model": 2},
     [("embed_weight", ("data", None))], {}),
    ("embed-over-data-model-then-seq", {"data": 2, "model": 2, "seq": 2},
     [("embed_weight", (("data", "model"), None)),
      ("lm_head_weight", ("seq", None))], {}),
]


@pytest.mark.parametrize("axes,spec,kw", [c[1:] for c in LM_CASES],
                         ids=[c[0] for c in LM_CASES])
def test_lm_over_a_combined_mesh(axes, spec, kw):
    """The LM over the mesh: heads and parameters after 3 steps against
    the JAX trainer on the same mesh and against the port on one device
    (``TRAIN``).  Under Megatron's rules the split plan is taken and
    every member holds its rows of q; the ring meets along seq and the
    plan along model; a pipe axis replicates the step."""
    opt = MOMENTUM if kw.get("shard_optimizer") else None
    with count_collectives() as stats:
        th, tp, tt = _lm_run(axes, spec, False, opt, **kw)
    jh, jp, _ = _lm_run(axes, spec, True, opt, **kw)
    oh, op, _ = _one_device(
        "lm", (str(opt), kw.get("grad_accum", 1)),
        lambda: _lm_run({"data": 1}, None, False, opt,
                        grad_accum=kw.get("grad_accum", 1)))
    assert tt._dup_axes == sorted(a for a in axes
                                  if a not in ("data", "model"))
    met = stats.by_axis()
    cuts_model = spec == "megatron" or (spec is not None and any(
        "model" in (s if isinstance(s, tuple) else (s,))
        for _, sp in spec for s in sp if s))
    assert ("seq" in met) == ("seq" in axes), met
    assert ("model" in met) == ("model" in axes and cuts_model), met
    if spec == "megatron":
        assert tt._tp_plan.plan == "split", tt._tp_plan.reason
        piece = tt._member_params(len(tt._devices) - 1)["layer0_q_weight"]
        assert tuple(piece.shape) == (16 // axes["model"], 16)
    elif spec is not None:
        piece = tt._member_params(len(tt._devices) - 1)["embed_weight"]
        parts = int(np.prod([axes[a] for s in spec[0][1] if s
                             for a in ((s,) if isinstance(s, str) else s)]))
        assert tuple(piece.shape) == (VOCAB // parts, 16)
    np.testing.assert_allclose(th[0], oh[0], **TRAIN)
    np.testing.assert_allclose(th[0], jh[0], **TRAIN)
    for n in op:
        np.testing.assert_allclose(tp[n], op[n], **TRAIN, err_msg=n)
        np.testing.assert_allclose(tp[n], jp[n], **TRAIN, err_msg=n)


# ---------------------------------------------------------------------------
# The MoE net
# ---------------------------------------------------------------------------

def _moe(pkg):
    S = pkg.symbol
    net = S.MoEFFN(data=S.Variable("data"), num_experts=E, hidden_size=H,
                   capacity_factor=4.0, top_k=1, name="moe")
    return S.LinearRegressionOutput(data=net, name="lro")


MOE_SHAPES = ({"data": (B_MOE, D)}, {"lro_label": (B_MOE, D)})


def _moe_args():
    with mxt.name.NameManager():
        sym = _moe(mxt)
    arg_shapes, _, _ = sym.infer_shape(data=(B_MOE, D),
                                       lro_label=(B_MOE, D))
    rng = np.random.RandomState(3)
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "lro_label")}


def _moe_batches(steps=STEPS, seed=4):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(B_MOE, D).astype(np.float32),
             "lro_label": rng.randn(B_MOE, D).astype(np.float32)}
            for _ in range(steps)]


def _moe_run(axes, spec, jax_side, opt=None, **kw):
    return _run(_moe, MOE_SHAPES, _moe_args(), _moe_batches(), axes, spec,
                jax_side, opt or {"learning_rate": 0.1}, **kw)


MOE_CASES = [
    ("expert2-model2", {"expert": 2, "model": 2}, EXPERT_RULES, {},
     (E // 2, D, H)),
    ("data2-expert2-model2", {"data": 2, "expert": 2, "model": 2},
     EXPERT_RULES, {}, (E // 2, D, H)),
    ("expert2-seq2", {"expert": 2, "seq": 2}, EXPERT_RULES, {},
     (E // 2, D, H)),
    ("expert2-pipe2", {"expert": 2, "pipe": 2}, EXPERT_RULES, {},
     (E // 2, D, H)),
    ("two-axis-spec", {"expert": 2, "model": 2},
     [("moe_expert1_weight", ("expert", None, "model"))] + EXPERT_RULES,
     {}, (E // 2, D, H // 2)),
    ("data2-expert2-model2-zero-accum2",
     {"data": 2, "expert": 2, "model": 2}, EXPERT_RULES,
     {"shard_optimizer": True, "grad_accum": 2}, (E // 2, D, H)),
    # rule specs over another axis
    ("experts-over-data-expert", {"data": 2, "expert": 2},
     [(r"moe_expert\d_(weight|bias)", (("data", "expert"),))], {},
     (E // 4, D, H)),
    ("gate-over-expert", {"expert": 2, "model": 2},
     [("moe_gate_weight", (None, "expert"))] + EXPERT_RULES, {},
     (E // 2, D, H)),
]


@pytest.mark.parametrize("axes,spec,kw,piece", [c[1:] for c in MOE_CASES],
                         ids=[c[0] for c in MOE_CASES])
def test_moe_over_a_combined_mesh(axes, spec, kw, piece):
    """The MoE net over the mesh: each member holds its piece of the
    expert weights (its experts, and under the two-axis spec its half of
    the hidden width), the op runs the all-to-all program over each
    expert group; heads and parameters after 3 steps against the JAX
    trainer on the same mesh (``JAX_HEAD``, ``JAX_PARAM``) and against
    the port on one device (``ONE_DEVICE``)."""
    opt = MOMENTUM if kw.get("shard_optimizer") else None
    with count_collectives() as stats:
        th, tp, tt = _moe_run(axes, spec, False, opt, **kw)
    jh, jp, _ = _moe_run(axes, spec, True, opt, **kw)
    oh, op, _ = _one_device(
        "moe", (str(opt), kw.get("grad_accum", 1)),
        lambda: _moe_run({"data": 1}, None, False, opt,
                         grad_accum=kw.get("grad_accum", 1)))
    assert stats.by_axis().get("expert", 0) > 0
    last = tt._member_params(len(tt._devices) - 1)
    assert tuple(last["moe_expert1_weight"].shape) == piece
    np.testing.assert_allclose(th[0], jh[0], **JAX_HEAD)
    np.testing.assert_allclose(th[0], oh[0], **ONE_DEVICE)
    for n in op:
        np.testing.assert_allclose(tp[n], jp[n], **JAX_PARAM, err_msg=n)
        np.testing.assert_allclose(tp[n], op[n], **ONE_DEVICE, err_msg=n)


# ---------------------------------------------------------------------------
# The rest of the trainer over a combined mesh
# ---------------------------------------------------------------------------

def _ms_trainer():
    with mxt.name.NameManager():
        sym = _lm(mxt)
    tr = ShardedTrainer(sym, "sgd", MOMENTUM, mesh=tmesh({"model": 2,
                                                          "seq": 2}),
                        rules=megatron_rules())
    tr.bind(*LM_SHAPES, arg_params=_lm_args())
    return tr


def test_save_restore_over_model_and_seq_is_bitwise(tmp_path):
    """A ``{"model": 2, "seq": 2}`` trainer saved after 2 steps and
    restored into a fresh one resumes bitwise (parameters, momentum
    pieces, heads); ``get_params``/``set_params`` carry the pieces into
    a third trainer whole."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    batches = _lm_batches(3, seed=5)
    a = _ms_trainer()
    for bt in batches[:2]:
        a.step(bt)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    a.save_state(mgr, blocking=True)
    mgr.wait_until_finished()
    saved = _params_of(a)
    ha = a.step(batches[2])[0]
    b = _ms_trainer()
    b.restore_state(mgr)
    hb = b.step(batches[2])[0]
    assert torch.equal(ha, hb)
    pa, pb = _params_of(a), _params_of(b)
    for n in pa:
        np.testing.assert_array_equal(pb[n], pa[n], err_msg=n)
    for n, states in a._piece_state.items():
        for sa, sb in zip(states, b._piece_state[n]):
            assert torch.equal(sa, sb), n
    c = _ms_trainer()
    c.set_params(saved)
    pc = _params_of(c)
    for n in saved:
        np.testing.assert_array_equal(pc[n], saved[n], err_msg=n)
    for i in range(len(c._devices)):
        for n, p in c._member_params(i).items():
            want = c._piece(torch.from_numpy(saved[n]), n, i)
            assert torch.equal(p.detach(), want), (i, n)


def test_compile_over_a_combined_mesh_runs_eagerly():
    """``compile()`` over several members runs the step eagerly and says
    why; the steps after it equal an uncompiled twin's bitwise."""
    a, b = _ms_trainer(), _ms_trainer()
    infos = a.compile(programs=("train", "eval"))
    assert [i["kind"] for i in infos] == ["train", "eval"]
    assert all("mesh path" in i.get("reason", "") for i in infos)
    for bt in _lm_batches(2, seed=7):
        assert torch.equal(a.step(bt)[0], b.step(bt)[0])
    assert torch.equal(a.forward(bt)[0], b.forward(bt)[0])


@pytest.mark.parametrize("axes", [{"data": 2, "seq": 2},
                                  {"data": 2, "expert": 2},
                                  {"data": 2, "model": 2, "seq": 2}],
                         ids=["data2-seq2", "data2-expert2",
                              "data2-model2-seq2"])
def test_compression_over_seq_or_expert_refuses_with_its_reason(axes):
    """``grad_compression`` over a seq or expert axis raises at
    construction and says why (the JAX trainer's manual region fails on
    the same meshes); it is not a missing port."""
    with mxt.name.NameManager():
        sym = _lm(mxt)
    with pytest.raises(MXNetError) as err:
        ShardedTrainer(sym, "sgd", mesh=tmesh(axes),
                       grad_compression="int8")
    msg = str(err.value)
    assert "not ported" not in msg
    assert "implicit mode" in msg
    assert next(a for a in ("seq", "expert") if a in axes) in msg
