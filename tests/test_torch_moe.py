"""Mixture of experts in the PyTorch port (``parallel/moe.py``, the
``MoEFFN`` op, ``ShardedTrainer`` over ``data`` and ``expert`` axes)
against the JAX package's ``parallel/moe.py``, its op and its trainer,
after ``tests/test_moe.py`` and ``tests/test_moe_topk.py``.

The port's meshes are CPU contexts ``cpu(0)`` ... ``cpu(7)``; the JAX
side runs on the 8 virtual CPU devices ``tests/conftest.py`` gives it.
Inputs and parameters are numpy arrays from a seed, carried across by
name.

Tolerances, as stated in each test:

* the functions in f32 against JAX's: rtol 1e-5 / atol 1e-6 (outputs,
  router probabilities and gradients); the dispatch and combine tensors
  exactly; bf16 against JAX's bf16 at bf16's rtol 2e-2 / atol 2e-2, with
  the kept tokens counted exactly;
* the op through ``simple_bind``: rtol 1e-5 / atol 1e-6, gradients
  within 1e-5 of each gradient's largest magnitude;
* trainers against the JAX trainer on the same mesh: heads rtol 1e-4 /
  atol 1e-5, parameters rtol 1e-4 / atol 1e-6; against one device:
  ``tests/test_moe.py``'s rtol 2e-4 / atol 2e-4;
* ``moe_ffn_ep`` against JAX's and against the dense program:
  ``tests/test_moe_topk.py``'s rtol 1e-5 / atol 1e-6; its gradients
  against JAX's: rtol 1e-5 / atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JSharding
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu import ndarray as jnd
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import ShardingRules as JRules
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel import moe as jmoe

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.parallel import PartitionSpec as P
from mxnet_tpu_torch.parallel import (ShardedTrainer, ShardingRules,
                                      make_mesh)
from mxnet_tpu_torch.parallel import moe as tmoe

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
JAX_HEAD = dict(rtol=1e-4, atol=1e-5)
JAX_PARAM = dict(rtol=1e-4, atol=1e-6)
ONE_DEVICE = dict(rtol=2e-4, atol=2e-4)
E, D, H = 4, 8, 16


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


def _params(e=E, d=D, h=H, seed=0):
    """``test_moe_topk.py``'s parameters: router, up and down
    projections, as numpy f32."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * c).astype(np.float32)
            for s, c in (((d, e), 0.5), ((e, d, h), 0.3), ((e, h), 0.1),
                         ((e, h, d), 0.3), ((e, d), 0.1))]


def _jax_fn(kind, k, cf):
    if kind == "switch":
        return lambda x, *p: jmoe.switch_ffn(x, *p, capacity_factor=cf)
    return lambda x, *p: jmoe.moe_ffn(x, *p, k=k, capacity_factor=cf)


def _port_fn(kind, k, cf):
    if kind == "switch":
        return lambda x, *p: tmoe.switch_ffn(x, *p, capacity_factor=cf)
    return lambda x, *p: tmoe.moe_ffn(x, *p, k=k, capacity_factor=cf)


def _loss_jax(fn):
    def loss(x, *p):
        y, probs = fn(x, *p)
        return (jnp.sum(jnp.tanh(y)) + jmoe.load_balance_loss(probs),
                (y, probs))
    return loss


@pytest.mark.parametrize("cf", [16.0, 0.5], ids=["kept", "dropped"])
@pytest.mark.parametrize("kind,k", [("switch", 1), ("moe", 1), ("moe", 2)])
def test_functions_match_jax(kind, k, cf):
    """``switch_ffn``, ``moe_ffn`` (k = 1, 2) and ``load_balance_loss``:
    outputs, router probabilities and the gradients of ``sum(tanh(y)) +
    aux`` with respect to the tokens and every parameter, with capacity
    to spare and with dropped tokens."""
    p = _params(seed=1)
    x = np.random.RandomState(2).randn(48, D).astype(np.float32)
    (_, (jy, jprobs)), jgrads = jax.jit(jax.value_and_grad(
        _loss_jax(_jax_fn(kind, k, cf)), argnums=tuple(range(6)),
        has_aux=True))(jnp.asarray(x), *map(jnp.asarray, p))
    tin = [torch.tensor(a, requires_grad=True) for a in [x] + p]
    ty, tprobs = _port_fn(kind, k, cf)(*tin)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(tprobs.detach().numpy(), np.asarray(jprobs),
                               **F32)
    aux = tmoe.load_balance_loss(tprobs)
    np.testing.assert_allclose(float(aux.detach()),
                               float(jmoe.load_balance_loss(jprobs)), **F32)
    (torch.tanh(ty).sum() + aux).backward()
    for name, t, j in zip(["x", "gate_w", "w1", "b1", "w2", "b2"], tin,
                          jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **F32,
                                   err_msg=f"d{name}")
    dropped = (np.abs(ty.detach().numpy()).sum(axis=1) == 0).sum()
    if cf < 1 and kind == "switch":
        assert dropped > 0


@pytest.mark.parametrize("cap", [1, 3, 64])
def test_topk_dispatch_is_jax_exactly(cap):
    """The rank-major capacity accounting: dispatch and combine equal
    the JAX function's exactly, ties and overflow included."""
    rng = np.random.RandomState(3)
    topi = rng.randint(0, E, (40, 2)).astype(np.int32)
    topi[:, 1] = (topi[:, 0] + 1 + rng.randint(0, E - 1, 40)) % E
    gates = rng.rand(40, 2).astype(np.float32)
    jd, jc = jmoe._topk_dispatch(jnp.asarray(topi), jnp.asarray(gates), E,
                                 cap, jnp.float32)
    td, tc = tmoe._topk_dispatch(torch.tensor(topi).long(),
                                 torch.tensor(gates), E, cap, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_ties_break_toward_the_lowest_index():
    """Equal router probabilities route to the lowest expert index, as
    ``jax.lax.top_k`` and ``jnp.argmax`` do."""
    x = np.zeros((6, D), np.float32)      # every logit 0: all tied
    p = _params(seed=4)
    for kind, k in (("switch", 1), ("moe", 2)):
        jy, _ = jax.jit(_jax_fn(kind, k, 16.0))(jnp.asarray(x),
                                                 *map(jnp.asarray, p))
        ty, _ = _port_fn(kind, k, 16.0)(torch.tensor(x),
                                        *map(torch.tensor, p))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    _, idx = tmoe._topk(torch.full((3, E), 0.25), 2)
    assert idx.tolist() == [[0, 1]] * 3


@pytest.mark.parametrize("kind,k", [("switch", 1), ("moe", 2)])
def test_bf16_routing_counts_past_256_tokens(kind, k):
    """600 bf16 tokens routed to one expert with room for 300: exactly
    300 keep an expert output (a count kept in bf16 would stop at 256 and
    collide slots); the output matches JAX's bf16 run."""
    n = 600
    p = _params(e=2, seed=5)
    p[0][:] = 0.0
    p[0][:, 0] = 4.0                       # expert 0 wins every token
    x = np.abs(np.random.RandomState(6).randn(n, D)).astype(np.float32)
    cf = 300 * 2 / (k * n)                 # capacity 300
    jx, jp = jnp.asarray(x, jnp.bfloat16), [jnp.asarray(a, jnp.bfloat16)
                                            for a in p]
    jy, _ = jax.jit(_jax_fn(kind, k, cf))(jx, *jp)
    tx, tp = torch.tensor(x).bfloat16(), [torch.tensor(a).bfloat16()
                                          for a in p]
    ty, _ = _port_fn(kind, k, cf)(tx, *tp)
    assert ty.dtype == torch.bfloat16
    got = ty.float().numpy()
    want = np.asarray(jy.astype(jnp.float32))
    if kind == "switch":
        rows = lambda y: int((np.abs(y).sum(axis=1) > 0).sum())
        assert rows(got) == rows(want) == 300
        assert np.all(np.abs(got[300:]).sum(axis=1) == 0)
    np.testing.assert_allclose(got, want, **BF16)


def _moe_net(S, top_k=1, cf=4.0, aux=False, lro=True):
    net = S.MoEFFN(data=S.Variable("data"), num_experts=E, hidden_size=H,
                   capacity_factor=cf, top_k=top_k, aux_loss=aux,
                   name="moe")
    if not lro:
        return net
    if aux:
        return S.Group([S.LinearRegressionOutput(data=net[0], name="lro"),
                        net[1]])
    return S.LinearRegressionOutput(data=net, name="lro")


@pytest.mark.parametrize("top_k,aux", [(1, False), (2, True)])
def test_op_through_simple_bind_matches_jax(top_k, aux):
    """``MoEFFN`` over ``[2, 8, d]`` (flattened to 16 tokens) through
    ``simple_bind``: outputs and the gradient of every input and
    parameter for random head gradients, against the JAX executor."""
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet = _moe_net(mx.symbol, top_k, 1.0, aux, lro=False)
        tnet = _moe_net(mxt.symbol, top_k, 1.0, aux, lro=False)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_outputs() == jnet.list_outputs()
    jex = jnet.simple_bind(mx.cpu(), data=(2, 8, D))
    tex = tnet.simple_bind(mxt.cpu(), data=(2, 8, D))
    rng = np.random.RandomState(7)
    vals = {n: rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
            for n, a in jex.arg_dict.items()}
    jout = jex.forward(is_train=True, **vals)
    tout = tex.forward(is_train=True, **vals)
    for t, j in zip(tout, jout):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **F32)
    heads = [rng.uniform(-1, 1, o.shape).astype(np.float32) for o in jout]
    jex.backward([jnd.array(h) for h in heads])
    tex.backward([tnd.array(h, ctx=mxt.cpu()) for h in heads])
    for n in jex.grad_dict:
        j = jex.grad_dict[n].asnumpy()
        np.testing.assert_allclose(tex.grad_dict[n].asnumpy(), j, rtol=0,
                                   atol=1e-5 * max(np.abs(j).max(), 1e-6),
                                   err_msg=n)


def _train(axes, rules, b, top_k, cf, aux, args, batches, jax_side=False,
           grad_accum=1):
    """The JAX (``jax_side``) or the port trainer over a mesh of
    ``axes``, bound with ``args`` and stepped over ``batches`` with SGD
    at rate 0.1 (``grad_accum`` microbatches a step); returns the last
    step's heads (numpy) and the trainer."""
    pkg = mx if jax_side else mxt
    with pkg.name.NameManager():
        net = _moe_net(pkg.symbol, top_k, cf, aux)
    shapes = ({"data": (b, D)}, {"lro_label": (b, D)})
    if jax_side:
        tr = JaxTrainer(net, optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1},
                        mesh=jmesh(axes), rules=rules,
                        grad_accum=grad_accum)
        tr.bind(*shapes, arg_params={k: jnp.asarray(v)
                                     for k, v in args.items()})
    else:
        tr = ShardedTrainer(net, "sgd", {"learning_rate": 0.1},
                            mesh=tmesh(axes), rules=rules,
                            grad_accum=grad_accum)
        tr.bind(*shapes, arg_params=args)
    heads = None
    for bt in batches:
        heads = [np.asarray(h) for h in tr.step(bt)]
    return heads, tr


def _moe_args(seed, b, gate_bias=0.0):
    with mxt.name.NameManager():
        net = _moe_net(mxt.symbol)
    shapes = {"data": (b, D), "lro_label": (b, D)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in shapes}
    args["moe_gate_weight"][:, 0] += gate_bias
    return args


def _batches(steps, b, seed):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(b, D).astype(np.float32),
             "lro_label": rng.randn(b, D).astype(np.float32)}
            for _ in range(steps)]


def _jparams(jt):
    arg, _ = jt.get_params()
    return {n: v.asnumpy() for n, v in arg.items()}


def _tparams(tt):
    arg, _ = tt.get_params()
    return {n: v.asnumpy() for n, v in arg.items()}


def test_trainer_over_four_data_members_routes_the_global_batch():
    """Dense top-2 ``MoEFFN`` with the aux head over ``{"data": 4}`` at
    capacity factor 1.0, so that tokens drop: the capacity comes from the
    global token count and the arrival order runs over the global batch,
    as in the JAX trainer over 4 devices (routing each member's rows on
    its own gives another result here, checked first)."""
    b, steps = 32, 3
    args = _moe_args(8, b, gate_bias=0.6)
    batches = _batches(steps, b, 9)
    x = torch.tensor(batches[0]["data"])
    p = [torch.tensor(args[f"moe_{n}"]) for n in
         ("gate_weight", "expert1_weight", "expert1_bias", "expert2_weight",
          "expert2_bias")]
    whole, _ = tmoe.moe_ffn(x, *p, k=2, capacity_factor=1.0)
    topv, topi = tmoe._topk(torch.softmax(x @ p[0], dim=-1), 2)
    kept = tmoe._topk_dispatch(topi, topv, E, 16, torch.float32)[0].sum()
    assert kept < 2 * b, "no token dropped: the test would not tell"
    apart = torch.cat([tmoe.moe_ffn(c, *p, k=2, capacity_factor=1.0)[0]
                       for c in x.chunk(4)])
    assert not torch.allclose(apart, whole, atol=1e-3)
    jh, jt = _train({"data": 4}, None, b, 2, 1.0, True, args, batches,
                    jax_side=True)
    th, tt = _train({"data": 4}, None, b, 2, 1.0, True, args, batches)
    for t, j in zip(th, jh):
        np.testing.assert_allclose(t, j, **JAX_HEAD)
    jp, tp = _jparams(jt), _tparams(tt)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], **JAX_PARAM, err_msg=n)
    oh, _ = _train({"data": 1}, None, b, 2, 1.0, True, args, batches)
    for t, o in zip(th, oh):
        np.testing.assert_allclose(t, o, **ONE_DEVICE)


def _ep_jax(mesh, params, x, k, cf):
    place = lambda a, spec: jax.device_put(jnp.asarray(a),
                                           JSharding(mesh, spec))
    jp = (place(params[0], JP()), place(params[1], JP("expert", None, None)),
          place(params[2], JP("expert", None)),
          place(params[3], JP("expert", None, None)),
          place(params[4], JP("expert", None)))
    jx = place(x, JP(("data", "expert"), None))

    def loss(jx, *jp):
        y, probs = jmoe.moe_ffn_ep(jx, *jp, mesh=mesh, k=k,
                                   capacity_factor=cf)
        return jnp.sum(jnp.square(y)), (y, probs)

    (_, (y, probs)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True))(jx, *jp)
    return np.asarray(y), np.asarray(probs), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("k,cf", [(2, 8.0), (1, 1.0)])
def test_moe_ffn_ep_matches_jax(k, cf):
    """``moe_ffn_ep`` over ``{"data": 2, "expert": 4}`` of CPU contexts
    (64 tokens, each member routing its 8 with its own capacity) against
    the JAX function over 8 devices: outputs, router probabilities and
    the gradients of ``sum(y^2)``; with capacity to spare it is also the
    dense program's output (``test_moe_topk.py``)."""
    p = _params(seed=4)
    x = np.random.RandomState(5).randn(64, D).astype(np.float32)
    mesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4),
                 ("data", "expert"))
    jy, jprobs, jgrads = _ep_jax(mesh, p, x, k, cf)
    tin = [torch.tensor(a, requires_grad=True) for a in [x] + p]
    calls = tpar.collectives.count_collectives
    with calls() as stats:
        ty, tprobs = tpar.moe_ffn_ep(tin[0], *tin[1:],
                                     tmesh({"data": 2, "expert": 4}), k=k,
                                     capacity_factor=cf)
    # two all-to-alls in each of the two expert groups
    assert stats.by_axis() == {"expert": 4}
    np.testing.assert_allclose(ty.detach().numpy(), jy, **F32)
    np.testing.assert_allclose(tprobs.detach().numpy(), jprobs, **F32)
    torch.sum(torch.square(ty)).backward()
    for name, t, j in zip(["x", "gate_w", "w1", "b1", "w2", "b2"], tin,
                          jgrads):
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")
    if cf > 4:
        yd, _ = tmoe.moe_ffn(torch.tensor(x), *map(torch.tensor, p), k=k,
                             capacity_factor=cf)
        np.testing.assert_allclose(ty.detach().numpy(), yd.numpy(), **F32)


EXPERT_RULES = {
    "per_weight": [
        (r"moe_expert1_weight", ("expert", None, None)),
        (r"moe_expert1_bias", ("expert", None)),
        (r"moe_expert2_weight", ("expert", None, None)),
        (r"moe_expert2_bias", ("expert", None)),
    ],
    "regex": [(r"moe_expert\d_(weight|bias)", ("expert",))],
}


@pytest.mark.parametrize("rules", ["per_weight", "regex", "none"])
def test_trainer_over_an_expert_mesh(rules, tmp_path):
    """``ShardedTrainer`` over ``{"data": 2, "expert": 4}`` (Switch
    ``MoEFFN`` at capacity factor 4.0, ``test_moe.py``'s net): each
    member holds its experts under the rules (or slices them from whole
    weights without rules), the op runs the all-to-all program, expert
    parameters meet along their data group and the rest along every
    member.  Three steps against one device (``test_moe.py``'s 2e-4) and
    against the JAX trainer on the same mesh; a checkpoint of it restores
    into a data trainer, which continues the run."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    b, steps = 16, 3
    args = _moe_args(3, b)
    batches = _batches(steps + 1, b, 4)
    spec = EXPERT_RULES.get(rules)
    trules = None if spec is None else ShardingRules(
        [(pat, P(*s)) for pat, s in spec])
    jrules = None if spec is None else JRules([(pat, JP(*s))
                                               for pat, s in spec])
    axes = {"data": 2, "expert": 4}
    jh, jt = _train(axes, jrules, b, 1, 4.0, False, args, batches[:steps],
                    jax_side=True)
    th, tt = _train(axes, trules, b, 1, 4.0, False, args, batches[:steps])
    if spec is not None:
        assert tt._pieces and tt._tp_plan is None
        w1 = tt._member_params(5)["moe_expert1_weight"]
        assert tuple(w1.shape) == (1, D, H)
    oh, ot = _train({"data": 1}, None, b, 1, 4.0, False, args,
                    batches[:steps])
    np.testing.assert_allclose(th[0], oh[0], **ONE_DEVICE)
    np.testing.assert_allclose(th[0], jh[0], **JAX_HEAD)
    tp, op, jp = _tparams(tt), _tparams(ot), _jparams(jt)
    for n in op:
        np.testing.assert_allclose(tp[n], op[n], **ONE_DEVICE, err_msg=n)
        np.testing.assert_allclose(tp[n], jp[n], **JAX_PARAM, err_msg=n)
    if rules != "per_weight":
        return
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tt.save_state(mgr, blocking=True)
    mgr.wait_until_finished()
    with mxt.name.NameManager():
        net = _moe_net(mxt.symbol, 1, 4.0)
    dp = ShardedTrainer(net, "sgd", {"learning_rate": 0.1},
                        mesh=tmesh({"data": 2}))
    dp.bind({"data": (b, D)}, {"lro_label": (b, D)})
    dp.restore_state(mgr)
    for n, v in tp.items():
        np.testing.assert_array_equal(dp.get_params()[0][n].asnumpy(), v)
    hd = dp.step(batches[steps])[0].numpy()
    he = tt.step(batches[steps])[0].numpy()
    np.testing.assert_allclose(hd, he, **ONE_DEVICE)


@pytest.mark.parametrize("axes", [{"data": 1}, {"data": 2},
                                  {"data": 2, "expert": 2}],
                         ids=["data1", "data2", "data2-expert2"])
def test_grad_accum_stacks_the_aux_head_as_jax(axes):
    """The top-2 net with its 0-d aux head at ``grad_accum`` 2 (batch
    16): the head comes back as one value a microbatch, shape ``(2,)``,
    as the JAX trainer's scan stacks it; heads and parameters after 2
    steps against the JAX trainer on the same mesh.  At ``grad_accum`` 1
    the head stays 0-d in both.  Compressed gradients refuse the 0-d
    head at ``bind`` and name it (the JAX explicit mode cannot return
    it)."""
    from mxnet_tpu_torch.base import MXNetError
    b, steps = 16, 2
    args = _moe_args(11, b)
    batches = _batches(steps, b, 12)
    jh, jt = _train(axes, None, b, 2, 4.0, True, args, batches,
                    jax_side=True, grad_accum=2)
    th, tt = _train(axes, None, b, 2, 4.0, True, args, batches,
                    grad_accum=2)
    assert jh[1].shape == (2,)
    assert th[1].shape == (2,)
    for t, j in zip(th, jh):
        np.testing.assert_allclose(t, j, **JAX_HEAD)
    jp, tp = _jparams(jt), _tparams(tt)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], **JAX_PARAM, err_msg=n)
    th1, _ = _train(axes, None, b, 2, 4.0, True, args, batches[:1])
    assert th1[1].shape == ()
    if axes == {"data": 2}:
        with mxt.name.NameManager():
            net = _moe_net(mxt.symbol, 2, 4.0, True)
        tr = ShardedTrainer(net, "sgd", {"learning_rate": 0.1},
                            mesh=tmesh(axes), grad_compression="int8")
        with pytest.raises(MXNetError, match="moe_aux_loss"):
            tr.bind({"data": (b, D)}, {"lro_label": (b, D)})


def test_aux_loss_head_trains_toward_balance():
    """``test_moe.py``'s aux head: grouped with the task loss it moves
    routing toward uniform (the load-balance loss is 1.0 there)."""
    b = 32
    with mxt.name.NameManager():
        net = _moe_net(mxt.symbol, 2, 4.0, True)
    t = ShardedTrainer(net, "sgd", {"learning_rate": 0.05}, device="cpu")
    t.bind({"data": (b, D)}, {"lro_label": (b, D)})
    rng = np.random.RandomState(9)
    batch = {"data": rng.randn(b, D).astype(np.float32),
             "lro_label": rng.randn(b, D).astype(np.float32)}
    first = bal = None
    for _ in range(30):
        bal = float(t.step(batch)[1])
        first = bal if first is None else first
    assert np.isfinite(bal)
    assert bal <= first + 1e-3, (first, bal)
    assert bal < 1.5, bal


def test_refusals_name_what_is_missing():
    """A model axis beside the expert axis takes the trainer (parity:
    ``tests/test_torch_combined_meshes.py``); compressed gradients over
    an expert axis refuse and say why (the JAX trainer's manual region
    fails there too), not as a missing port; a pipe axis beside the
    data axis takes the dense MoE net as the JAX trainer does (the
    parameters replicated along it, the global batch routed over the
    data members): heads and parameters after 2 steps against the JAX
    trainer on the same mesh."""
    from mxnet_tpu_torch.base import MXNetError
    with mxt.name.NameManager():
        net = _moe_net(mxt.symbol)
    tr = ShardedTrainer(net, mesh=tmesh({"model": 2, "expert": 2}))
    assert tr._dup_axes == ["expert"] and tr.model_axis == "model"
    with pytest.raises(MXNetError, match="implicit mode") as err:
        ShardedTrainer(net, mesh=tmesh({"data": 2, "expert": 2}),
                       grad_compression="int8")
    assert "'expert' axis" in str(err.value)
    assert "not ported" not in str(err.value)
    b = 16
    args = _moe_args(5, b)
    batches = _batches(2, b, 6)
    axes = {"data": 2, "pipe": 2}
    jh, jt = _train(axes, None, b, 1, 4.0, False, args, batches,
                    jax_side=True)
    th, tt = _train(axes, None, b, 1, 4.0, False, args, batches)
    assert tt._dup_axes == ["pipe"]
    np.testing.assert_allclose(th[0], jh[0], **JAX_HEAD)
    tp, jp = _tparams(tt), _jparams(jt)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], **JAX_PARAM, err_msg=n)
