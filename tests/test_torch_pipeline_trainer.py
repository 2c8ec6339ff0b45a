"""``PipelineTrainer`` of the PyTorch port (``parallel/pipeline_trainer.
py``) against the JAX package's ``PipelineTrainer``, its
``tests/test_pipeline_trainer.py`` and the port's own ``ShardedTrainer``,
on the CPU.

The JAX side runs on the virtual CPU devices ``tests/conftest.py`` gives
it; the port's stages run on CPU contexts ``cpu(0)`` ... ``cpu(7)``.
Symbols are built under fresh name managers so names (and so the
``arg_params`` carried across) match; inputs and parameters are numpy
arrays from a seed.

Tolerances, as stated in each test:

* f32 steps against ``ShardedTrainer`` and against the JAX pipeline:
  ``tests/test_pipeline_trainer.py``'s bounds (heads rtol 2e-5 / atol
  2e-6, parameters rtol 3e-5 / atol 3e-6 after 3 steps; dp x pp heads
  2e-5 / 2e-5 and parameters 2e-4 / 2e-4);
* the small LM (flash attention's plain versions): heads rtol 1e-4 /
  atol 1e-5 and parameters rtol 1e-4 / atol 1e-6 against the JAX
  pipeline (``tests/test_torch_parallel.py``'s trainer bounds);
* bf16 compute against the JAX pipeline: bf16's rtol 2e-2 / atol 2e-2;
* the stage partition: exactly the JAX package's node -> stage map.

``test_pipeline_trains_to_high_accuracy`` and the training half of
``test_pipeline_amp_matches_jax_and_trains`` draw their initial weights
from the port's seeded initializer (the JAX tests from
``mx.random.seed``), so they hold the port to the same accuracy bar, not
to the JAX weights.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import PipelineTrainer as JPipe
from mxnet_tpu.parallel.pipeline_trainer import \
    _assign_stages as j_assign_stages

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import PipelineTrainer, ShardedTrainer
from mxnet_tpu_torch.parallel.pipeline_trainer import _assign_stages
from mxnet_tpu_torch.random import GraphKey, mix

HEAD = dict(rtol=2e-5, atol=2e-6)
PARAM = dict(rtol=3e-5, atol=3e-6)
DP_HEAD = dict(rtol=2e-5, atol=2e-5)
DP_PARAM = dict(rtol=2e-4, atol=2e-4)
LM_HEAD = dict(rtol=1e-4, atol=1e-5)
LM_PARAM = dict(rtol=1e-4, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
OPT = {"learning_rate": 0.5, "momentum": 0.9}


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


def _mlp4(S, widths=(48, 32, 24, 10), grouped=False, dropout=False):
    """A 4-layer MLP with different widths a stage; ``grouped`` puts each
    layer in its own ``ctx_group``."""
    pkg = mx if S is mx.sym else mxt

    def group(i):
        return (pkg.AttrScope(ctx_group=f"stage{i}") if grouped
                else contextlib.nullcontext())

    net = S.Variable("data")
    for i, w in enumerate(widths[:-1]):
        with group(i):
            net = S.FullyConnected(data=net, num_hidden=w, name=f"fc{i}")
            net = S.Activation(data=net, act_type="tanh")
            if dropout and i == 1:
                net = S.Dropout(data=net, p=0.5)
    with group(3):
        net = S.FullyConnected(data=net, num_hidden=widths[-1],
                               name="fc_out")
        return S.SoftmaxOutput(data=net, name="softmax")


def _pair(**kw):
    """The JAX and the port symbol of ``_mlp4(**kw)``, same names."""
    with mx.name.NameManager(), mxt.name.NameManager():
        return _mlp4(mx.sym, **kw), _mlp4(mxt.sym, **kw)


def _init(sym, shapes, seed=5):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.4, 0.4, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _batches(shapes, n=3, seed=0, classes=10):
    rng = np.random.RandomState(seed)
    return [{"data": rng.rand(*shapes["data"]).astype(np.float32),
             "softmax_label": rng.randint(0, classes, shapes["softmax_label"])
             .astype(np.float32)} for _ in range(n)]


def _bind(tr, shapes, args=None, aux=None, jax_side=False):
    conv = (lambda d: {k: jnp.asarray(v) for k, v in d.items()}) \
        if jax_side else (lambda d: d)
    tr.bind(data_shapes={"data": shapes["data"]},
            label_shapes={"softmax_label": shapes["softmax_label"]},
            arg_params=None if args is None else conv(args),
            aux_params=None if aux is None else conv(aux))
    return tr


def _port_ref(sym, shapes, args, opt=OPT, **kw):
    tr = ShardedTrainer(sym, optimizer="sgd", optimizer_params=opt,
                        device="cpu", **kw)
    return _bind(tr, shapes, args)


def _np(h):
    return h.detach().float().numpy() if isinstance(h, torch.Tensor) \
        else np.asarray(h)


@pytest.mark.parametrize("grouped", [False, True])
def test_pipeline_matches_sharded_trainer(grouped):
    """4 stages x 4 microbatches, SGD with momentum, 3 steps: the port's
    pipeline against the port's ShardedTrainer and the JAX pipeline."""
    shapes = {"data": (16, 20), "softmax_label": (16,)}
    jsym, tsym = _pair(grouped=grouped)
    args = _init(tsym, shapes)
    g2s = {f"stage{i}": i for i in range(4)} if grouped else None
    pp = _bind(PipelineTrainer(tsym, num_stages=4, num_microbatches=4,
                               group2stage=g2s, optimizer="sgd",
                               optimizer_params=OPT, devices=cpus(4)),
               shapes, args)
    assert all(len(p) >= 1 for p in pp._params), \
        [sorted(p) for p in pp._params]
    jp = _bind(JPipe(jsym, num_stages=4, num_microbatches=4,
                     group2stage=g2s, optimizer="sgd",
                     optimizer_params=OPT), shapes, args, jax_side=True)
    assert [sorted(p) for p in pp._params] == \
        [sorted(p) for p in jp._params]
    ref = _port_ref(tsym, shapes, args)
    for b in _batches(shapes):
        out_pp = pp.step(b)[0]
        np.testing.assert_allclose(_np(out_pp), _np(ref.step(b)[0]), **HEAD)
        np.testing.assert_allclose(_np(out_pp), _np(jp.step(b)[0]), **HEAD)
    arg_pp, _ = pp.get_params()
    arg_ref, _ = ref.get_params()
    arg_j, _ = jp.get_params()
    for n in arg_ref:
        np.testing.assert_allclose(arg_pp[n].asnumpy(),
                                   arg_ref[n].asnumpy(), **PARAM, err_msg=n)
        np.testing.assert_allclose(arg_pp[n].asnumpy(), arg_j[n].asnumpy(),
                                   **PARAM, err_msg=n)


def _lm(pkg, **kw):
    from mxnet_tpu import models as jmodels
    from mxnet_tpu_torch import models as tmodels
    mod = jmodels if pkg is mx else tmodels
    return mod.get_symbol("transformer-lm", **kw)


def test_assign_stages_matches_jax():
    """The node -> stage map equals the JAX package's: the MLP balanced
    automatically into 2, 3 and 4 stages and by its ctx_group attrs, and
    the full-width LM (vocab 32000, 6 layers, d 512, 8 heads, batch 8,
    seq 2048; shape inference only) into 4 stages."""
    cases = []
    shapes = {"data": (16, 20), "softmax_label": (16,)}
    for grouped in (False, True):
        jsym, tsym = _pair(grouped=grouped)
        g2s = {f"stage{i}": i for i in range(4)} if grouped else None
        for s in ((4,) if grouped else (2, 3, 4)):
            cases.append((jsym, tsym, shapes, s, g2s))
    lm = dict(vocab_size=32000, num_layers=6, d_model=512, heads=8,
              batch_size=8, seq_len=2048, loss_head=True)
    with mx.name.NameManager(), mxt.name.NameManager():
        cases.append((_lm(mx, **lm), _lm(mxt, **lm),
                      {"data": (8, 2048), "softmax_label": (8, 2048)}, 4,
                      None))
    for jsym, tsym, shp, s, g2s in cases:
        maps = []
        for sym, fn in ((jsym, j_assign_stages), (tsym, _assign_stages)):
            names = sym.list_arguments()
            arg_shapes, _, _ = sym.infer_shape(**shp)
            topo = sym._topo()
            st = fn(topo, s, g2s, dict(zip(names, arg_shapes)), set(shp))
            maps.append({n.name: st[id(n)] for n in topo
                         if not n.is_variable})
        assert maps[1] == maps[0], (s, g2s)
        assert sorted(set(maps[1].values())) == list(range(s))


def test_pipeline_stage_contexts_and_heterogeneous_shapes():
    """Stages on 4 distinct contexts hold different shapes; the same
    pipeline on one context repeated 4 times (the stages run one after
    another there) is bitwise the same."""
    shapes = {"data": (8, 20), "softmax_label": (8,)}
    _, sym = _pair()
    args = _init(sym, shapes)
    pp = _bind(PipelineTrainer(sym, num_stages=4, num_microbatches=2,
                               optimizer="sgd",
                               optimizer_params={"learning_rate": 0.1},
                               devices=cpus(4)), shapes, args)
    assert [m.members[0] for m in pp._stage_meshes] == cpus(4)
    widths = {s: {tuple(v.shape) for v in ps.values()}
              for s, ps in enumerate(pp._params)}
    assert widths[0] != widths[1] != widths[2]
    same = _bind(PipelineTrainer(sym, num_stages=4, num_microbatches=2,
                                 optimizer="sgd",
                                 optimizer_params={"learning_rate": 0.1},
                                 devices=[mxt.cpu(0)] * 4), shapes, args)
    for b in _batches(shapes, 2):
        assert torch.equal(pp.step(b)[0], same.step(b)[0])
    a, b_ = pp.get_params()[0], same.get_params()[0]
    for n in a:
        np.testing.assert_array_equal(a[n].asnumpy(), b_[n].asnumpy())


def _late_input(S):
    data = S.Variable("data")
    net = S.FullyConnected(data=data, num_hidden=16, name="fa")
    net = S.Activation(data=net, act_type="tanh")
    net = S.FullyConnected(data=net, num_hidden=16, name="fb")
    net = net + data  # 'data' consumed again at the last stage
    net = S.FullyConnected(data=net, num_hidden=4, name="fc")
    return S.SoftmaxOutput(data=net, name="softmax")


def test_pipeline_input_consumed_by_late_stage():
    """A batch input used again deep in the net is injected at every
    stage that consumes it: heads and parameters after 2 steps against
    the JAX pipeline and the port's ShardedTrainer."""
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet, tnet = _late_input(mx.sym), _late_input(mxt.sym)
    shapes = {"data": (8, 16), "softmax_label": (8,)}
    args = _init(tnet, shapes)
    opt = {"learning_rate": 0.1}
    pp = _bind(PipelineTrainer(tnet, num_stages=2, num_microbatches=2,
                               optimizer="sgd", optimizer_params=opt,
                               devices=cpus(2)), shapes, args)
    assert pp._stage_inputs == [["data"], ["data", "softmax_label"]]
    jp = _bind(JPipe(jnet, num_stages=2, num_microbatches=2,
                     optimizer="sgd", optimizer_params=opt), shapes, args,
               jax_side=True)
    ref = _port_ref(tnet, shapes, args, opt)
    for b in _batches(shapes, 2, classes=4):
        out = pp.step(b)[0]
        assert np.all(np.isfinite(_np(out)))
        np.testing.assert_allclose(_np(out), _np(jp.step(b)[0]), **HEAD)
        np.testing.assert_allclose(_np(out), _np(ref.step(b)[0]), **HEAD)
    arg_pp, arg_j = pp.get_params()[0], jp.get_params()[0]
    for n in arg_j:
        np.testing.assert_allclose(arg_pp[n].asnumpy(), arg_j[n].asnumpy(),
                                   **PARAM, err_msg=n)


def test_pipeline_shared_param_across_stages_rejected():
    """A weight tied across stages raises a clear error, and so does a
    stochastic optimizer and a ctx_group the map does not name."""
    S = mxt.sym
    d = S.Variable("data")
    w2 = S.Variable("shared_weight")
    with mxt.AttrScope(ctx_group="s0"):
        h2 = S.FullyConnected(data=d, weight=w2, num_hidden=16,
                              no_bias=True, name="f0")
    with mxt.AttrScope(ctx_group="s1"):
        h2 = S.FullyConnected(data=h2, weight=w2, num_hidden=16,
                              no_bias=True, name="f1")
        h2 = S.SoftmaxOutput(data=h2, name="softmax")
    tr = PipelineTrainer(h2, num_stages=2, num_microbatches=2,
                         group2stage={"s0": 0, "s1": 1}, optimizer="sgd",
                         devices=cpus(2))
    with pytest.raises(MXNetError, match="multiple pipeline"):
        tr.bind(data_shapes={"data": (4, 16)},
                label_shapes={"softmax_label": (4,)})
    with pytest.raises(MXNetError, match="stochastic"):
        PipelineTrainer(h2, num_stages=2, optimizer="sgld", devices=cpus(2))
    tr = PipelineTrainer(h2, num_stages=2, group2stage={"s0": 0},
                         devices=cpus(2))
    with pytest.raises(MXNetError, match="not in group2stage"):
        tr.bind(data_shapes={"data": (4, 16)},
                label_shapes={"softmax_label": (4,)})


def _train_to_accuracy(pp, steps=40, seed=3):
    rng = np.random.RandomState(seed)
    b = pp._input_shapes["data"][0]
    proto = rng.randn(4, 16).astype(np.float32) * 2
    acc = []
    for _ in range(steps):
        y = rng.randint(0, 4, b)
        x = proto[y] + rng.randn(b, 16).astype(np.float32) * 0.3
        out = pp.step({"data": x, "softmax_label": y.astype(np.float32)})
        acc.append(float((_np(out[0]).argmax(1) == y).mean()))
    return acc


def test_pipeline_trains_to_high_accuracy():
    _, net = _pair(widths=(32, 24, 16, 4))
    pp = PipelineTrainer(net, num_stages=4, num_microbatches=4,
                         optimizer="sgd", optimizer_params=OPT,
                         devices=cpus(4), seed=11)
    pp.bind(data_shapes={"data": (32, 16)},
            label_shapes={"softmax_label": (32,)})
    acc = _train_to_accuracy(pp)
    assert np.mean(acc[-5:]) > 0.9, acc[-5:]


def test_pipeline_amp_matches_jax_and_trains():
    """``compute_dtype="bfloat16"`` through the stages: 2 steps against
    the JAX pipeline at bf16's tolerance, then training to accuracy with
    f32 masters on every stage."""
    shapes = {"data": (16, 16), "softmax_label": (16,)}
    jnet, net = _pair(widths=(32, 24, 16, 4))
    args = _init(net, shapes, seed=6)
    kw = dict(num_stages=4, num_microbatches=2, optimizer="sgd",
              optimizer_params=OPT, compute_dtype="bfloat16")
    pp = _bind(PipelineTrainer(net, devices=cpus(4), **kw), shapes, args)
    jp = _bind(JPipe(jnet, **kw), shapes, args, jax_side=True)
    for b in _batches(shapes, 2, seed=7, classes=4):
        np.testing.assert_allclose(_np(pp.step(b)[0]), _np(jp.step(b)[0]),
                                   **BF16)
    arg_pp, arg_j = pp.get_params()[0], jp.get_params()[0]
    for n in arg_j:
        np.testing.assert_allclose(arg_pp[n].asnumpy(), arg_j[n].asnumpy(),
                                   **BF16, err_msg=n)
    pp = PipelineTrainer(net, devices=cpus(4), seed=11, **kw)
    pp.bind(data_shapes={"data": (16, 16)},
            label_shapes={"softmax_label": (16,)})
    acc = _train_to_accuracy(pp, seed=4)
    assert np.mean(acc[-5:]) > 0.9, acc[-5:]
    for ps in pp._params:
        for n, v in ps.items():
            assert v.dtype == torch.float32, (n, v.dtype)


def _bn_mlp(S):
    net = S.Variable("data")
    net = S.FullyConnected(data=net, num_hidden=24, name="fc0")
    net = S.BatchNorm(data=net, name="bn0", fix_gamma=False)
    net = S.Activation(data=net, act_type="tanh")
    net = S.FullyConnected(data=net, num_hidden=16, name="fc1")
    net = S.Activation(data=net, act_type="tanh")
    net = S.FullyConnected(data=net, num_hidden=12, name="fc2")
    net = S.BatchNorm(data=net, name="bn1", fix_gamma=False)
    net = S.FullyConnected(data=net, num_hidden=10, name="fc_out")
    return S.SoftmaxOutput(data=net, name="softmax")


@pytest.mark.parametrize("net", ["mlp", "batchnorm"])
def test_pipeline_composes_with_data_parallel(net):
    """dp 2 x pp 4 over 8 contexts: each stage runs over its column's two
    members, BatchNorm's moments over the whole microbatch (the members
    meet); 3 steps against the JAX pipeline over 8 devices (heads,
    parameters, moving statistics) and the port's ShardedTrainer on one
    context; the inference forward too."""
    shapes = {"data": (16, 20), "softmax_label": (16,)}
    if net == "mlp":
        jsym, tsym = _pair()
    else:
        with mx.name.NameManager(), mxt.name.NameManager():
            jsym, tsym = _bn_mlp(mx.sym), _bn_mlp(mxt.sym)
    args = _init(tsym, shapes)
    pp = _bind(PipelineTrainer(tsym, num_stages=4, num_microbatches=4,
                               data_parallel=2, optimizer="sgd",
                               optimizer_params=OPT, devices=cpus(8)),
               shapes, args)
    assert [m.members for m in pp._stage_meshes] == \
        [[mxt.cpu(s), mxt.cpu(4 + s)] for s in range(4)]
    jp = _bind(JPipe(jsym, num_stages=4, num_microbatches=4,
                     data_parallel=2, optimizer="sgd",
                     optimizer_params=OPT), shapes, args, jax_side=True)
    for b in _batches(shapes, 3):
        out_pp = pp.step(b)[0]
        out_j = jp.step(b)[0]
        np.testing.assert_allclose(_np(out_pp), _np(out_j), **DP_HEAD)
    arg_pp, aux_pp = pp.get_params()
    arg_j, aux_j = jp.get_params()
    for n in arg_j:
        np.testing.assert_allclose(arg_pp[n].asnumpy(), arg_j[n].asnumpy(),
                                   **DP_PARAM, err_msg=n)
    for n in aux_j:
        np.testing.assert_allclose(aux_pp[n].asnumpy(), aux_j[n].asnumpy(),
                                   **DP_PARAM, err_msg=n)
    ev = _batches(shapes, 1, seed=9)[0]
    np.testing.assert_allclose(_np(pp.forward(ev)[0]),
                               _np(jp.forward(ev)[0]), **DP_HEAD)
    if net == "mlp":
        ref = _port_ref(tsym, shapes, args)
        for b in _batches(shapes, 3):
            ref.step(b)
        arg_ref, _ = ref.get_params()
        for n in arg_ref:
            np.testing.assert_allclose(arg_pp[n].asnumpy(),
                                       arg_ref[n].asnumpy(), **DP_PARAM,
                                       err_msg=n)
        np.testing.assert_allclose(_np(pp.forward(ev)[0]),
                                   _np(ref.forward(ev)[0]), **DP_HEAD)


def test_pipeline_1f1b_caps_inflight():
    """The dispatch order never holds more than S - s in-flight
    microbatch forwards at stage s (1F1B), even with M >> S: observed by
    wrapping the per-stage forward and backward callables."""
    shapes = {"data": (32, 20), "softmax_label": (32,)}
    _, sym = _pair()
    S, M = 2, 8
    pp = _bind(PipelineTrainer(sym, num_stages=S, num_microbatches=M,
                               optimizer="sgd",
                               optimizer_params={"learning_rate": 0.1},
                               devices=cpus(S)), shapes)
    live, peak = [0] * S, [0] * S

    def wrap_fwd(fn, s):
        def run(*a):
            live[s] += 1
            peak[s] = max(peak[s], live[s])
            return fn(*a)
        return run

    def wrap_bwd(fn, s):
        def run(*a):
            live[s] -= 1
            return fn(*a)
        return run

    pp._fwd = [wrap_fwd(f, s) for s, f in enumerate(pp._fwd)]
    pp._bwd = [wrap_bwd(f, s) for s, f in enumerate(pp._bwd)]
    out = pp.step(_batches(shapes, 1)[0])
    assert np.all(np.isfinite(_np(out[0])))
    assert live == [0] * S
    for s in range(S):
        assert peak[s] <= S - s, (s, peak, "1F1B cap violated")


def test_pipeline_dp_with_grouped_stages():
    """dp 2 composes with ctx_group stage assignment too: 2 steps against
    the JAX pipeline."""
    shapes = {"data": (16, 20), "softmax_label": (16,)}
    jsym, tsym = _pair(grouped=True)
    args = _init(tsym, shapes)
    g2s = {f"stage{i}": i for i in range(4)}
    kw = dict(num_stages=4, num_microbatches=4, data_parallel=2,
              group2stage=g2s, optimizer="sgd", optimizer_params=OPT)
    pp = _bind(PipelineTrainer(tsym, devices=cpus(8), **kw), shapes, args)
    jp = _bind(JPipe(jsym, **kw), shapes, args, jax_side=True)
    for b in _batches(shapes, 2):
        out_pp = pp.step(b)
        out_j = jp.step(b)
    np.testing.assert_allclose(_np(out_pp[0]), _np(out_j[0]), **DP_HEAD)


def test_pipeline_remat_draws_the_forward_masks():
    """A Dropout net over 2 stages at one microbatch: the stage backward
    re-runs the forward with the microbatch's key, so the step equals one
    forward and backward of the whole graph under that key (the heads,
    and the SGD update from its gradients)."""
    shapes = {"data": (8, 20), "softmax_label": (8,)}
    _, sym = _pair(dropout=True)
    args = _init(sym, shapes)
    lr = 0.1
    pp = _bind(PipelineTrainer(sym, num_stages=2, num_microbatches=1,
                               optimizer="sgd",
                               optimizer_params={"learning_rate": lr},
                               devices=cpus(2), seed=3), shapes, args)
    b = _batches(shapes, 1, seed=2)[0]
    heads = pp.step(b)[0]
    from mxnet_tpu_torch.graph_eval import eval_symbol
    leaves = {n: torch.tensor(v, requires_grad=True)
              for n, v in args.items()}
    vals = dict(leaves, data=torch.tensor(b["data"]),
                softmax_label=torch.tensor(b["softmax_label"]))
    want, _ = eval_symbol(sym, vals, {}, GraphKey(mix(3, 1, 0), "cpu"), True)
    assert torch.equal(heads, want[0].detach())
    want[0].backward(torch.ones_like(want[0]))
    got = pp.get_params()[0]
    for n, p in leaves.items():
        step = p.detach() - lr * (p.grad / 8)
        np.testing.assert_allclose(got[n].asnumpy(), step.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_pipeline_lm_matches_jax():
    """The transformer LM (vocab 61, 2 layers, d 32, 2 heads, batch 4,
    seq 128, blocks of 64: the flash family, its plain versions on the
    CPU; the loss head) over 2 stages x 2 microbatches: 2 SGD steps
    against the JAX pipeline, and its stage partition."""
    kw = dict(vocab_size=61, num_layers=2, d_model=32, heads=2,
              batch_size=4, seq_len=128, loss_head=True, attn_block_size=64)
    with mx.name.NameManager(), mxt.name.NameManager():
        jsym, tsym = _lm(mx, **kw), _lm(mxt, **kw)
    shapes = {"data": (4, 128), "softmax_label": (4, 128)}
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = tsym.infer_shape(**shapes)
    args = {n: (rng.randn(*s) * 0.05).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), arg_shapes)
            if n not in shapes}
    opt = {"learning_rate": 0.1}
    pk = dict(num_stages=2, num_microbatches=2, optimizer="sgd",
              optimizer_params=opt)
    pp = _bind(PipelineTrainer(tsym, devices=cpus(2), **pk), shapes, args)
    jp = _bind(JPipe(jsym, **pk), shapes, args, jax_side=True)
    assert [sorted(p) for p in pp._params] == \
        [sorted(p) for p in jp._params]
    assert pp._env_after == jp._env_after
    for step in range(2):
        toks = rng.randint(0, 61, (4, 129))
        b = {"data": toks[:, :-1].astype(np.float32),
             "softmax_label": toks[:, 1:].astype(np.float32)}
        np.testing.assert_allclose(_np(pp.step(b)[0]), _np(jp.step(b)[0]),
                                   **LM_HEAD)
    arg_pp, arg_j = pp.get_params()[0], jp.get_params()[0]
    for n in arg_j:
        np.testing.assert_allclose(arg_pp[n].asnumpy(), arg_j[n].asnumpy(),
                                   **LM_PARAM, err_msg=n)
