"""The legacy training API of the PyTorch port (``model.FeedForward``,
``module/``, ``monitor.Monitor``, ``resilience.LegacyGuard``) against the
JAX package's, on the CPU.

The cases of the JAX package's ``tests/test_module.py``,
``tests/test_training.py`` (``FeedForward`` on one device) and
``tests/test_monitor_viz.py`` (the monitor) run in both packages on the
same symbols (built under a fresh NameManager in each), the same numpy
initial parameters, the same batches in the same order (iterators
without shuffling) and the same optimizer settings, and are held to the
JAX package's results rather than to thresholds only: parameters within
rtol 1e-4, atol 1e-6 and outputs within atol 1e-5 (f32 summation order
differs between XLA and ATen, carried through tens of SGD steps), scores
and the epoch log lines (less the ``Time cost`` seconds) equal, monitor
rows equal by name with their statistics within rtol 1e-5, optimizer
states saved by either package loading in the other.
"""
import logging
import os
import re

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu import nd as jnd, sym as jsym
from mxnet_tpu.io import DataBatch as JBatch, NDArrayIter as JIter

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd as tnd, sym as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import DataBatch as TBatch, NDArrayIter as TIter

PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
OUT_ATOL = 1e-5
J = dict(mx=mx, sym=jsym, nd=jnd, Batch=JBatch, Iter=JIter, ctx=mx.cpu())
T = dict(mx=mxt, sym=tsym, nd=tnd, Batch=TBatch, Iter=TIter, ctx=mxt.cpu())


@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    """JAX executors and initializers draw from the JAX package's global
    PRNG: restore it, so the test files that run after this one in the
    same process draw what they would draw without it."""
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


@pytest.fixture
def keep_port_random_state():
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


def make_blobs(n=200, num_classes=4, dim=10, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(num_classes, dim) * 3
    X = np.zeros((n, dim), np.float32)
    y = np.zeros((n,), np.float32)
    for i in range(n):
        c = i % num_classes
        X[i] = centers[c] + rs.randn(dim) * 0.5
        y[i] = c
    return X, y


def mlp_symbol(S, num_classes=4, num_hidden=32):
    net = S.FullyConnected(data=S.Variable("data"), num_hidden=num_hidden,
                           name="fc1")
    net = S.Activation(data=net, act_type="relu", name="relu1")
    net = S.FullyConnected(data=net, num_hidden=num_classes, name="fc2")
    return S.SoftmaxOutput(data=net, name="softmax")


def both(make):
    with mx.name.NameManager(), mxt.name.NameManager():
        return make(J), make(T)


def init_params(sym, data_shape, seed=0, scale=0.1, data="data"):
    shapes, _, _ = sym.infer_shape(**{data: data_shape})
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-scale, scale, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in (data, "softmax_label")}


def nds(pkg, params):
    return {k: pkg["nd"].array(v) for k, v in params.items()}


class Lines(logging.Handler):
    """Collects a logger's lines, the seconds of ``Time cost`` dropped."""

    def __init__(self, name):
        super().__init__()
        self.lines = []
        self.logger = logging.getLogger(name)
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.addHandler(self)

    def emit(self, record):
        self.lines.append(re.sub(r"Time cost=[0-9.]+", "Time cost",
                                 record.getMessage()))


def close_params(tp, jp):
    assert sorted(tp) == sorted(jp)
    for n in jp:
        np.testing.assert_allclose(tp[n].asnumpy(), jp[n].asnumpy(),
                                   err_msg=n, **PARAM_TOL)


# ---------------------------------------------------------------------------
# FeedForward (tests/test_training.py, one device)
# ---------------------------------------------------------------------------

def _feedforward(pkg, sym, args, logger, num_epoch, **kw):
    return pkg["mx"].FeedForward(sym, ctx=pkg["ctx"], num_epoch=num_epoch,
                                 optimizer="sgd", learning_rate=0.5,
                                 arg_params=nds(pkg, args),
                                 initializer=pkg["mx"].initializer.Uniform(
                                     0.1), **kw)


def test_feedforward_fit_predict_score_match_jax():
    X, y = make_blobs(n=400)
    jsym_, tsym_ = both(lambda p: mlp_symbol(p["sym"]))
    args = init_params(tsym_, (50, 10))
    res = []
    for pkg, sym in ((J, jsym_), (T, tsym_)):
        log = Lines(f"legacy-ff-{id(pkg)}")
        model = _feedforward(pkg, sym, args, log.logger, num_epoch=5)
        model.fit(pkg["Iter"](X, y, batch_size=50),
                  eval_data=pkg["Iter"](X[:100], y[:100], batch_size=50),
                  eval_metric="acc", kvstore=None, logger=log.logger)
        acc = model.score(pkg["Iter"](X, y, batch_size=50))
        preds = model.predict(X[:64])
        res.append((model, log.lines, acc, preds))
    (jm, jlines, jacc, jpred), (tm, tlines, tacc, tpred) = res
    close_params(tm.arg_params, jm.arg_params)
    assert tlines == jlines and any("Validation-accuracy" in s
                                    for s in tlines)
    assert tacc == jacc and tacc > 0.95
    assert tpred.shape == (64, 4)
    np.testing.assert_allclose(tpred, jpred, rtol=0, atol=OUT_ATOL)


def test_feedforward_checkpoint_roundtrip_matches_jax(tmp_path):
    X, y = make_blobs(n=120)
    jsym_, tsym_ = both(lambda p: mlp_symbol(p["sym"]))
    args = init_params(tsym_, (40, 10))
    models = {}
    for tag, pkg, sym in (("j", J, jsym_), ("t", T, tsym_)):
        prefix = str(tmp_path / tag)
        model = _feedforward(pkg, sym, args, None, num_epoch=3,
                             numpy_batch_size=40)
        model.fit(pkg["Iter"](X, y, batch_size=40), kvstore=None,
                  epoch_end_callback=pkg["mx"].callback.do_checkpoint(prefix))
        assert os.path.exists(prefix + "-symbol.json")
        assert os.path.exists(prefix + "-0003.params")
        models[tag] = model
    # each package loads the other's checkpoint and predicts alike
    jl = mx.FeedForward.load(str(tmp_path / "t"), 3, ctx=mx.cpu())
    tl = mxt.FeedForward.load(str(tmp_path / "j"), 3, ctx=mxt.cpu())
    tp = models["t"].predict(X[:40])
    np.testing.assert_allclose(tl.predict(X[:40]), models["j"].predict(
        X[:40]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(jl.predict(X[:40]), tp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp, models["j"].predict(X[:40]), rtol=0,
                               atol=OUT_ATOL)
    # the CheckpointManager round trip, across packages both ways
    from mxnet_tpu.checkpoint import CheckpointManager as JMgr
    from mxnet_tpu_torch.checkpoint import CheckpointManager as TMgr
    for tag, Mgr, Other, other_ctx in (("t", TMgr, JMgr, mx.cpu()),
                                       ("j", JMgr, TMgr, mxt.cpu())):
        mgr = Mgr(str(tmp_path / f"mgr-{tag}"))
        models[tag].save_to_manager(mgr, blocking=True)
        mgr.close()
        other = Other(str(tmp_path / f"mgr-{tag}"))
        pkg = mx if Other is JMgr else mxt
        loaded = pkg.FeedForward.load_from_manager(other, ctx=other_ctx)
        other.close()
        assert loaded.begin_epoch == 3
        np.testing.assert_allclose(loaded.predict(X[:40]),
                                   models[tag].predict(X[:40]), rtol=0,
                                   atol=1e-6)


def test_feedforward_refuses_what_needs_a_kvstore_or_devices(
        keep_port_random_state):
    X, y = make_blobs(n=40)
    with mxt.name.NameManager():
        sym = mlp_symbol(tsym)
    # the multi-process kvstore needs a launched cluster
    # (tests/test_torch_dist_kvstore.py runs one)
    with pytest.raises(MXNetError, match="launch"):
        mxt.FeedForward(sym, ctx=mxt.cpu(), num_epoch=1).fit(
            TIter(X, y, batch_size=20), kvstore="dist_sync")
    # two contexts train now (the data-parallel slice)
    model = mxt.FeedForward(sym, ctx=[mxt.cpu(0), mxt.cpu(1)], num_epoch=1,
                            learning_rate=0.5)
    model.fit(TIter(X, y, batch_size=20))
    assert all(np.isfinite(v.asnumpy()).all()
               for v in model.arg_params.values())


# ---------------------------------------------------------------------------
# several contexts and a kvstore (tests/test_training.py, the
# reference's ctx=[gpu(0), gpu(1)]: here two CPU contexts in each package)
# ---------------------------------------------------------------------------

KVSTORES = ("local", "device", "local_allreduce_cpu")


def _two(pkg):
    return [pkg["mx"].cpu(0), pkg["mx"].cpu(1)]


@pytest.mark.parametrize("kvstore", KVSTORES)
def test_feedforward_over_two_contexts_matches_jax(kvstore,
                                                  keep_port_random_state):
    """``FeedForward(ctx=[cpu(0), cpu(1)])`` with each local kvstore kind
    (the update on the kvstore for ``local``, auto-selected to
    ``local_update_cpu``, and ``device``; locally after the reduction for
    ``local_allreduce_cpu``): parameters rtol 1e-4 / atol 1e-6, the epoch
    lines and the score equal to the JAX package's; the gradients meet in
    one bucketed reduction a flush (the contexts are distinct)."""
    X, y = make_blobs(n=200)
    jsym_, tsym_ = both(lambda p: mlp_symbol(p["sym"]))
    args = init_params(tsym_, (50, 10))
    res = []
    for pkg, sym in ((J, jsym_), (T, tsym_)):
        log = Lines(f"legacy-ff2-{kvstore}-{id(pkg)}")
        model = pkg["mx"].FeedForward(
            sym, ctx=_two(pkg), num_epoch=3, optimizer="sgd",
            learning_rate=0.5, momentum=0.9, arg_params=nds(pkg, args),
            initializer=pkg["mx"].initializer.Uniform(0.1))
        with pkg["mx"].parallel.collectives.count_collectives() as stats:
            model.fit(pkg["Iter"](X, y, batch_size=50), kvstore=kvstore,
                      logger=log.logger)
        kinds = {r["kind"] for r in stats.records}
        res.append((model, log.lines, model.score(
            pkg["Iter"](X, y, batch_size=50)), kinds))
    (jm, jlines, jacc, jkinds), (tm, tlines, tacc, tkinds) = res
    close_params(tm.arg_params, jm.arg_params)
    assert tlines == jlines
    assert tacc == jacc and tacc > 0.9
    assert tkinds == jkinds == {"bucket"}


def test_create_kvstore_selects_as_jax():
    """``model._create_kvstore``: no kvstore on one device without
    ``dist``; ``local`` picks ``local_update_cpu`` below 16M elements in
    the largest parameter and ``local_allreduce_cpu`` from there (the
    update then stays local); a kvstore object passes through; the kind
    and ``update_on_kvstore`` equal the JAX package's."""
    from types import SimpleNamespace
    from mxnet_tpu import model as jmodel
    from mxnet_tpu_torch import model as tmodel
    small = {"w": SimpleNamespace(shape=(1024, 1024))}
    large = {"w": SimpleNamespace(shape=(4096, 4096))}
    for kv, ndev, params in (("local", 1, small), ("local", 2, small),
                             ("local", 2, large), ("device", 2, small),
                             ("local_allreduce_device", 2, small),
                             (None, 2, small)):
        jkv, jup = jmodel._create_kvstore(kv, ndev, params)
        tkv, tup = tmodel._create_kvstore(kv, ndev, params)
        assert (tkv is None) == (jkv is None), kv
        assert tup == jup, (kv, ndev)
        if tkv is not None:
            assert tkv.type == jkv.type
    store = mxt.kvstore.create("device")
    assert tmodel._create_kvstore(store, 2, small) == (store, True)


def test_feedforward_work_load_list_matches_jax(keep_port_random_state):
    """``work_load_list=[1, 3]`` over two contexts: the batch of 50 split
    12 / 38 in both packages, parameters rtol 1e-4 / atol 1e-6."""
    X, y = make_blobs(n=200)
    jsym_, tsym_ = both(lambda p: mlp_symbol(p["sym"]))
    args = init_params(tsym_, (50, 10))
    models = []
    for pkg, sym in ((J, jsym_), (T, tsym_)):
        model = pkg["mx"].FeedForward(
            sym, ctx=_two(pkg), num_epoch=2, optimizer="sgd",
            learning_rate=0.5, arg_params=nds(pkg, args),
            initializer=pkg["mx"].initializer.Uniform(0.1))
        model.fit(pkg["Iter"](X, y, batch_size=50), kvstore="device",
                  work_load_list=[1, 3])
        models.append(model)
    close_params(models[1].arg_params, models[0].arg_params)
    from mxnet_tpu_torch.executor_manager import _split_input_slice
    assert _split_input_slice(50, [1, 3]) == [slice(0, 12), slice(12, 50)]


def _module_two(pkg, sym, args, X, y, kvstore, num_epoch=3):
    mod = pkg["mx"].mod.Module(sym, context=_two(pkg))
    mod.fit(pkg["Iter"](X, y, batch_size=50), num_epoch=num_epoch,
            optimizer="sgd", kvstore=kvstore,
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            arg_params=nds(pkg, args))
    return mod


@pytest.mark.parametrize("kvstore", KVSTORES)
def test_module_over_two_contexts_matches_jax(kvstore,
                                              keep_port_random_state):
    """``Module(context=[cpu(0), cpu(1)])`` with each local kvstore kind:
    parameters rtol 1e-4 / atol 1e-6 and the score equal to the JAX
    package's; the two executors' parameter copies stay equal."""
    X, y = make_blobs(n=200)
    jsym_, tsym_ = both(lambda p: mlp_symbol(p["sym"]))
    args = init_params(tsym_, (50, 10))
    jm = _module_two(J, jsym_, args, X, y, kvstore)
    tm = _module_two(T, tsym_, args, X, y, kvstore)
    assert tm._update_on_kvstore == jm._update_on_kvstore
    assert tm._kvstore.type == jm._kvstore.type
    close_params(tm.get_params()[0], jm.get_params()[0])
    assert (tm.score(TIter(X, y, batch_size=50), "acc")
            == jm.score(JIter(X, y, batch_size=50), "acc"))
    for block in tm._exec_group.param_arrays:
        np.testing.assert_array_equal(block[0].asnumpy(), block[1].asnumpy())


def test_bucketing_module_over_two_contexts_matches_jax(
        keep_port_random_state):
    """``BucketingModule`` over two contexts with a ``device`` kvstore
    (the update on the kvstore), buckets of 3, 2 and 4 steps sharing one
    step layer (a kvstore key is one shape in every bucket): the outputs
    match the JAX package's (atol 1e-5), the shared layer stays one array
    a context in every bucket, equal to the JAX package's (rtol 1e-4 /
    atol 1e-6)."""
    def sym_gen(S):
        def gen(seq_len):
            w, b = S.Variable("step_weight"), S.Variable("step_bias")
            steps = S.SliceChannel(data=S.Variable("data"),
                                   num_outputs=seq_len, axis=1,
                                   squeeze_axis=True)
            hs = [S.Activation(data=S.FullyConnected(
                data=steps[t], weight=w, bias=b, num_hidden=8,
                name=f"step{t}"), act_type="tanh") for t in range(seq_len)]
            net = S.FullyConnected(data=S.ElementWiseSum(*hs), num_hidden=2,
                                   name="out")
            net = S.SoftmaxOutput(data=net, name="softmax")
            return net, ("data",), ("softmax_label",)
        return gen

    rng = np.random.RandomState(3)
    seq = [(n, rng.rand(4, n, 3).astype(np.float32),
            rng.randint(0, 2, 4).astype(np.float32)) for n in (3, 2, 4, 3,
                                                             2)]
    mods = []
    for pkg in (J, T):
        with mx.name.NameManager(), mxt.name.NameManager():
            gen = sym_gen(pkg["sym"])
        mod = pkg["mx"].mod.BucketingModule(gen, default_bucket_key=3,
                                            context=_two(pkg))
        mod.bind(data_shapes=[("data", (4, 3, 3))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(pkg["mx"].initializer.Uniform(0.1),
                        arg_params={"step_weight": pkg["nd"].array(
                            np.linspace(-0.3, 0.3, 24, dtype=np.float32)
                            .reshape(8, 3)),
                            "step_bias": pkg["nd"].zeros((8,)),
                            "out_weight": pkg["nd"].array(
                                np.linspace(-0.1, 0.1, 16, dtype=np.float32)
                                .reshape(2, 8)),
                            "out_bias": pkg["nd"].zeros((2,))})
        mod.init_optimizer(kvstore="device", optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        outs = []
        for n, x, lab in seq:
            batch = pkg["Batch"](data=[pkg["nd"].array(x)],
                                 label=[pkg["nd"].array(lab)], bucket_key=n,
                                 provide_data=[("data", (4, n, 3))],
                                 provide_label=[("softmax_label", (4,))])
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            # per context (the JAX package cannot concatenate arrays of
            # two devices in one call)
            outs.append(np.concatenate([
                o.asnumpy() for o in
                mod.get_outputs(merge_multi_context=False)[0]]))
        mods.append((mod, outs))
    (jm, jouts), (tm, touts) = mods
    assert set(tm._buckets) == set(jm._buckets) == {2, 3, 4}
    for a, b in zip(touts, jouts):
        assert a.shape == (4, 2)
        np.testing.assert_allclose(a, b, rtol=0, atol=OUT_ATOL)
    for k in range(2):
        arrays = {id(m._exec_group.execs[k].arg_dict["step_weight"])
                  for m in tm._buckets.values()}
        assert len(arrays) == 1
        np.testing.assert_allclose(
            tm._buckets[2]._exec_group.execs[k].arg_dict["step_weight"]
            .asnumpy(),
            jm._buckets[2]._exec_group.execs[k].arg_dict["step_weight"]
            .asnumpy(), **PARAM_TOL)


def test_kvstore_optimizer_state_files_cross_load(
        tmp_path, keep_port_random_state):
    """A kvstore's ``save_optimizer_states`` file (the optimizer pickled
    under the JAX package's class path, and the updater's states) loads
    in the other package, both ways: the same optimizer settings and
    bitwise the same momentum states."""
    shapes = {0: (4, 3), 1: (5,)}
    rs = np.random.RandomState(1)
    grads = {k: [rs.randn(*s).astype(np.float32) for _ in range(2)]
             for k, s in shapes.items()}
    stores = {}
    for tag, pkg in (("j", J), ("t", T)):
        kv = pkg["mx"].kvstore.create("device")
        kv.set_optimizer(pkg["mx"].optimizer.SGD(learning_rate=0.1,
                                                 momentum=0.9, wd=1e-3))
        for k, s in shapes.items():
            kv.init(k, pkg["nd"].zeros(s))
        for _ in range(2):
            for k in shapes:
                kv.push(k, [pkg["nd"].array(g, ctx=c) for g, c
                            in zip(grads[k], _two(pkg))])
            kv.barrier()
        kv.save_optimizer_states(str(tmp_path / f"{tag}.states"))
        stores[tag] = kv
    for src, pkg in (("j", T), ("t", J)):
        kv = pkg["mx"].kvstore.create("device")
        for k, s in shapes.items():
            kv.init(k, pkg["nd"].zeros(s))
        kv.load_optimizer_states(str(tmp_path / f"{src}.states"))
        opt = kv._updater.states
        ref = stores[src]._updater.states
        assert sorted(opt) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(opt[k].asnumpy(),
                                          ref[k].asnumpy())
        loaded = pickle_optimizer(kv)
        assert (loaded["lr"], loaded["momentum"], loaded["wd"]) == \
            (0.1, 0.9, 1e-3)
    # the two packages wrote the same states
    for k in shapes:
        np.testing.assert_allclose(stores["t"]._updater.states[k].asnumpy(),
                                   stores["j"]._updater.states[k].asnumpy(),
                                   rtol=1e-6, atol=1e-7)


def pickle_optimizer(kv):
    """The loaded optimizer's settings (the updater holds the optimizer
    object; its class is the loading package's)."""
    import pickle
    blob = kv._optimizer_blob
    if type(kv).__module__.startswith("mxnet_tpu_torch"):
        from mxnet_tpu_torch.kvstore import loads_optimizer
        opt = loads_optimizer(blob)
        assert type(opt).__module__ == "mxnet_tpu_torch.optimizer"
    else:
        opt = pickle.loads(blob)
        assert type(opt).__module__ == "mxnet_tpu.optimizer"
    return vars(opt)


# ---------------------------------------------------------------------------
# Module and relatives (tests/test_module.py)
# ---------------------------------------------------------------------------

def _module(pkg, sym, **kw):
    return pkg["mx"].mod.Module(sym, context=pkg["ctx"], **kw)


def test_module_fit_matches_jax():
    X, y = make_blobs()
    jsym_, tsym_ = both(lambda p: mlp_symbol(p["sym"]))
    args = init_params(tsym_, (50, 10))
    res = []
    for pkg, sym in ((J, jsym_), (T, tsym_)):
        log = Lines(f"legacy-mod-{id(pkg)}")
        mod = _module(pkg, sym, logger=log.logger)
        mod.fit(pkg["Iter"](X, y, batch_size=50),
                eval_data=pkg["Iter"](X, y, batch_size=50), num_epoch=10,
                optimizer="sgd", optimizer_params={"learning_rate": 0.5},
                arg_params=nds(pkg, args))
        score = mod.score(pkg["Iter"](X, y, batch_size=50), "acc")
        res.append((mod.get_params()[0], log.lines, score))
    (jp, jlines, jscore), (tp, tlines, tscore) = res
    close_params(tp, jp)
    assert tlines == jlines and any("Train-accuracy" in s for s in tlines)
    assert tscore == jscore and tscore[0][1] > 0.9


def _manual(pkg, sym, args, X, y, inputs_need_grad=False):
    mod = _module(pkg, sym)
    mod.bind(data_shapes=[("data", (20, 10))],
             label_shapes=[("softmax_label", (20,))],
             inputs_need_grad=inputs_need_grad)
    mod.init_params(arg_params=nds(pkg, args))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    batch = pkg["Batch"](data=[pkg["nd"].array(X[:20])],
                         label=[pkg["nd"].array(y[:20])])
    mod.forward_backward(batch)
    grads = mod.get_input_grads()[0].asnumpy() if inputs_need_grad else None
    mod.update()
    return mod, grads


def test_module_forward_backward_update_and_input_grads_match_jax():
    X, y = make_blobs(n=100)
    jsym_, tsym_ = both(lambda p: mlp_symbol(p["sym"]))
    args = init_params(tsym_, (20, 10))
    (jm, jg), (tm, tg) = (_manual(p, s, args, X, y, inputs_need_grad=True)
                          for p, s in ((J, jsym_), (T, tsym_)))
    assert tm.get_outputs()[0].shape == (20, 4)
    np.testing.assert_allclose(tm.get_outputs()[0].asnumpy(),
                               jm.get_outputs()[0].asnumpy(), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-4 * np.abs(jg).max())
    assert np.abs(tg).sum() > 0
    close_params(tm.get_params()[0], jm.get_params()[0])
    assert tm.output_shapes == jm.output_shapes


def test_module_checkpoint_and_optimizer_states_cross_load(tmp_path):
    X, y = make_blobs(n=100)
    jsym_, tsym_ = both(lambda p: mlp_symbol(p["sym"]))
    args = init_params(tsym_, (20, 10))
    mods = {}
    for tag, pkg, sym in (("j", J, jsym_), ("t", T, tsym_)):
        mod, _ = _manual(pkg, sym, args, X, y)
        mod.save_checkpoint(str(tmp_path / tag), 2,
                            save_optimizer_states=True)
        mods[tag] = mod
    # the port loads the JAX package's files, momentum states included
    tm2 = mxt.mod.Module.load(str(tmp_path / "j"), 2,
                              load_optimizer_states=True, context=mxt.cpu())
    tm2.bind(data_shapes=[("data", (20, 10))],
             label_shapes=[("softmax_label", (20,))])
    tm2.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    jstates = mods["j"]._updater.states
    assert sorted(tm2._updater.states) == sorted(jstates)
    for k, v in jstates.items():
        np.testing.assert_array_equal(tm2._updater.states[k].asnumpy(),
                                      v.asnumpy())
    batch = TBatch(data=[tnd.array(X[:20])], label=[tnd.array(y[:20])])
    tm2.forward(batch, is_train=False)
    jb = JBatch(data=[jnd.array(X[:20])], label=[jnd.array(y[:20])])
    mods["j"].forward(jb, is_train=False)
    np.testing.assert_allclose(tm2.get_outputs()[0].asnumpy(),
                               mods["j"].get_outputs()[0].asnumpy(), rtol=0,
                               atol=1e-6)
    # and the JAX package loads the port's states
    jm2 = mx.mod.Module.load(str(tmp_path / "t"), 2,
                             load_optimizer_states=True, context=mx.cpu())
    jm2.bind(data_shapes=[("data", (20, 10))],
             label_shapes=[("softmax_label", (20,))])
    jm2.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    for k, v in mods["t"]._updater.states.items():
        np.testing.assert_array_equal(jm2._updater.states[k].asnumpy(),
                                      v.asnumpy())
    # the CheckpointManager round trip with optimizer states, across
    # packages both ways
    from mxnet_tpu.checkpoint import CheckpointManager as JMgr
    from mxnet_tpu_torch.checkpoint import CheckpointManager as TMgr
    for tag, Mgr, Other in (("t", TMgr, JMgr), ("j", JMgr, TMgr)):
        mgr = Mgr(str(tmp_path / f"mgr-{tag}"))
        mods[tag].save_to_manager(mgr, 2, save_optimizer_states=True,
                                  blocking=True)
        mgr.close()
        other = Other(str(tmp_path / f"mgr-{tag}"))
        pkg, ctx = (mx, mx.cpu()) if Other is JMgr else (mxt, mxt.cpu())
        m2 = pkg.mod.Module.load_from_manager(
            other, load_optimizer_states=True, context=ctx)
        other.close()
        m2.bind(data_shapes=[("data", (20, 10))],
                label_shapes=[("softmax_label", (20,))])
        m2.init_optimizer(optimizer="sgd",
                          optimizer_params={"learning_rate": 0.1,
                                            "momentum": 0.9})
        src = mods[tag]._updater.states
        assert sorted(m2._updater.states) == sorted(src)
        for k, v in src.items():
            np.testing.assert_array_equal(m2._updater.states[k].asnumpy(),
                                          v.asnumpy())
        for n, v in mods[tag].get_params()[0].items():
            np.testing.assert_array_equal(m2.get_params()[0][n].asnumpy(),
                                          v.asnumpy())


def test_bucketing_module_shares_parameters_and_matches_jax():
    def sym_gen(S):
        def gen(seq_len):
            net = S.FullyConnected(data=S.Variable("data"), num_hidden=8,
                                   name="fc_shared")
            net = S.FullyConnected(data=net, num_hidden=2, name="out")
            net = S.SoftmaxOutput(data=net, name="softmax")
            return net, ("data",), ("softmax_label",)
        return gen

    rng = np.random.RandomState(3)
    seq = [(n, rng.rand(4, n).astype(np.float32),
            rng.randint(0, 2, 4).astype(np.float32)) for n in (10, 5, 7, 10,
                                                             5)]
    mods = []
    for pkg in (J, T):
        mod = pkg["mx"].mod.BucketingModule(sym_gen(pkg["sym"]),
                                            default_bucket_key=10,
                                            context=pkg["ctx"])
        mod.bind(data_shapes=[("data", (4, 10))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(pkg["mx"].initializer.Uniform(0.1),
                        arg_params={"fc_shared_weight": pkg["nd"].array(
                            np.full((8, 10), 0.05, np.float32)),
                            "fc_shared_bias": pkg["nd"].zeros((8,)),
                            "out_weight": pkg["nd"].array(
                                np.linspace(-0.1, 0.1, 16, dtype=np.float32)
                                .reshape(2, 8)),
                            "out_bias": pkg["nd"].zeros((2,))})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        # every bucket's programs ahead of the batches: three each
        # (inference and training forward, forward-backward)
        infos = mod.compile([10, 5, 7])
        assert sorted({i["bucket"] for i in infos}) == [5, 7, 10]
        outs = []
        for n, x, lab in seq:
            batch = pkg["Batch"](data=[pkg["nd"].array(x)],
                                 label=[pkg["nd"].array(lab)], bucket_key=n,
                                 provide_data=[("data", (4, n))],
                                 provide_label=[("softmax_label", (4,))])
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        mods.append((mod, outs))
    (jm, jouts), (tm, touts) = mods
    assert set(tm._buckets) == set(jm._buckets) == {10, 5, 7}
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a, b, rtol=0, atol=OUT_ATOL)
    # the bucket-independent layer is one array in every bucket
    arrays = {id(m._exec_group.execs[0].arg_dict["out_weight"])
              for m in tm._buckets.values()}
    assert len(arrays) == 1
    np.testing.assert_allclose(
        tm._buckets[5]._exec_group.execs[0].arg_dict["out_weight"].asnumpy(),
        jm._buckets[5]._exec_group.execs[0].arg_dict["out_weight"].asnumpy(),
        **PARAM_TOL)
    assert tm.cache_report() == jm.cache_report()


def _seq_modules(pkg):
    S = pkg["sym"]
    net1 = S.FullyConnected(data=S.Variable("data"), num_hidden=16,
                            name="fc1")
    net1 = S.Activation(data=net1, act_type="relu", name="relu1")
    net2 = S.FullyConnected(data=S.Variable("fc1_data"), num_hidden=4,
                            name="fc2")
    net2 = S.SoftmaxOutput(data=net2, name="softmax")
    return net1, net2


def test_sequential_module_matches_jax():
    X, y = make_blobs(n=100)
    (j1, j2), (t1, t2) = both(_seq_modules)
    args = dict(init_params(t1, (25, 10)),
                **init_params(t2, (25, 16), seed=1, data="fc1_data"))
    res = []
    for pkg, n1, n2 in ((J, j1, j2), (T, t1, t2)):
        seq = pkg["mx"].mod.SequentialModule()
        seq.add(_module(pkg, n1, label_names=[]), auto_wiring=True)
        seq.add(_module(pkg, n2, data_names=["fc1_data"]), take_labels=True,
                auto_wiring=True)
        seq.fit(pkg["Iter"](X, y, batch_size=25), num_epoch=8,
                arg_params=nds(pkg, args), optimizer="sgd",
                optimizer_params={"learning_rate": 0.5})
        res.append((seq.get_params()[0],
                    seq.score(pkg["Iter"](X, y, batch_size=25), "acc")))
    (jp, js), (tp, ts) = res
    close_params(tp, jp)
    assert ts == js and ts[0][1] > 0.8


def test_python_loss_module_matches_jax():
    def grad_func(scores, labels):
        s = scores.asnumpy()
        lab = labels.asnumpy().astype(int)
        p = np.exp(s - s.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        p[np.arange(len(lab)), lab] -= 1.0
        return p.astype(np.float32)

    X, y = make_blobs(n=80, num_classes=2, dim=6)
    jnet, tnet = both(lambda p: p["sym"].FullyConnected(
        data=p["sym"].Variable("data"), num_hidden=2, name="fc"))
    args = init_params(tnet, (20, 6))
    res = []
    for pkg, net in ((J, jnet), (T, tnet)):
        seq = pkg["mx"].mod.SequentialModule()
        seq.add(_module(pkg, net, label_names=[]), auto_wiring=True)
        seq.add(pkg["mx"].mod.PythonLossModule(grad_func=grad_func,
                                               data_names=("fc_data",)),
                take_labels=True, auto_wiring=True)
        seq.fit(pkg["Iter"](X, y, batch_size=20), num_epoch=10,
                arg_params=nds(pkg, args), optimizer="sgd",
                optimizer_params={"learning_rate": 0.3})
        res.append((seq.get_params()[0], seq.get_outputs()[0].asnumpy()))
    (jp, jo), (tp, to) = res
    close_params(tp, jp)
    assert to.shape == (20, 2)
    np.testing.assert_allclose(to, jo, rtol=0, atol=OUT_ATOL)


def test_legacy_guard_skips_and_clips_as_jax():
    X, y = make_blobs(n=100)
    X[40:60] = np.nan                       # batch 2 of 5 is poisoned
    jsym_, tsym_ = both(lambda p: mlp_symbol(p["sym"]))
    args = init_params(tsym_, (20, 10))
    res = []
    for pkg, sym in ((J, jsym_), (T, tsym_)):
        mod = _module(pkg, sym)
        mod.fit(pkg["Iter"](X, y, batch_size=20), num_epoch=1,
                arg_params=nds(pkg, args), optimizer="sgd",
                optimizer_params={"learning_rate": 0.5,
                                  "clip_global_norm": 0.5,
                                  "skip_nonfinite": True})
        res.append((mod.get_params()[0], mod._grad_guard))
    (jp, jg), (tp, tg) = res
    assert isinstance(tg, mxt.resilience.LegacyGuard)
    assert (tg.skipped_steps, tg.clipped_steps) == (
        jg.skipped_steps, jg.clipped_steps)
    assert tg.skipped_steps == 1 and tg.clipped_steps > 0
    close_params(tp, jp)
    assert mxt.resilience.legacy_guard_for(mxt.optimizer.SGD()) is None


# ---------------------------------------------------------------------------
# Monitor (tests/test_monitor_viz.py)
# ---------------------------------------------------------------------------

def _mon_mlp(pkg):
    S = pkg["sym"]
    net = S.FullyConnected(data=S.Variable("data"), num_hidden=8,
                           name="fc1")
    net = S.Activation(data=net, act_type="relu", name="relu1")
    net = S.FullyConnected(data=net, num_hidden=3, name="fc2")
    return S.SoftmaxOutput(data=net, name="softmax")


def test_monitor_collects_the_stats_jax_collects():
    rows = []
    for pkg, net in zip((J, T), both(_mon_mlp)):
        ex = net.simple_bind(ctx=pkg["ctx"], data=(4, 6),
                             softmax_label=(4,))
        mon = pkg["mx"].Monitor(interval=1, pattern=".*fc.*")
        mon.install(ex)
        rng = np.random.RandomState(0)
        for n in sorted(ex.arg_dict):
            ex.arg_dict[n][:] = rng.rand(*ex.arg_dict[n].shape) \
                .astype(np.float32)
        mon.tic()
        ex.forward(is_train=True)
        rows.append(mon.toc())
    jrows, trows = rows
    assert [(s, k) for s, k, _ in trows] == [(s, k) for s, k, _ in jrows]
    assert "fc1_weight" in [k for _, k, _ in trows]
    for (_, k, tv), (_, _, jv) in zip(trows, jrows):
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5,
                                   err_msg=k)


def test_monitor_interval_through_feedforward_fit_matches_jax():
    rng = np.random.RandomState(0)
    X = rng.rand(60, 6).astype(np.float32)
    y = rng.randint(0, 3, 60).astype(np.float32)
    jnet, tnet = both(_mon_mlp)
    args = init_params(tnet, (20, 6))
    res = []
    for pkg, net in ((J, jnet), (T, tnet)):
        mon = pkg["mx"].Monitor(interval=2)
        rows = []
        toc = mon.toc
        mon.toc = lambda: rows.extend(toc()) or []
        model = pkg["mx"].FeedForward(net, ctx=pkg["ctx"], num_epoch=2,
                                      optimizer="sgd", learning_rate=0.1,
                                      arg_params=nds(pkg, args))
        model.fit(X=pkg["Iter"](X, y, batch_size=20), kvstore=None,
                  monitor=mon)
        res.append((mon.step, rows))
    (js, jrows), (ts, trows) = res
    assert ts == js == 6
    assert [(s, k) for s, k, _ in trows] == [(s, k) for s, k, _ in jrows]
    for (_, k, tv), (_, _, jv) in zip(trows, jrows):
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-4,
                                   err_msg=k)
