"""``ShardedTrainer.fit``/``score`` of the PyTorch port against the JAX
trainer's, on the CPU.

Both trainers get the same symbol (built under a fresh NameManager in each
package, so names match), the same numpy parameters, SGD with momentum
0.9 and wd 1e-4 under a ``FactorScheduler`` (the rate halves inside the
run), the guard and global-norm clip 0.5, and the same numpy batches
through each package's ``NDArrayIter`` (the tail batch padded); the JAX
side a one-device mesh.  After ``fit`` the parameters agree within
rtol 1e-4, atol 1e-6 (as ``tests/test_torch_trainer.py``: f32 summation
order differs between XLA and ATen), and the per-epoch log lines
(train and validation metric, step count, the resilience line), the
``telemetry.record_step`` keys, skip counts, chaos injections, the
sentinel's backoffs and lr scale are equal.  ``fit``'s fused accuracy
equals a host ``Accuracy`` over the same heads exactly.
"""
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import chaos as jchaos
from mxnet_tpu import io as jio
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import model as jmodel
from mxnet_tpu import models as jmodels
from mxnet_tpu import random as jrandom
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import callback as tcallback
from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import ShardedTrainer

BATCH = 16
N_TRAIN = 56          # 4 batches an epoch, the last padded with 8
N_EVAL = 32
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CLIP = 0.5
NETS = {"mlp": ((784,), lambda m: m.mlp()),
        "lenet": ((1, 28, 28), lambda m: m.lenet())}


@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    """Every JAX trainer draws its base key from the JAX package's global
    PRNG: restore it, so the test files that run after this one in the
    same process draw what they would draw without it."""
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


@pytest.fixture(autouse=True)
def _fresh_telemetry(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_CHAOS", raising=False)
    for t in (jtel, ttel):
        t.reset_for_tests()
        # reset_for_tests keeps the ring's capacity, which another test
        # file in this process may have shrunk: pin it
        t.flight_recorder().set_capacity(256)
    yield
    for t in (jtel, ttel):
        t.reset_for_tests()


def _build(net):
    with mx.name.NameManager(), mxt.name.NameManager():
        return NETS[net][1](jmodels), NETS[net][1](tmodels)


def _data(net, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *NETS[net][0]).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    return x, y


def _params(sym, net, seed=0):
    shapes, _, _ = sym.infer_shape(data=(BATCH,) + NETS[net][0],
                                   softmax_label=(BATCH,))
    # about the spread of the default Uniform(0.07) (std 0.04): at std 0.1
    # lenet's tanh units sit where eight steps of lr 0.1 amplify a
    # summation-order difference to the tolerance (1 run in ~15 under load)
    rng = np.random.RandomState(seed)
    return {n: (0.05 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _pair(net, fused=None, sched=lambda m: m.FactorScheduler(step=3,
                                                              factor=0.5),
          guard_params=None, opt=OPT, clip=CLIP):
    jsym, tsym = _build(net)
    args = _params(tsym, net)
    jlog, tlog = (logging.getLogger(f"fit-parity-{p}") for p in "jt")
    jt = JaxTrainer(jsym, optimizer="sgd",
                    optimizer_params=dict(opt, lr_scheduler=sched(jlrs)),
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]),
                    guard=True, clip_global_norm=clip,
                    guard_params=guard_params, logger=jlog)
    jt.bind(data_shapes={"data": (BATCH,) + NETS[net][0]},
            label_shapes={"softmax_label": (BATCH,)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()})
    tt = ShardedTrainer(tsym, optimizer="sgd",
                        optimizer_params=dict(opt, lr_scheduler=sched(tlrs)),
                        guard=True, clip_global_norm=clip,
                        guard_params=guard_params, fused_update=fused,
                        logger=tlog, device="cpu")
    tt.bind(data_shapes={"data": (BATCH,) + NETS[net][0]},
            label_shapes={"softmax_label": (BATCH,)}, arg_params=args)
    return jt, tt


def _iters(net, seed=1, n=N_TRAIN):
    x, y = _data(net, n, seed)
    return (jio.NDArrayIter(x, y, batch_size=BATCH),
            tio.NDArrayIter(x, y, batch_size=BATCH))


class _Lines(logging.Handler):
    def __init__(self, logger):
        super().__init__(logging.INFO)
        self.lines = []
        self.logger = logger

    def emit(self, record):
        msg = record.getMessage()
        if "Elapsed=" in msg:  # wall time differs between packages
            msg = msg.split(" Elapsed=")[0]
        self.lines.append(msg)

    def __enter__(self):
        self.logger.addHandler(self)
        self.old = self.logger.level
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.old)


def _fit_both(jt, tt, jtrain, ttrain, jeval=None, teval=None, **kw):
    with _Lines(jt.logger) as jl, _Lines(tt.logger) as tl:
        jt.fit(jtrain, eval_data=jeval, **kw)
        tt.fit(ttrain, eval_data=teval, **kw)
    return jl.lines, tl.lines


def _assert_params_match(jt, tt):
    jargs, _ = jt.get_params()
    targs, _ = tt.get_params()
    assert sorted(jargs) == sorted(targs)
    for n in jargs:
        np.testing.assert_allclose(targs[n].asnumpy(), jargs[n].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_fit_matches_jax(net, fused):
    jt, tt = _pair(net, fused)
    assert tt._fused == fused
    # fit's accuracy step as a program in both packages: every batch is a
    # program hit (aot_hits), and the state stays the JAX trainer's
    for t in (jt, tt):
        t.compile(programs=("train_acc",))
    jtrain, ttrain = _iters(net)
    jeval, teval = _iters(net, seed=2, n=N_EVAL)
    jl, tl = _fit_both(jt, tt, jtrain, ttrain, jeval, teval, num_epoch=2,
                       eval_metric="acc")
    _assert_params_match(jt, tt)
    assert tt._num_update == jt._num_update == 8
    assert tl == jl
    assert sum("Mesh-Train-accuracy" in l for l in tl) == 2
    assert sum("Mesh-Validation-accuracy" in l for l in tl) == 2
    assert any("Resilience: skipped=0" in l for l in tl)
    jrec = jtel.flight_recorder().records()
    trec = ttel.flight_recorder().records()
    assert len(trec) == len(jrec) == 8
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    for a, b in zip(trec, jrec):
        for k in ("step", "epoch", "nbatch", "lr_scale", "rollbacks",
                  "aot_hits", "skipped_steps", "loss_scale"):
            assert a[k] == b[k], k
    # one replayed program a batch: 2 epochs of 4 batches
    assert [r["aot_hits"] for r in trec] == list(range(1, 9))
    assert tt.aot_stats == {"hits": 8, "fallbacks": 0}
    # the schedule: FactorScheduler(3, 0.5) at update 8 has halved twice
    assert tt.optimizer.lr_scheduler.base_lr == 0.1 * 0.25
    assert float(tt._lr_dev) == np.float32(0.025)


def test_fit_fused_accuracy_equals_host_metric():
    """The accuracy folded on the device inside each step equals a host
    ``Accuracy`` over the same heads, and the JAX trainer's."""
    jt, tt = _pair("mlp")
    captured, heads = {}, []

    def grab(param):
        heads.append((param.locals["outs"][0].clone(),
                      param.locals["cur"]["softmax_label"].clone()))
        if param.nbatch == 4:
            captured["t"] = dict(param.eval_metric.get_name_value())

    def jgrab(param):
        if param.nbatch == 4:
            captured["j"] = dict(param.eval_metric.get_name_value())

    jtrain, ttrain = _iters("mlp")
    tt.fit(ttrain, eval_metric="acc", num_epoch=1, batch_end_callback=grab)
    jt.fit(jtrain, eval_metric="acc", num_epoch=1, batch_end_callback=jgrab)
    host = tmetric.create("acc")
    for out, label in heads:
        host.update([label], [out])
    assert captured["t"] == dict(host.get_name_value())
    assert captured["t"] == captured["j"]


def test_fit_unfused_metric_path_matches_jax():
    """A metric other than Accuracy goes through the buffered path."""
    jt, tt = _pair("mlp")
    jtrain, ttrain = _iters("mlp")
    jl, tl = _fit_both(jt, tt, jtrain, ttrain, num_epoch=1,
                       eval_metric="ce")
    [tline] = [l for l in tl if "Mesh-Train" in l]
    [jline] = [l for l in jl if "Mesh-Train" in l]
    assert tline.split("=")[0] == jline.split("=")[0]
    np.testing.assert_allclose(float(tline.split("=")[1]),
                               float(jline.split("=")[1]), rtol=1e-5)


def test_fit_under_chaos_matches_jax(monkeypatch):
    """``MXNET_TPU_CHAOS`` wraps fit's iterator upstream of the prefetch
    thread: a NaN batch is skipped by the guard and a crash is retried
    without losing a batch, in both packages alike."""
    monkeypatch.setenv("MXNET_TPU_CHAOS", "nan:1|crash:5")
    jt, tt = _pair("mlp")
    jtrain, ttrain = _iters("mlp")
    jl, tl = _fit_both(jt, tt, jtrain, ttrain, num_epoch=2)
    jst, tst = jt.resilience_stats(), tt.resilience_stats()
    assert tst["skipped_steps"] == jst["skipped_steps"] == 1
    assert tt._num_update == jt._num_update == 8   # no batch lost
    _assert_params_match(jt, tt)
    assert tl == jl
    assert any("skipped=1" in l for l in tl)
    # explicit ChaosIters: the same injections in both packages
    jci = jchaos.ChaosIter(_iters("mlp")[0], jchaos.ChaosSpec.parse(
        "nan:1|crash:5"))
    tci = tchaos.ChaosIter(_iters("mlp")[1], tchaos.ChaosSpec.parse(
        "nan:1|crash:5"))
    jt2, tt2 = _pair("mlp")
    monkeypatch.delenv("MXNET_TPU_CHAOS")
    _fit_both(jt2, tt2, jci, tci, num_epoch=2)
    assert tci.injected == jci.injected == {"nan": 1, "overflow": 0,
                                            "crash": 1}
    _assert_params_match(jt2, tt2)


def test_sentinel_backs_off_on_all_skipped_windows():
    """Windows of only skipped steps back the learning rate off: the
    second anomaly in a row asks for a rollback, which without a
    checkpoint manager degrades to another backoff."""
    spec = "nan:2,3,4,5"
    jt, tt = _pair("mlp", guard_params={"check_every": 2})
    jtrain, ttrain = _iters("mlp", n=128)     # 8 batches an epoch
    jci = jchaos.ChaosIter(jtrain, jchaos.ChaosSpec.parse(spec))
    tci = tchaos.ChaosIter(ttrain, tchaos.ChaosSpec.parse(spec))
    jl, tl = _fit_both(jt, tt, jci, tci, num_epoch=1)
    assert tt._lr_scale == jt._lr_scale == 0.25
    assert tl == jl
    assert ("Resilience sentinel: all 2 steps in window skipped -> LR "
            "backoff") in tl
    assert ("Resilience sentinel: all 2 steps in window skipped -> "
            "rollback") in tl
    assert "Resilience: LR backed off, lr-scale=0.25" in tl
    assert tt.resilience_stats() == jt.resilience_stats() | {
        "norm_sum": tt.resilience_stats()["norm_sum"]}
    np.testing.assert_allclose(tt.resilience_stats()["norm_sum"],
                               jt.resilience_stats()["norm_sum"], rtol=1e-5)
    _assert_params_match(jt, tt)


def test_sentinel_poll_and_resilience_stats_match_jax():
    jt, tt = _pair("mlp")
    x, y = _data("mlp", BATCH, 3)
    for tr in (jt, tt):
        assert tr._sentinel_poll() is None            # the baseline
        for scale in (1.0, 1.0, 1e4):
            tr.step({"data": x * scale, "softmax_label": y})
        assert tr._sentinel_poll() is None
    st, sj = tt.resilience_stats(), jt.resilience_stats()
    assert sorted(st) == sorted(sj)
    for k in st:
        if k == "norm_sum":
            np.testing.assert_allclose(st[k], sj[k], rtol=1e-5)
        else:
            assert st[k] == sj[k], k


def test_fit_resumes_the_schedule_clock_at_begin_epoch():
    jt, tt = _pair("mlp")
    jtrain, ttrain = _iters("mlp")
    jl, tl = _fit_both(jt, tt, jtrain, ttrain, num_epoch=3, begin_epoch=1)
    assert tt._num_update == jt._num_update == 12
    assert tl == jl
    assert tl[0].startswith("Epoch[1]")
    _assert_params_match(jt, tt)


def test_do_checkpoint_files_load_in_the_other_package(tmp_path):
    jt, tt = _pair("mlp")
    jtrain, ttrain = _iters("mlp")
    jt.fit(jtrain, num_epoch=1,
           epoch_end_callback=mx.callback.do_checkpoint(
               str(tmp_path / "j")))
    tt.fit(ttrain, num_epoch=1,
           epoch_end_callback=tcallback.do_checkpoint(str(tmp_path / "t")))
    for p in ("j", "t"):
        assert (tmp_path / f"{p}-symbol.json").exists()
        assert (tmp_path / f"{p}-0001.params").exists()
    # the port's files in the JAX package, and the other way round
    jsym, jarg, jaux = jmodel.load_checkpoint(str(tmp_path / "t"), 1)
    with mxt.cpu():
        tsym, targ, taux = tmodel.load_checkpoint(str(tmp_path / "j"), 1)
    assert jsym.tojson() == tt.symbol.tojson()
    assert tsym.tojson() == jt.symbol.tojson()
    tnow, jnow = tt.get_params()[0], jt.get_params()[0]
    for n in tnow:
        assert jarg[n].asnumpy().tobytes() == tnow[n].asnumpy().tobytes()
        assert targ[n].asnumpy().tobytes() == jnow[n].asnumpy().tobytes()
    assert jaux == {} and taux == {}
    # with a manager the callback saves through it instead of the files
    saved = []

    class _Manager:
        def save_model(self, *args):
            saved.append(args)

    cb = tcallback.do_checkpoint(str(tmp_path / "unused"), manager=_Manager())
    cb(4, tt.symbol, tnow, {})
    assert [a[0] for a in saved] == [5] and saved[0][1] is tt.symbol
    assert not (tmp_path / "unused-0005.params").exists()


def test_score_matches_jax():
    jt, tt = _pair("lenet")
    jeval, teval = _iters("lenet", seed=4, n=N_EVAL)
    for metric in ("acc", "ce"):
        jm = jt.score(jeval, metric)
        tm = tt.score(teval, metric)
        assert tm.num_inst == jm.num_inst
        np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-5)


def test_fit_checkpoint_manager_is_not_ported(tmp_path):
    """The name dates from when ``fit`` refused a manager; the test now
    checks the opposite: ``fit(checkpoint_manager=...)`` saves on the
    manager's cadence (its save policy runs after each batch; the
    checkpoint tests hold it against the JAX package)."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    _, tt = _pair("mlp")
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=2,
                            keep_last=10)
    tt.fit(_iters("mlp")[1], num_epoch=1, checkpoint_manager=mgr)
    mgr.close()
    assert mgr.all_steps() == [s for s in range(1, tt._num_update + 1)
                               if s % 2 == 0]


def test_prefetch_thread_error_surfaces_in_fit():
    """A worker failure that outlasts the retries reaches fit's caller,
    and fit closes its prefetch thread."""
    _, tt = _pair("mlp")

    class Broken(tio.NDArrayIter):
        def next(self):
            raise OSError("disk fell over")

    x, y = _data("mlp", N_TRAIN, 1)
    with pytest.raises(OSError, match="disk fell over"):
        tt.fit(Broken(x, y, batch_size=BATCH), num_epoch=1)
