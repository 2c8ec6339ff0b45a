"""Checkpoints of the PyTorch port (``mxnet_tpu_torch/checkpoint/``, the
trainer's ``save_state``/``restore_state``) on the CPU: the JAX
package's one-device cases of ``tests/test_checkpoint.py``, and
checkpoints carried across the two packages.

Within the port (all BITWISE): a resumed trainer continues the saved
run's heads and parameters, fused and unfused, with Adam's two moments
and the guard's loss scale, streak and cumulative counters;
``restore_or_initialize``; a torn staging directory is ignored and swept;
the manifest is the commit marker; a flipped byte and a truncated shard
are caught with the file's name; retention and save policies; the async
writer overlaps and re-raises its errors; SIGTERM saves and a new
trainer resumes; ``fit(checkpoint_manager=)`` saves on its cadence and
stops on preemption; a forced sentinel rollback restores the
checkpoint; a save waits for nothing but its snapshot.

Across packages: a checkpoint either package writes loads in the other
(``load_arrays``, ``verify_checkpoint``, ``load_model``, ``restore_state``
fused into fused and unfused into unfused, BITWISE), and 3 steps after
such a restore equal the other package's own continuation within the
trainer tolerance (rtol 1e-4, atol 1e-6: summation order); a layout the
trainer does not share raises naming the missing arrays.

Resharding (the JAX package's reshard cases): a ZeRO checkpoint of 8
mesh members restores onto 4 (the flat-pad state's length follows the
member count; parameters BITWISE, the next step within rtol 1e-5, atol
1e-6), across packages both ways, onto a mesh's shardings through
``CheckpointManager.restore``; a real shape change raises.
"""
import os
import signal
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu.checkpoint import CheckpointManager as JMgr
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import (CheckpointManager, layout,
                                        load_arrays, load_legacy_params,
                                        read_manifest, snapshot,
                                        verify_checkpoint, write_checkpoint)
from mxnet_tpu_torch.checkpoint.reader import _adapt_shape
from mxnet_tpu_torch.parallel import ShardedTrainer


@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


def _mlp(S):
    net = S.FullyConnected(data=S.Variable("data"), num_hidden=32,
                           name="fc1")
    net = S.Activation(data=net, act_type="relu", name="relu1")
    net = S.FullyConnected(data=net, num_hidden=10, name="fc2")
    return S.SoftmaxOutput(data=net, name="softmax")


SHAPES = ({"data": (16, 8)}, {"softmax_label": (16,)})
SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
ADAM = ("adam", {"learning_rate": 1e-2})


def _args(seed=3):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": 0.3 * rng.randn(32, 8), "fc1_bias": np.zeros(32),
            "fc2_weight": 0.3 * rng.randn(10, 32), "fc2_bias": np.zeros(10)}


def _port(opt=SGD, fused=None, seed=7, args=True, **kw):
    with mxt.name.NameManager():
        sym = _mlp(tsym)
    tr = ShardedTrainer(sym, opt[0], dict(opt[1]), fused_update=fused,
                        device="cpu", seed=seed, **kw)
    given = ({k: np.asarray(v, np.float32) for k, v in _args().items()}
             if args else None)
    return tr.bind(*SHAPES, arg_params=given)


def _jax(opt=SGD, fused=None, **kw):
    with mx.name.NameManager():
        sym = _mlp(mx.symbol)
    tr = JaxTrainer(sym, optimizer=opt[0], optimizer_params=dict(opt[1]),
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]),
                    fused_update=fused, **kw)
    tr.bind(*SHAPES, arg_params={k: jnp.asarray(np.asarray(v, np.float32))
                                 for k, v in _args().items()})
    return tr


def _batches(n, seed=0, nan_at=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = rng.randn(16, 8).astype(np.float32)
        if i == nan_at:
            x[0, 0] = np.nan
        out.append({"data": x, "softmax_label":
                    rng.randint(0, 10, (16,)).astype(np.float32)})
    return out


def _state(tr):
    """Weights, optimizer state and guard counters of a port trainer."""
    out = {f"param:{n}": p.detach().clone() for n, p in tr._params.items()}
    for n, st in tr.opt_state_by_param().items():
        out.update({f"opt:{n}:{i}": t.clone() for i, t in enumerate(st)})
    return out, tr.resilience_stats() and {
        k: v for k, v in tr.resilience_stats().items() if k != "lr_scale"}


def _assert_same(a, b):
    """Tensors bitwise, counters exactly; the summed gradient norm to
    1e-6 relative (a resumed run adds its float32 window to the saved
    float64 total, the uninterrupted one sums one window)."""
    (ta, ra), (tb, rb) = a, b
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert ra.pop("norm_sum") == pytest.approx(rb.pop("norm_sum"), rel=1e-6)
    assert ra == rb


# ---------------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt,fused", [(SGD, None), (SGD, False),
                                       (ADAM, None), (ADAM, False)],
                         ids=["sgd-fused", "sgd-unfused", "adam-fused",
                              "adam-unfused"])
def test_bitwise_resume(tmp_path, opt, fused):
    batches = _batches(6)
    tr = _port(opt, fused, guard=True, loss_scale="dynamic",
               guard_params={"init_scale": 64.0, "growth_interval": 2})
    for b in batches[:3]:
        tr.step(b)
    mgr = CheckpointManager(str(tmp_path))
    tr.save_state(mgr)
    ref = [tr.step(b)[0] for b in batches[3:]]
    tr2 = _port(opt, fused, seed=999, args=False, guard=True,
                loss_scale="dynamic",
                guard_params={"init_scale": 64.0, "growth_interval": 2})
    meta, step = tr2.restore_state(mgr)
    assert step == 3 and tr2._num_update == 3 and meta["torch_seed"] == 7
    assert tr2._seed == 7
    if opt is ADAM:
        assert all(len(st) == 2 for st in tr2.opt_state_by_param().values())
    for i, b in enumerate(batches[3:]):
        assert torch.equal(tr2.step(b)[0], ref[i]), f"resumed step {i}"
    _assert_same(_state(tr), _state(tr2))
    # 6 good steps at a growth interval of 2: 64 -> 512
    assert tr2.resilience_stats()["loss_scale"] == 512.0
    mgr.close()


def test_restore_or_initialize_and_guard_counters(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tr = _port(guard=True, guard_params={"check_every": 1})
    assert tr.restore_or_initialize(mgr) is None
    for b in _batches(3, nan_at=1):
        tr.step(b)
    tr._sentinel_poll()                 # folds the window into the base
    tr.step(_batches(1, seed=5)[0])
    tr.save_state(mgr)
    mgr.wait_until_finished()
    assert mgr.latest_step() == 4
    tr2 = _port(seed=11, args=False, guard=True)
    assert tr2.restore_or_initialize(mgr) == 4
    want, got = tr.resilience_stats(), tr2.resilience_stats()
    assert (got["skipped_steps"], got["norm_steps"]) == (1, 3)
    for k in ("skipped_steps", "overflow_steps", "norm_steps", "loss_scale",
              "good_steps", "num_update"):
        assert got[k] == want[k], k
    assert got["norm_sum"] == pytest.approx(want["norm_sum"], rel=1e-6)
    # the card's windows restart at zero; the base holds the totals
    assert float(tr2._guard_state["norm_sum"]) == 0.0
    mgr.close()


def test_kill_mid_save_keeps_last_committed(tmp_path):
    root = str(tmp_path)
    tr = _port()
    tr.step(_batches(1)[0])
    mgr = CheckpointManager(root)
    tr.save_state(mgr)
    mgr.wait_until_finished()
    torn = os.path.join(root, f"{layout.STAGING_PREFIX}"
                              f"{layout.step_dir_name(2)}-99999")
    os.makedirs(torn)
    with open(os.path.join(torn, "00000.00.bin"), "wb") as f:
        f.write(b"\x00" * 64)
    assert layout.committed_steps(root) == [1]
    verify_checkpoint(mgr.step_path(1))
    mgr2 = CheckpointManager(root)
    assert layout.staging_dirs(root) == [] and mgr2.latest_step() == 1
    mgr.close()
    mgr2.close()


def test_manifest_written_last_and_corruption(tmp_path):
    path = write_checkpoint(str(tmp_path), 5, snapshot(
        {"w": torch.arange(64, dtype=torch.float32)}))
    shard = next(f for f in os.listdir(path) if f.endswith(".bin"))
    fpath = os.path.join(path, shard)
    data = bytearray(open(fpath, "rb").read())
    data[7] ^= 0xFF
    open(fpath, "wb").write(bytes(data))
    for fn in (load_arrays, verify_checkpoint):
        with pytest.raises(MXNetError, match=f"checksum mismatch"):
            fn(path)
    with pytest.raises(MXNetError, match=shard):
        verify_checkpoint(path)
    open(fpath, "wb").write(bytes(data[:-16]))
    with pytest.raises(MXNetError, match="truncated"):
        load_arrays(path)
    os.remove(os.path.join(path, layout.MANIFEST_NAME))
    assert layout.committed_steps(str(tmp_path)) == []
    with pytest.raises(MXNetError, match="manifest"):
        read_manifest(path)
    with pytest.raises(MXNetError, match="bfloat16"):
        snapshot({"w": torch.zeros(2, dtype=torch.bfloat16)})


def test_retention_policies_and_async_writer(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "gc"), keep_last=2, keep_every=10)
    for step in [5, 10, 15, 20, 25]:
        mgr.save(step, {"w": np.full((4,), step, np.float32)}, blocking=True)
    assert mgr.all_steps() == [10, 20, 25]
    arrays, _, step = mgr.restore()
    assert step == 25 and arrays["w"][0] == 25
    mgr.close()
    mgr = CheckpointManager(str(tmp_path / "policy"), save_interval_steps=10)
    assert not mgr.should_save(7) and mgr.should_save(10)
    mgr.save(10, {"w": np.zeros(2, np.float32)}, blocking=True)
    assert not mgr.should_save(10)
    mgr.preempted = True
    assert mgr.should_save(11)
    mgr.close()
    mgr = CheckpointManager(str(tmp_path / "async"))
    gate = threading.Event()
    real = mgr._writer.submit
    mgr._writer.submit = lambda fn: real(lambda: (gate.wait(5.0), fn()))
    mgr.save(1, {"w": np.arange(8, dtype=np.float32)})
    assert mgr.all_steps() == []
    gate.set()
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1]
    mgr._writer.submit = real
    mgr._writer.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(MXNetError, match="disk full"):
        mgr.wait_until_finished()
    mgr.close()
    with pytest.raises(MXNetError, match="shape"):
        _adapt_shape("w", np.zeros((4, 4), np.float32), (8, 2))
    with pytest.raises(MXNetError, match="non-zero"):
        _adapt_shape("s", np.ones((16,), np.float32), (10,))


def test_sigterm_preemption_resume(tmp_path):
    batches = _batches(6, seed=9)
    tr = _port(seed=21)
    mgr = CheckpointManager(str(tmp_path))
    mgr.install_preemption_hook(lambda: tr.save_state(mgr, blocking=True))
    try:
        done = []
        for i, b in enumerate(batches):
            if mgr.preempted:
                break
            tr.step(b)
            done.append(i)
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
        assert done == [0, 1, 2] and mgr.latest_step() == 3
    finally:
        mgr.uninstall_preemption_hook()
    ref = _port(seed=21)
    for b in batches[:3]:
        ref.step(b)
    want = [ref.step(b)[0] for b in batches[3:]]
    tr2 = _port(seed=77, args=False)
    assert tr2.restore_or_initialize(mgr) == 3
    for i, b in enumerate(batches[3:]):
        assert torch.equal(tr2.step(b)[0], want[i]), i
    mgr.close()


GUARDED_ADAM = dict(opt=ADAM, guard=True, loss_scale="dynamic",
                    guard_params={"init_scale": 64.0, "growth_interval": 2})


def _signal_inside_step(tr, where, at):
    """Patch ``tr`` to raise SIGTERM inside update ``at``: before the
    update (the count has moved, nothing else has) or just after the
    fused kernel has written the weights (the guard state and aux have
    not moved yet)."""
    name = "_apply_update" if where == "before_update" else "_fused_apply"
    orig = getattr(tr, name)

    def patched(*args):
        if where == "before_update" and tr._num_update == at:
            signal.raise_signal(signal.SIGTERM)
        out = orig(*args)
        if where != "before_update" and tr._num_update == at:
            signal.raise_signal(signal.SIGTERM)
        return out

    setattr(tr, name, patched)


@pytest.mark.parametrize("where,exit_after", [
    ("before_update", False), ("after_weights", False),
    ("after_weights", True)],
    ids=["before-update", "after-weights", "after-weights-exit"])
def test_sigterm_inside_a_step_saves_the_whole_step(tmp_path, where,
                                                    exit_after):
    """A preemption hook reached mid-step saves the step whole, at its
    end: the resumed run equals the uninterrupted one BITWISE (heads,
    weights, Adam moments, guard scale, streak and counters)."""
    batches = _batches(6, seed=9)
    tr = _port(seed=21, **GUARDED_ADAM)
    mgr = CheckpointManager(str(tmp_path))
    mgr.install_preemption_hook(lambda: tr.save_state(mgr, blocking=True),
                                exit_after=exit_after)
    _signal_inside_step(tr, where, at=3)
    done = []
    try:
        for i, b in enumerate(batches):
            if mgr.preempted:
                break
            tr.step(b)
            done.append(i)
    except SystemExit as e:
        assert exit_after and e.code == 128 + signal.SIGTERM
    finally:
        mgr.uninstall_preemption_hook()
    assert done == ([0, 1] if exit_after else [0, 1, 2])
    assert mgr.all_steps() == [3] and not tr._in_step
    ref = _port(seed=21, **GUARDED_ADAM)
    for b in batches[:3]:
        ref.step(b)
    want = [ref.step(b)[0] for b in batches[3:]]
    tr2 = _port(seed=77, args=False, **GUARDED_ADAM)
    assert tr2.restore_or_initialize(mgr) == 3
    for i, b in enumerate(batches[3:]):
        assert torch.equal(tr2.step(b)[0], want[i]), i
    _assert_same(_state(ref), _state(tr2))
    mgr.close()


def test_sigterm_inside_a_fit_step_saves_at_the_boundary(tmp_path):
    """Under ``fit`` with its own manager, a signal inside a step leaves
    the save to the batch boundary (with the metric's carry), which
    holds the whole step: restoring it equals stepping the same batches
    BITWISE."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = rng.randint(0, 10, (64,)).astype(np.float32)
    tr = _port(seed=5, **GUARDED_ADAM)
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=100)
    mgr.install_preemption_hook(lambda: tr.save_state(mgr, blocking=True))
    _signal_inside_step(tr, "after_weights", at=2)
    try:
        tr.fit(mxt.io.NDArrayIter(x, y, batch_size=16), eval_metric="acc",
               num_epoch=2, checkpoint_manager=mgr)
    finally:
        mgr.uninstall_preemption_hook()
    assert mgr.all_steps() == [2] and tr._num_update == 2
    _, meta, _ = mgr.restore()
    assert meta["nbatch"] == 2 and meta["metric_num"] == 32
    assert 0 <= meta["metric_sum"] <= 32
    ref = _port(seed=5, **GUARDED_ADAM)
    for i in range(2):
        ref.step({"data": x[16 * i:16 * i + 16],
                  "softmax_label": y[16 * i:16 * i + 16]})
    tr2 = _port(seed=77, args=False, **GUARDED_ADAM)
    assert tr2.restore_or_initialize(mgr) == 2
    _assert_same(_state(ref), _state(tr2))
    mgr.close()


def test_fit_saves_on_cadence_and_stops_on_preemption(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = rng.randint(0, 10, (64,)).astype(np.float32)
    tr = _port()
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=2)
    tr.fit(mxt.io.NDArrayIter(x, y, batch_size=16), eval_metric="acc",
           num_epoch=2, checkpoint_manager=mgr)
    mgr.wait_until_finished()
    assert mgr.latest_step() == 8
    _, meta, _ = mgr.restore()
    assert meta["num_update"] == 8 and "metric_sum" in meta
    tr2 = _port(seed=13)
    mgr2 = CheckpointManager(str(tmp_path / "pre"), save_interval_steps=100)
    mgr2.install_preemption_hook(lambda: tr2.save_state(mgr2, blocking=True))
    try:
        fired = []

        def batch_cb(param):
            fired.append(1)
            if len(fired) == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        tr2.fit(mxt.io.NDArrayIter(x, y, batch_size=16), eval_metric="acc",
                num_epoch=4, batch_end_callback=batch_cb,
                checkpoint_manager=mgr2)
        assert len(fired) == 2 and mgr2.latest_step() == 2
    finally:
        mgr2.uninstall_preemption_hook()
    mgr.close()
    mgr2.close()


def test_forced_rollback_restores_the_checkpoint(tmp_path):
    tr = _port(guard=True, guard_params={"check_every": 1})
    mgr = CheckpointManager(str(tmp_path))
    for b in _batches(3):
        tr.step(b)
    tr.save_state(mgr, blocking=True)
    saved = _state(tr)
    tr._sentinel_poll(mgr)                      # baseline
    for b in _batches(2, seed=4):
        tr.step(b)
    hooked = []
    tr._rollback_hook = lambda: hooked.append(True)

    class Forced:
        def observe(self, *args):
            return "rollback"

    tr._sentinel = Forced()
    assert tr._sentinel_poll(mgr) == "rollback"
    assert hooked and tr._rollbacks == 1 and tr._lr_scale == 0.5
    _assert_same((saved[0], dict(saved[1], rollbacks=1)), _state(tr))
    # without a checkpoint a rollback stays a backoff
    empty = CheckpointManager(str(tmp_path / "none"))
    tr._resil_drained = {}
    tr._sentinel_poll(empty)
    tr.step(_batches(1)[0])
    assert tr._sentinel_poll(empty) == "rollback"
    assert tr._rollbacks == 1 and tr._lr_scale == 0.25
    mgr.close()
    empty.close()


def test_legacy_params_fallback(tmp_path):
    prefix = str(tmp_path / "legacy")
    with mxt.name.NameManager():
        sym = _mlp(tsym)
    arg = {"fc1_weight": mxt.nd.array(np.ones((32, 8), np.float32),
                                      ctx=mxt.cpu())}
    mxt.model.save_checkpoint(prefix, 3, sym, arg, None)
    host = load_legacy_params(f"{prefix}-0003.params")
    assert np.array_equal(host["arg:fc1_weight"], np.ones((32, 8)))
    from mxnet_tpu.checkpoint import load_legacy_params as jload
    assert np.array_equal(jload(f"{prefix}-0003.params")["arg:fc1_weight"],
                          host["arg:fc1_weight"])


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def test_arrays_and_models_load_in_the_other_package(tmp_path):
    from mxnet_tpu.checkpoint import load_arrays as jload_arrays
    from mxnet_tpu.checkpoint import verify_checkpoint as jverify
    rng = np.random.RandomState(0)
    arrays = {"a": rng.randn(3, 5).astype(np.float32),
              "i": np.arange(7, dtype=np.int32),
              "u": np.arange(4, dtype=np.uint32)}
    with mx.name.NameManager():
        jsym_ = _mlp(mx.symbol)
    with mxt.name.NameManager():
        tsym_ = _mlp(tsym)
    params = {k: np.asarray(v, np.float32) for k, v in _args().items()}
    for tag, Mine, Other, sym, load, verify in (
            ("t", CheckpointManager, JMgr, tsym_, jload_arrays, jverify),
            ("j", JMgr, CheckpointManager, jsym_, load_arrays,
             verify_checkpoint)):
        mine = Mine(str(tmp_path / tag))
        mine.save(1, arrays, meta={"k": 1}, blocking=True)
        mine.save_model(2, sym, params, {}, blocking=True)
        path = mine.step_path(1)
        got = load(path)
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes()
        assert verify(path) == {"arrays": 3, "shards": 3,
                                "bytes": sum(v.nbytes for v in arrays.values())}
        other = Other(str(tmp_path / tag))
        osym, oarg, oaux, step = other.load_model()
        assert step == 2 and oaux == {}
        assert osym.tojson() == sym.tojson()
        for k, v in params.items():
            assert oarg[k].asnumpy().tobytes() == v.tobytes()
        mine.close()
        other.close()
    # both packages write the same manifest for the same arrays
    a = read_manifest(str(tmp_path / "t" / layout.step_dir_name(1)))
    b = read_manifest(str(tmp_path / "j" / layout.step_dir_name(1)))
    assert a == b


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_trainer_state_restores_across_packages(tmp_path, fused, direction):
    batches = _batches(5, seed=2)
    kw = dict(guard=True, loss_scale="dynamic",
              guard_params={"init_scale": 16.0, "growth_interval": 1})
    jt, tt = _jax(SGD, fused, **kw), _port(SGD, fused, **kw)
    assert tt._fused == (fused is None) and jt._fused == (fused is None)
    src, Mgr, dst = ((jt, JMgr, _port(SGD, fused, args=False, seed=5, **kw))
                     if direction == "jax-to-port" else
                     (tt, CheckpointManager, _jax(SGD, fused, **kw)))
    for b in batches[:2]:
        src.step(b)
    mgr = Mgr(str(tmp_path))
    src.save_state(mgr, blocking=True)
    mgr.close()
    reader = (CheckpointManager if Mgr is JMgr else JMgr)(str(tmp_path))
    meta, step = dst.restore_state(reader)
    reader.close()
    assert step == 2 and dst._num_update == 2
    # bitwise the saved arrays, and the same guard state
    for n in ("fc1_weight", "fc2_weight", "fc2_bias"):
        assert (np.asarray(dst.get_params()[0][n].asnumpy()).tobytes()
                == np.asarray(src.get_params()[0][n].asnumpy()).tobytes())
    rs, rd = src.resilience_stats(), dst.resilience_stats()
    for k in ("loss_scale", "good_steps", "skipped_steps", "num_update"):
        assert rd[k] == rs[k], k
    # 3 more steps: the restored trainer follows the source's own run
    for b in batches[2:]:
        src.step(b)
        dst.step(b)
    sa, da = src.get_params()[0], dst.get_params()[0]
    for n in sa:
        np.testing.assert_allclose(da[n].asnumpy(), sa[n].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_mismatched_layout_raises_naming_the_missing_arrays(tmp_path):
    jt = _jax(SGD)                       # fused: opt:fused:<bucket>:<leaf>
    jt.step(_batches(1)[0])
    mgr = JMgr(str(tmp_path))
    jt.save_state(mgr, blocking=True)
    mgr.close()
    tt = _port(SGD, fused=False)
    before = {n: p.detach().clone() for n, p in tt._params.items()}
    reader = CheckpointManager(str(tmp_path))
    with pytest.raises(MXNetError, match=r"opt:fc1_weight:0"):
        tt.restore_state(reader)
    for n, p in tt._params.items():      # nothing restored by half
        assert torch.equal(p, before[n])
    adam = _port(ADAM)
    with pytest.raises(MXNetError, match="lacks"):
        adam.restore_state(reader)
    reader.close()


# ---------------------------------------------------------------------------
# Resharding: a checkpoint of one mesh restores onto another
# (tests/test_checkpoint.py, the reshard cases)
# ---------------------------------------------------------------------------

def _cpus(n):
    return [mxt.cpu(i) for i in range(n)]


def _port_mesh(n, shard_optimizer=True, seed=3):
    with mxt.name.NameManager():
        sym = _mlp(tsym)
    tr = ShardedTrainer(sym, SGD[0], dict(SGD[1]),
                        mesh=mxt.parallel.make_mesh({"data": n}, _cpus(n)),
                        shard_optimizer=shard_optimizer, seed=seed)
    return tr.bind(*SHAPES, arg_params={
        k: np.asarray(v, np.float32) for k, v in _args(seed).items()})


def _jax_mesh(n, shard_optimizer=True, seed=3):
    with mx.name.NameManager():
        sym = _mlp(mx.symbol)
    tr = JaxTrainer(sym, optimizer=SGD[0], optimizer_params=dict(SGD[1]),
                    mesh=make_mesh({"data": n}, jax.devices()[:n]),
                    shard_optimizer=shard_optimizer)
    tr.bind(*SHAPES, arg_params={k: jnp.asarray(np.asarray(v, np.float32))
                                 for k, v in _args(seed).items()})
    return tr


def test_reshard_8_to_4(tmp_path):
    """A checkpoint of an 8-member ZeRO trainer restores onto 4 members:
    the flatten-and-pad state's padded length changes with the member
    count.  Parameters and the state's unpadded values are BITWISE the
    checkpoint's; the next step matches the 8-member run within rtol
    1e-5, atol 1e-6 (the member sum's order differs)."""
    batches = _batches(4, seed=2)
    tr8 = _port_mesh(8)
    for b in batches[:3]:
        tr8.step(b)
    mgr = CheckpointManager(str(tmp_path))
    path = tr8.save_state(mgr, blocking=True)
    ref = tr8.step(batches[3])[0].numpy()
    tr4 = _port_mesh(4, seed=31)
    assert tr4._zero_flat != tr8._zero_flat   # the padded lengths differ
    meta, step = tr4.restore_state(mgr)
    assert meta["data_axis_size"] == 8 and step == 3
    host = load_arrays(path)
    for n in tr4._param_names:
        np.testing.assert_array_equal(tr4._params[n].detach().numpy(),
                                      host[f"param:{n}"])
        for i in range(1, 4):      # every member holds the restored copy
            assert torch.equal(tr4._member_params(i)[n], tr4._params[n])
    for n in tr4._param_names:
        saved = host[f"opt:{n}:0"].ravel()
        mine = tr4._state_arrays()[f"opt:{n}:0"].numpy().ravel()
        k = min(saved.size, mine.size)
        np.testing.assert_array_equal(mine[:k], saved[:k])
    got = tr4.step(batches[3])[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    mgr.close()


@pytest.mark.parametrize("direction", ["jax8-to-port4", "port8-to-jax4"])
def test_reshard_across_packages(tmp_path, direction):
    """An 8-device ZeRO checkpoint of one package restores onto 4
    members of the other: parameters BITWISE, and three more steps follow
    the source's own run within rtol 1e-4, atol 1e-6."""
    batches = _batches(5, seed=4)
    if direction == "jax8-to-port4":
        src, Mgr, dst, Reader = (_jax_mesh(8), JMgr, _port_mesh(4, seed=5),
                                 CheckpointManager)
    else:
        src, Mgr, dst, Reader = (_port_mesh(8), CheckpointManager,
                                 _jax_mesh(4), JMgr)
    for b in batches[:2]:
        src.step(b)
    mgr = Mgr(str(tmp_path))
    src.save_state(mgr, blocking=True)
    mgr.close()
    reader = Reader(str(tmp_path))
    meta, step = dst.restore_state(reader)
    reader.close()
    assert step == 2 and meta["data_axis_size"] == 8
    sp, dp = src.get_params()[0], dst.get_params()[0]
    for n in sp:
        assert dp[n].asnumpy().tobytes() == sp[n].asnumpy().tobytes(), n
    for b in batches[2:]:
        src.step(b)
        dst.step(b)
    sp, dp = src.get_params()[0], dst.get_params()[0]
    for n in sp:
        np.testing.assert_allclose(dp[n].asnumpy(), sp[n].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_reshard_refuses_real_shape_change(tmp_path):
    """Only the ZeRO flat-pad 1-D case reshapes; another model raises,
    and restoring onto a mesh's shardings cuts each array into the
    members' pieces."""
    with pytest.raises(MXNetError, match="shape"):
        _adapt_shape("w", np.zeros((4, 4), np.float32), (8, 2))
    with pytest.raises(MXNetError, match="non-zero"):
        _adapt_shape("s", np.ones((16,), np.float32), (10,))
    tr = _port_mesh(8, shard_optimizer=False)
    tr.step(_batches(1)[0])
    mgr = CheckpointManager(str(tmp_path))
    tr.save_state(mgr, blocking=True)
    mesh = mxt.parallel.make_mesh({"data": 4}, _cpus(4))
    arrays, _, _ = mgr.restore(
        names=["param:fc1_weight", "param:fc2_bias"],
        shardings={"param:fc1_weight": mxt.parallel.batch_sharding(mesh),
                   "param:fc2_bias": mxt.parallel.replicated(mesh)})
    w = tr._params["fc1_weight"].detach()
    assert [tuple(p.shape) for p in arrays["param:fc1_weight"]] == \
        [(8, 8)] * 4
    assert torch.equal(torch.cat(arrays["param:fc1_weight"]), w)
    assert all(torch.equal(p, tr._params["fc2_bias"].detach())
               for p in arrays["param:fc2_bias"])
    with mxt.name.NameManager():
        wide = tsym.SoftmaxOutput(data=tsym.FullyConnected(
            data=tsym.Variable("data"), num_hidden=12, name="fc2"),
            name="softmax")
    other = ShardedTrainer(wide, "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9},
                           mesh=mesh).bind(*SHAPES)
    with pytest.raises(MXNetError):
        other.restore_state(mgr)
    mgr.close()
