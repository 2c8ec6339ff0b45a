"""Elastic training in the PyTorch port (``parallel/elastic.py``:
``ElasticTrainer``, ``default_mesh_size``, ``pow2_floor``,
``wire_watchdog``) against the JAX package's, after
``tests/test_elastic.py`` (its membership tests are held in
``tests/test_torch_dist_kvstore.py``).

* ``pow2_floor`` and ``default_mesh_size`` equal JAX's over a sweep; the
  resize guards raise as JAX's do.
* ``wire_watchdog`` chains ``on_death``: ``prev``, ``mdead``, ``fail``,
  in that order, and ``watchdog.deaths`` counts the verdict, as in JAX.
* The 8 -> 4 -> 8 round trip with ZeRO over ``cpu(0)``...``cpu(7)``
  against the JAX ``ElasticTrainer`` over 8 virtual devices, both
  generation-1 trainers given the same numpy weights: heads within
  rtol 1e-5 / atol 1e-7 of JAX's at every step; within the port each
  post-resize segment is bitwise a fresh trainer on that mesh restored
  from the resize's snapshot; ``steps_lost == 0``, ``retraces == 0``,
  ``num_update == 12`` and the records equal JAX's in keys, direction
  and sizes.  ``maybe_resize`` follows a view's capacity as JAX's does.
* A SIGTERM inside a step (``install_preemption_hook(et.save_now)``)
  saves at the step's end, and a fresh trainer resumes from it bitwise.
* The chaos run: this file as the program of a ``launch_local`` cluster
  (``python tests/test_torch_elastic.py``; worker 0 the trainer, workers
  1-3 capacity members of 2 contexts each): ``worker_kill`` on worker 2
  at step 4 shrinks 8 -> 4; the trainer waits for the kill in the
  membership view (no sleeps pace it); every update completes, the
  epoch bumps, and the post-resize heads are bitwise a fresh trainer
  restored from the snapshot.
* A SIGTERM inside a resize's restore (``python
  tests/test_torch_elastic.py sigterm DIR``, a file handshake instead of
  the JAX test's 30 s sleep) skips the forced save: the resize's
  snapshot at update 4 is the only checkpoint, and a fresh trainer
  resumes from it on the smaller mesh.

The children import torch, numpy and the port only.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

SHAPES = ({"data": (32, 8)}, {"softmax_label": (32,)})
SGD = {"learning_rate": 0.1}
HEAD = dict(rtol=1e-5, atol=1e-7)
CAPACITY, STEPS, KILL_AT, WAIT = 2, 12, 4, 120.0


@pytest.fixture(autouse=True)
def _keep_random_states():
    """Restore both packages' global random state after each test."""
    from mxnet_tpu import random as jrandom
    from mxnet_tpu_torch import random as port_random
    jsaved = dict(jrandom._state)
    saved = dict(port_random._state)
    gens = {d: g.get_state() for d, g in port_random._generators.items()}
    yield
    jrandom._state.update(jsaved)
    port_random._state.update(saved)
    for d in list(port_random._generators):
        if d in gens:
            port_random._generators[d].set_state(gens[d])
        else:
            del port_random._generators[d]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mlp(S):
    d = S.Variable("data")
    f1 = S.FullyConnected(data=d, name="fc1", num_hidden=16)
    a = S.Activation(data=f1, name="r", act_type="relu")
    f2 = S.FullyConnected(data=a, name="fc2", num_hidden=4)
    return S.SoftmaxOutput(data=f2, name="softmax")


def _batch(i):
    rs = np.random.RandomState(100 + i)
    return {"data": (rs.randn(32, 8) * 0.1).astype(np.float32),
            "softmax_label": (rs.rand(32) * 4).astype(np.float32)}


def _weights():
    rs = np.random.RandomState(7)
    return {"fc1_weight": rs.uniform(-0.5, 0.5, (16, 8)),
            "fc1_bias": rs.uniform(-0.1, 0.1, 16),
            "fc2_weight": rs.uniform(-0.5, 0.5, (4, 16)),
            "fc2_bias": rs.uniform(-0.1, 0.1, 4)}


def _cpus(n):
    import mxnet_tpu_torch as mxt
    return [mxt.cpu(i) for i in range(n)]


def _port_elastic(mgr, membership=None, n=8):
    import mxnet_tpu_torch as mxt
    from mxnet_tpu_torch.parallel import ElasticTrainer
    et = ElasticTrainer(_mlp(mxt.symbol), optimizer="sgd",
                        optimizer_params=SGD, manager=mgr,
                        membership=membership, devices=_cpus(n),
                        prewarm=False,
                        trainer_kwargs={"shard_optimizer": True})
    return et


def _fresh_port(mgr, ndev, seed, step=None):
    """A fresh port trainer on an ndev mesh restored from mgr's snapshot
    ``step`` (default the newest; another seed: the restore must erase
    the init)."""
    import mxnet_tpu_torch as mxt
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh
    ref = ShardedTrainer(_mlp(mxt.symbol), optimizer="sgd",
                         optimizer_params=SGD,
                         mesh=make_mesh({"data": ndev}, _cpus(ndev)),
                         shard_optimizer=True, seed=seed)
    ref.bind(*SHAPES)
    _, step = ref.restore_state(mgr, step=step)
    return ref, step


# ---------------------------------------------------------------------------
# the children's programs
# ---------------------------------------------------------------------------

def _trainer_progress(view):
    return max([m["progress"] for m in view["members"].values()] or [0])


def run_capacity_member(wid):
    """A capacity member: joins, beats, and kills itself (``worker_kill``)
    once the trainer's published step reaches the chaos point."""
    from mxnet_tpu_torch import chaos
    from mxnet_tpu_torch.parallel.dist_kvstore import MembershipClient
    spec = chaos.elastic_from_env()
    mine = spec is not None and chaos.chaos_worker() == int(wid)
    kill_at = (min(spec.points["worker_kill"])
               if mine and "worker_kill" in spec.points else None)
    client = MembershipClient(member_id=wid, capacity=CAPACITY).start()
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        view = client.view
        if view is not None:
            if kill_at is not None and _trainer_progress(view) >= kill_at:
                print(f"worker {wid}: chaos worker_kill at trainer step "
                      f"{_trainer_progress(view)}", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            if view["closing"]:
                client.leave()
                client.close()
                return 0
        time.sleep(0.02)
    return 3


def run_trainer(wid):
    """The trainer: an ElasticTrainer over 8 CPU contexts sized by the
    view; after the chaos step it waits until the kill shows in the view,
    so the resize lands before the next step.  Writes ``results.json``."""
    from mxnet_tpu_torch import chaos
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel.dist_kvstore import MembershipClient
    out_dir = os.environ["ELASTIC_TEST_OUT"]
    expect = int(os.environ["MXTPU_NUM_WORKER"])
    spec = chaos.elastic_from_env()
    kill_at = min(spec.points["worker_kill"]) if spec else None
    client = MembershipClient(member_id=wid, capacity=CAPACITY).start()
    if client.wait_for(lambda v: len(v["members"]) >= expect,
                       timeout=WAIT) is None:
        return 4
    epoch0 = client.epoch
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
    et = _port_elastic(mgr, membership=client)
    mgr.install_preemption_hook(et.save_now, exit_after=True)
    et.bind(*SHAPES)
    et.trainer.set_params(_weights())
    heads, epochs, sizes = [], [], []
    for i in range(STEPS):
        out = et.step(_batch(i))
        heads.append(out[0].numpy().tobytes().hex())
        epochs.append(client.epoch)
        sizes.append(et.size)
        client.set_progress(i + 1)
        client.beat_now()   # publish the step clock promptly
        if kill_at is not None and i + 1 == kill_at:
            if client.wait_for(lambda v: len(v["members"]) < expect,
                               timeout=WAIT) is None:
                return 5
    results = {"steps": STEPS, "num_update": et.num_update,
               "epoch_initial": epoch0, "epoch_final": client.epoch,
               "epochs": epochs, "sizes": sizes, "heads": heads,
               "resizes": et.resizes, "generation": et.generation}
    tmp = os.path.join(out_dir, "results.json.tmp")
    with open(tmp, "w") as f:
        json.dump(results, f)
    os.replace(tmp, os.path.join(out_dir, "results.json"))
    et.shutdown(final=True)
    mgr.uninstall_preemption_hook()
    mgr.close()
    client.close()
    return 0


def run_sigterm_child(root):
    """SIGTERM target: 4 steps, then a resize to 4 whose restore writes
    ``RESTORING`` (once the resize's own snapshot committed) and waits
    for the signal, which exits the process (``exit_after``)."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(root)
    et = _port_elastic(mgr)
    mgr.install_preemption_hook(et.save_now, exit_after=True)
    et.bind(*SHAPES)
    et.trainer.set_params(_weights())
    for i in range(4):
        et.step(_batch(i))
    orig = mgr.restore

    def slow_restore(*a, **kw):
        mgr.wait_until_finished()
        open(os.path.join(os.path.dirname(root), "RESTORING"), "w").close()
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            time.sleep(0.01)    # the handler runs between these
        return orig(*a, **kw)

    mgr.restore = slow_restore
    et.resize(4)
    print("UNEXPECTED-SURVIVED", flush=True)
    return 0


def worker_main(argv):
    if argv[:1] == ["sigterm"]:
        return run_sigterm_child(argv[1])
    from mxnet_tpu_torch.parallel.dist_kvstore import (role_from_env,
                                                       run_scheduler)
    cfg = role_from_env()
    if cfg.get("role") == "scheduler":
        run_scheduler(cfg)
        return 0
    if cfg.get("role") == "server":
        return 0    # the membership harness runs no PS servers
    wid = os.environ.get("MXTPU_WORKER_ID", "0")
    return run_trainer(wid) if wid == "0" else run_capacity_member(wid)


# ---------------------------------------------------------------------------
# mesh-size policy and guards
# ---------------------------------------------------------------------------

def test_pow2_floor_and_default_mesh_size_match_jax():
    from mxnet_tpu.parallel import default_mesh_size as jsize
    from mxnet_tpu.parallel import pow2_floor as jfloor
    from mxnet_tpu_torch.parallel import default_mesh_size, pow2_floor
    assert [pow2_floor(n) for n in (1, 2, 3, 4, 5, 7, 8, 9, 15, 16)] == \
        [1, 2, 2, 4, 4, 4, 8, 8, 8, 16]
    for n in range(-5, 300):
        assert pow2_floor(n) == jfloor(n), n
    rs = np.random.RandomState(0)
    views = [{"epoch": 0, "closing": False, "members": {}}]
    for k in range(1, 7):
        for _ in range(8):
            caps = rs.randint(0, 5, k)
            views.append({"epoch": k, "closing": False, "members": {
                str(i): ({"capacity": int(c), "progress": 0} if c
                         else {"progress": 0})
                for i, c in enumerate(caps)}})
    for view in views:
        for max_devices in (1, 2, 3, 4, 7, 8, 16):
            assert default_mesh_size(view, max_devices) == \
                jsize(view, max_devices), (view, max_devices)


def test_resize_guards(tmp_path):
    import mxnet_tpu_torch as mxt
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import ElasticTrainer
    et = ElasticTrainer(_mlp(mxt.symbol), device="cpu", prewarm=False)
    with pytest.raises(MXNetError, match="bind"):
        et.resize(4)
    with pytest.raises(MXNetError, match="bind"):
        et.trainer
    assert et._devices == [mxt.cpu(0)]
    et = ElasticTrainer(_mlp(mxt.symbol), devices=_cpus(4), prewarm=False)
    et.bind(*SHAPES)
    assert et.size == 4 and et.generation == 1
    assert et.resize(4) == {}
    with pytest.raises(MXNetError, match="CheckpointManager"):
        et.resize(2)
    et.manager = CheckpointManager(str(tmp_path))
    with pytest.raises(MXNetError, match="out of range"):
        et.resize(8)
    et.manager.close()
    if not __import__("torch").cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            ElasticTrainer(_mlp(mxt.symbol))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_watchdog_death_feeds_membership(package):
    """``wire_watchdog`` chains the existing ``on_death`` observer and
    reports the dead rank into the membership stream, before
    ``on_failure``; ``watchdog.deaths`` counts it.  The same order in
    both packages."""
    import threading
    if package == "port":
        from mxnet_tpu_torch import telemetry
        from mxnet_tpu_torch.parallel import wire_watchdog
        from mxnet_tpu_torch.parallel.watchdog import Watchdog
    else:
        from mxnet_tpu import telemetry
        from mxnet_tpu.parallel import wire_watchdog
        from mxnet_tpu.parallel.watchdog import Watchdog
    order = []

    class FakeMembership:
        def report_dead(self, member_id, reason="watchdog"):
            order.append(("mdead", member_id, reason))

    wd = Watchdog(0, 2, ("127.0.0.1", _free_port()),
                  on_failure=lambda r: order.append(("fail", r)),
                  on_death=lambda r: order.append(("prev", r)))
    assert wire_watchdog(wd, FakeMembership()) is wd
    wd._mon_lock = threading.Lock()
    wd._conns = {}
    before = telemetry.counter("watchdog.deaths").value(peer="1")
    wd._declare_dead(1)
    assert order == [("prev", 1), ("mdead", "1", "watchdog-death"),
                     ("fail", 1)]
    assert telemetry.counter("watchdog.deaths").value(peer="1") == \
        before + 1
    wd._declare_dead(1)     # a second verdict is a no-op (stopped)
    assert len(order) == 3


# ---------------------------------------------------------------------------
# the 8 -> 4 -> 8 round trip against the JAX ElasticTrainer
# ---------------------------------------------------------------------------

def _jax_head(out):
    import jax
    return np.asarray(jax.device_get(out[0]))


def test_elastic_resize_8_4_8_roundtrip(tmp_path):
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.checkpoint import CheckpointManager as JaxManager
    from mxnet_tpu.parallel import ElasticTrainer as JaxElastic
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    weights = _weights()

    jmgr = JaxManager(str(tmp_path / "jax"))
    jet = JaxElastic(_mlp(mx.symbol), optimizer="sgd",
                     optimizer_params=SGD, manager=jmgr, prewarm=False,
                     trainer_kwargs={"shard_optimizer": True})
    jet.bind(*SHAPES)
    jet.trainer.set_params({k: jnp.asarray(v, jnp.float32)
                            for k, v in weights.items()})
    mgr = CheckpointManager(str(tmp_path / "port"))
    et = _port_elastic(mgr)
    et.bind(*SHAPES)
    et.trainer.set_params({k: v.astype(np.float32)
                           for k, v in weights.items()})
    assert et.size == jet.size == 8 and et.generation == 1

    def steps(lo, hi):
        mine = []
        for i in range(lo, hi):
            head = et.step(_batch(i))[0].numpy()
            np.testing.assert_allclose(head, _jax_head(jet.step(_batch(i))),
                                       **HEAD)
            mine.append(head)
        return mine

    steps(0, 4)
    for e in (jet, et):
        e.prewarm([4], wait=True)
    rec, jrec = et.resize(4), jet.resize(4)
    outs4 = steps(4, 8)
    rec2, jrec2 = et.resize(8), jet.resize(8)
    outs8 = steps(8, 12)

    for mine, theirs in ((rec, jrec), (rec2, jrec2)):
        assert sorted(mine) == sorted(theirs)
        for k in ("direction", "from_devices", "to_devices", "epoch",
                  "steps_lost", "num_update"):
            assert mine[k] == theirs[k], k
        assert mine["steps_lost"] == 0 and mine["retraces"] == 0
    assert (rec["direction"], rec["from_devices"], rec["to_devices"]) == \
        ("shrink", 8, 4)
    assert (rec2["direction"], rec2["num_update"]) == ("grow", 8)
    assert et.num_update == jet.num_update == 12
    assert et.generation == 3 and et.size == 8

    # within the port: each segment bitwise a fresh trainer on its mesh
    # restored from the resize's snapshot
    for ndev, lo, outs in ((4, 4, outs4), (8, 8, outs8)):
        # the snapshot of update `lo` is the newest committed one until the
        # next resize saves: restore it by step
        ref, step = _fresh_port(mgr, ndev, seed=99 + ndev, step=lo)
        assert step == lo
        for i, mine in enumerate(outs, lo):
            assert np.array_equal(mine, ref.step(_batch(i))[0].numpy()), i
    mgr.close()
    jmgr.close()


def test_maybe_resize_follows_the_view(tmp_path):
    """A membership stand-in whose view changes: a capacity loss shrinks
    the mesh, a capacity-neutral epoch bump is absorbed, a stale epoch is
    ignored; the same sizes and verdicts as the JAX trainer's."""
    import mxnet_tpu as mx
    from mxnet_tpu.checkpoint import CheckpointManager as JaxManager
    from mxnet_tpu.parallel import ElasticTrainer as JaxElastic
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    class View:
        view = None

    def view(epoch, *caps):
        return {"epoch": epoch, "closing": False,
                "members": {str(i): {"capacity": c, "progress": 0}
                            for i, c in enumerate(caps)}}

    port_m, jax_m = View(), View()
    port_m.view = jax_m.view = view(1, 2, 2, 2, 2)
    mgr = CheckpointManager(str(tmp_path / "port"))
    jmgr = JaxManager(str(tmp_path / "jax"))
    et = _port_elastic(mgr, membership=port_m)
    jet = JaxElastic(_mlp(mx.symbol), optimizer="sgd",
                     optimizer_params=SGD, manager=jmgr,
                     membership=jax_m, prewarm=False,
                     trainer_kwargs={"shard_optimizer": True})
    et.bind(*SHAPES)
    jet.bind(*SHAPES)
    got = []
    for v in (view(2, 2, 2, 2), view(3, 1, 1, 1, 1),
              view(3, 2, 2, 2, 2), view(4, 2, 2, 2, 2, 2), view(5, 1)):
        port_m.view = jax_m.view = v
        got.append((et.maybe_resize(), et.size,
                    jet.maybe_resize(), jet.size))
    assert got == [(True, 4, True, 4), (False, 4, False, 4),
                   (False, 4, False, 4), (True, 8, True, 8),
                   (True, 1, True, 1)]
    assert [r["epoch"] for r in et.resizes] == \
        [r["epoch"] for r in jet.resizes] == [2, 4, 5]
    mgr.close()
    jmgr.close()


# ---------------------------------------------------------------------------
# SIGTERM inside a step
# ---------------------------------------------------------------------------

def test_sigterm_inside_a_step_saves_at_its_end(tmp_path):
    """The preemption hook's ``save_now`` reached inside update 4 (the
    signal sent from the step's forward) defers the save to the step's
    end: the only checkpoint is update 4, and a fresh trainer restored
    from it takes the next 2 steps bitwise as the uninterrupted run."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    straight = _port_elastic(None, n=2)
    straight.bind(*SHAPES)
    straight.trainer.set_params(_weights())
    want = [straight.step(_batch(i))[0].numpy() for i in range(6)]

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    et = _port_elastic(mgr, n=2)
    et.bind(*SHAPES)
    et.trainer.set_params(_weights())
    tr = et.trainer
    inner = tr._device_step

    def step_with_signal(placed):
        if tr._num_update == 4:
            os.kill(os.getpid(), signal.SIGTERM)   # handled here, mid-step
        return inner(placed)

    tr._device_step = step_with_signal
    mgr.install_preemption_hook(et.save_now, exit_after=False)
    try:
        for i in range(4):
            et.step(_batch(i))
    finally:
        mgr.uninstall_preemption_hook()
    assert mgr.preempted and mgr.all_steps() == [4]
    ref, step = _fresh_port(mgr, 2, seed=5)
    assert step == 4 and ref._num_update == 4
    for i in (4, 5):
        assert np.array_equal(ref.step(_batch(i))[0].numpy(), want[i]), i
    mgr.close()


# ---------------------------------------------------------------------------
# launched: the chaos run and SIGTERM inside a resize's restore
# ---------------------------------------------------------------------------

def test_chaos_worker_kill_completes_with_epoch_bump(tmp_path, monkeypatch):
    """SIGKILL capacity worker 2 once the trainer reaches step 4: the run
    completes every update, the epoch bumps, the mesh shrinks 8 -> 4 with
    zero lost updates and zero kernel builds, and the 4-member segment is
    bitwise a fresh trainer restored from the resize's snapshot."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel.launch import launch_local
    monkeypatch.setenv("MXNET_TPU_ELASTIC_HEARTBEAT_MS", "100")
    monkeypatch.setenv("PYTHONPATH", _ROOT)
    env = {"ELASTIC_TEST_OUT": str(tmp_path),
           "MXNET_TPU_CHAOS": f"worker_kill:{KILL_AT}",
           "MXNET_TPU_CHAOS_WORKER": "2"}
    codes = launch_local([sys.executable, os.path.abspath(__file__)],
                         num_workers=4, num_servers=0,
                         root_port=_free_port(), worker_env=env,
                         timeout=WAIT + 60, return_codes=True)
    assert codes[2] != 0 and [codes[0], codes[1], codes[3]] == [0, 0, 0], \
        codes
    res = json.loads((tmp_path / "results.json").read_text())
    assert res["num_update"] == res["steps"] == STEPS
    assert res["epoch_final"] > res["epoch_initial"]
    assert res["generation"] == 2 and len(res["resizes"]) == 1
    r = res["resizes"][0]
    assert (r["direction"], r["from_devices"], r["to_devices"]) == \
        ("shrink", 8, 4)
    assert r["steps_lost"] == 0 and r["retraces"] == 0
    assert r["num_update"] == KILL_AT
    assert res["sizes"] == [8] * KILL_AT + [4] * (STEPS - KILL_AT)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    ref, step = _fresh_port(mgr, 4, seed=17)
    assert step == KILL_AT
    for i in range(KILL_AT, STEPS):
        assert ref.step(_batch(i))[0].numpy().tobytes().hex() == \
            res["heads"][i], i
    mgr.close()


def test_sigterm_during_elastic_reshard_keeps_checkpoint_valid(tmp_path):
    """SIGTERM while a resize is reshard-restoring: the preemption handler
    does NOT force-save the half-restored state; the resize's snapshot
    (update 4) is the only checkpoint, and a fresh trainer on the smaller
    mesh resumes from it."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager, layout
    from mxnet_tpu_torch.checkpoint.reader import verify_checkpoint
    root = str(tmp_path / "ckpt")
    flag = tmp_path / "RESTORING"
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "sigterm", root],
        env=dict(os.environ, PYTHONPATH=_ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + WAIT
        while not flag.exists() and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert flag.exists(), proc.communicate(timeout=WAIT)[0]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=WAIT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 128 + signal.SIGTERM, out
    assert "UNEXPECTED-SURVIVED" not in out, out
    assert "skipping the forced save" in out, out
    assert layout.committed_steps(root) == [4], out
    verify_checkpoint(layout.step_path(root, 4))
    mgr = CheckpointManager(root)
    ref, step = _fresh_port(mgr, 4, seed=11)
    assert step == 4 and ref._num_update == 4
    ref.step(_batch(0))
    assert ref._num_update == 5
    mgr.close()


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))
