"""The parameter server of the PyTorch port (``parallel/dist_kvstore.py``,
``parallel/launch.py``, ``kvstore.create("dist*")``) against the JAX
package's, after ``tests/test_dist_kvstore.py`` and the membership and
wire tests of ``tests/test_elastic.py``.

* The wire (``_pack_wire``/``_unpack_wire`` for each compression),
  ``role_from_env`` with its ``DMLC_*`` fallbacks and ``_shards_for``'s
  striping are held to the JAX functions in this process, bitwise.
* The roles run in threads of this process: the priority sender, the
  scheduler's dead-worker verdict, the abort of a server's sync wait, the
  membership views (join, progress, closing, connection loss, expiry
  fencing, ``mdead``), the connect deadline and the RPC retry.
* Two ``launch_local`` runs of this file as the workers' program (``python
  tests/test_torch_dist_kvstore.py sync|async``): ``dist_sync`` with 2
  workers and 2 servers (integer pushes, one key striped over both
  servers, bitwise the closed form; then a small MLP through
  ``FeedForward.fit`` over the same store, every worker above the JAX
  test's accuracy gate of 0.9 on the full set, both workers' parameters
  bitwise equal; then the same through ``Module.fit``), and
  ``dist_async`` (the same pushes: the servers applied each exactly once,
  which the closed form counts).

The workers import torch, numpy and the port only.
"""
import json
import os
import socket
import sys
import threading

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

RATE, NREPEAT = 2, 3
SMALL, BIG = (3, 3), (50, 50)   # BIG: 10000 bytes, above the bound below
BOUND = "4096"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# the workers' program (run by launch_local in every role)
# ---------------------------------------------------------------------------

def _closed_form(nworker: int) -> float:
    """Init 1 plus ``NREPEAT`` rounds of every worker's ``(rank + 1) *
    RATE`` (the reference's ``dist_sync_kvstore.py``): the value after
    each push was applied once."""
    return nworker * (nworker + 1) / 2 * RATE * NREPEAT + 1


def _aggregate(mx, kv, out_dir):
    """Integer pushes to a small key and to a key striped over the
    servers, through the ``test`` optimizer (``w += g`` on the server);
    every pulled value bitwise the closed form."""
    kv.set_optimizer(mx.optimizer.create("test"))
    kv.init("small", mx.nd.ones(SMALL))
    kv.init("big", mx.nd.ones(BIG))
    rank = kv.rank
    for _ in range(NREPEAT):
        kv.push("small", mx.nd.ones(SMALL) * (rank + 1) * RATE)
        kv.push("big", mx.nd.ones(BIG) * (rank + 1) * RATE)
    if kv.type == "dist_async":
        kv.barrier()  # every worker's pushes have been applied
    out_s, out_b = mx.nd.zeros(SMALL), mx.nd.zeros(BIG)
    kv.pull("small", out=out_s)
    kv.pull("big", out=out_b)
    want = _closed_form(kv.num_workers)
    np.testing.assert_array_equal(out_s.asnumpy(), want)
    np.testing.assert_array_equal(out_b.asnumpy(), want)


def _mlp_data(n=400, num_classes=4, dim=10):
    rng = np.random.RandomState(7)  # the same data set on every worker
    centers = rng.randn(num_classes, dim).astype(np.float32) * 3
    y = rng.randint(0, num_classes, n)
    x = (centers[y] + rng.randn(n, dim)).astype(np.float32)
    return x, y.astype(np.float32)


def _fit_mlp(mx, kv, out_dir):
    """``tests/dist_train_worker.py`` at 4 epochs: a contiguous shard per
    worker, gradients through the dist_sync server, the full set scored
    with the synchronized model."""
    rank, nworkers = kv.rank, kv.num_workers
    x, y = _mlp_data()
    lo, hi = len(x) * rank // nworkers, len(x) * (rank + 1) // nworkers
    sym = mx.symbol
    net = sym.FullyConnected(data=sym.Variable("data"), num_hidden=32,
                             name="fc1")
    net = sym.Activation(data=net, act_type="relu", name="relu1")
    net = sym.FullyConnected(data=net, num_hidden=4, name="fc2")
    net = sym.SoftmaxOutput(data=net, name="softmax")
    mx.random.seed(3)
    batch = 50
    it = mx.io.NDArrayIter(x[lo:hi], y[lo:hi], batch_size=batch,
                           last_batch_handle="discard")
    model = mx.FeedForward(net, ctx=mx.cpu(), num_epoch=4, optimizer="sgd",
                           learning_rate=0.1, numpy_batch_size=batch,
                           initializer=mx.initializer.Xavier())
    model.fit(X=it, kvstore=kv)
    acc = model.score(mx.io.NDArrayIter(x, y, batch_size=batch))
    np.savez(os.path.join(out_dir, f"mlp_{rank}.npz"),
             **{n: v.asnumpy() for n, v in model.arg_params.items()})
    # the same net through Module.fit over the same store
    it.reset()
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(it, num_epoch=4, kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=mx.initializer.Xavier())
    mod_acc = dict(mod.score(mx.io.NDArrayIter(x, y, batch_size=batch),
                             "acc"))["accuracy"]
    np.savez(os.path.join(out_dir, f"mod_{rank}.npz"),
             **{n: v.asnumpy() for n, v in mod.get_params()[0].items()})
    return acc, mod_acc


def worker_main(kind: str) -> int:
    import mxnet_tpu_torch as mx
    out_dir = os.environ["KV_TEST_OUT"]
    with mx.cpu():
        kv = mx.kvstore.create(kind)  # a server or the scheduler exits here
        _aggregate(mx, kv, out_dir)
        acc = _fit_mlp(mx, kv, out_dir) if kind == "dist_sync" else None
        rank = kv.rank
        kv.close()
    with open(os.path.join(out_dir, f"worker_{rank}.json"), "w") as f:
        json.dump({"rank": rank, "acc": acc}, f)
    return 0


# ---------------------------------------------------------------------------
# the wire, the environment and the striping against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", [None, "bf16", "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_wire_is_bitwise_jax(compression, dtype):
    from mxnet_tpu.parallel import dist_kvstore as jdk
    from mxnet_tpu_torch.parallel import dist_kvstore as tdk
    rng = np.random.RandomState(3)
    arrays = [(rng.randn(5, 7) * 3).astype(dtype),
              np.zeros((0, 4), dtype),
              (rng.randn(1000) * 1e-3).astype(dtype)]
    arrays[0].flat[3] = 0
    for a in arrays:
        got, want = tdk._pack_wire(a, compression), jdk._pack_wire(a,
                                                                   compression)
        assert got == want
        back, jback = tdk._unpack_wire(want), jdk._unpack_wire(got)
        assert back.dtype == jback.dtype and back.shape == jback.shape
        assert back.tobytes() == jback.tobytes()
    assert tdk._unpack_arr(tdk._pack_arr(arrays[0])).tobytes() == \
        arrays[0].tobytes()


def test_role_from_env_matches_jax(monkeypatch):
    from mxnet_tpu.parallel import dist_kvstore as jdk
    from mxnet_tpu_torch.parallel import dist_kvstore as tdk
    names = ("ROLE", "PS_ROOT_URI", "PS_ROOT_PORT", "NUM_WORKER",
             "NUM_SERVER")
    for n in names:
        monkeypatch.delenv("MXTPU_" + n, raising=False)
        monkeypatch.delenv("DMLC_" + n, raising=False)
    assert tdk.role_from_env() == jdk.role_from_env() == {}
    monkeypatch.setenv("DMLC_ROLE", "server")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "1234")
    monkeypatch.setenv("DMLC_NUM_WORKER", "3")
    assert tdk.role_from_env() == jdk.role_from_env()
    assert tdk.role_from_env()["root_port"] == 1234
    monkeypatch.setenv("MXTPU_ROLE", "worker")
    monkeypatch.setenv("MXTPU_NUM_SERVER", "2")
    monkeypatch.setenv("MXTPU_PS_ROOT_URI", "10.0.0.1")
    got = tdk.role_from_env()
    assert got == jdk.role_from_env()
    assert (got["role"], got["num_workers"], got["num_servers"]) == \
        ("worker", 3, 2)


@pytest.mark.parametrize("servers", [1, 2, 3])
def test_striping_matches_jax(servers):
    from mxnet_tpu.parallel import dist_kvstore as jdk
    from mxnet_tpu_torch.parallel import dist_kvstore as tdk

    def shards(mod, key, arr):
        kv = mod.DistKVStore.__new__(mod.DistKVStore)
        kv._server_socks = [None] * servers
        return kv._shards_for(key, arr)

    bound = tdk.BIGARRAY_BOUND
    assert bound == jdk.BIGARRAY_BOUND
    for key in (0, 3, 17, "fc1_weight", ("w", 2)):
        for n in (1, 7, bound // 4 - 1, bound // 4, bound // 4 + 5,
                  3 * bound):
            arr = np.empty(n, np.float32)
            got, want = shards(tdk, key, arr), shards(jdk, key, arr)
            assert got == want
            if n * 4 >= bound and servers > 1:
                assert len(got) == servers
                assert got[-1][2].stop == n


def test_dist_kvstore_requires_cluster_env(monkeypatch):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    for v in ("MXTPU_ROLE", "DMLC_ROLE"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(jmx.base.MXNetError, match="launch") as jerr:
        jmx.kvstore.create("dist_sync")
    with pytest.raises(mx.base.MXNetError, match="launch") as terr:
        mx.kvstore.create("dist_sync")
    assert str(terr.value).split(" (see")[0] == \
        str(jerr.value).split(" (see")[0]


def test_launch_ssh_runs_the_jax_commands(tmp_path):
    """``launch_ssh`` through a stand-in ``ssh`` that records its
    arguments and exits 0: the same ssh command lines (scheduler, servers
    round-robin, workers) as the JAX launcher, up to the job id."""
    from mxnet_tpu.parallel import launch as jlaunch
    from mxnet_tpu_torch.parallel import launch as tlaunch
    fake = tmp_path / "ssh"
    fake.write_text("#!/bin/sh\nprintf '%s\\n' \"$*\" >> \"$SSH_LOG\"\n")
    fake.chmod(0o755)
    lines = {}
    for name, mod in (("jax", jlaunch), ("port", tlaunch)):
        log = tmp_path / f"{name}.log"
        os.environ["SSH_LOG"] = str(log)
        try:
            code = mod.launch_ssh(["python", "train.py", "--x", "a b"],
                                  ["u@h1", "h2"], num_workers=3,
                                  num_servers=2, root_port=1234,
                                  ssh_bin=str(fake), timeout=60)
        finally:
            del os.environ["SSH_LOG"]
        assert code == 0
        text = log.read_text()
        job = text.split("MXTPU_JOB_ID=")[1].split()[0]
        lines[name] = sorted(text.replace(job, "<job>").splitlines())
    assert len(lines["port"]) == 6
    assert lines["port"] == lines["jax"]


# ---------------------------------------------------------------------------
# roles in threads of this process
# ---------------------------------------------------------------------------

def test_priority_sender_ordering_and_async():
    """Higher priority drains first (the ``-param_index`` convention)
    and ``submit`` returns before the work runs."""
    from mxnet_tpu_torch.parallel.dist_kvstore import _PrioritySender
    s = _PrioritySender("t")
    order = []
    gate = threading.Event()
    s.submit(100, gate.wait)
    for prio in (0, -3, -1, -2):
        s.submit(prio, lambda p=prio: order.append(p))
    assert order == []
    gate.set()
    s.flush()
    assert order == [0, -1, -2, -3], order
    s.close()


def test_priority_sender_error_surfaces_at_flush():
    from mxnet_tpu_torch.parallel.dist_kvstore import _PrioritySender
    s = _PrioritySender("err")
    s.submit(0, lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(RuntimeError, match="boom"):
        s.flush()
    s.close()


def test_scheduler_detects_dead_worker():
    """A worker that dies mid-job fails the others' barriers at once,
    and later barriers too."""
    from mxnet_tpu_torch.parallel import dist_kvstore as dk
    port = _free_port()
    cfg = {"role": "scheduler", "root_host": "127.0.0.1",
           "root_port": port, "num_workers": 2, "num_servers": 0}
    threading.Thread(target=dk.run_scheduler, args=(cfg,),
                     daemon=True).start()
    a = dk._connect("127.0.0.1", port)
    b = dk._connect("127.0.0.1", port)
    for c in (a, b):
        dk._send(c, ("register_worker",))
        assert dk._recv(c)[0] == "ok"
    dk._send(a, ("barrier",))
    b.close()
    a.settimeout(30)
    reply = dk._recv(a)
    assert reply[0] == "barrier_failed" and "died" in reply[1], reply
    dk._send(a, ("barrier",))
    assert dk._recv(a)[0] == "barrier_failed"
    a.close()


def test_dead_worker_aborts_server_sync_wait():
    """A survivor blocked in a sync-mode push gets an error once the
    scheduler sees the other worker die."""
    from mxnet_tpu_torch.parallel import dist_kvstore as dk
    port = _free_port()
    cfg = {"role": "scheduler", "root_host": "127.0.0.1",
           "root_port": port, "num_workers": 2, "num_servers": 1}
    threading.Thread(target=dk.run_scheduler, args=(cfg,),
                     daemon=True).start()
    threading.Thread(target=dk.run_server, args=(dict(cfg, role="server"),),
                     daemon=True).start()
    a = dk._connect("127.0.0.1", port)
    b = dk._connect("127.0.0.1", port)
    dk._send(a, ("register_worker",))
    ra = dk._recv(a)
    dk._send(b, ("register_worker",))
    dk._recv(b)
    host, sport = ra[2][0]
    sa = socket.create_connection((host, sport), timeout=30)
    dk._send(sa, ("cmd", dk._SYNC_MODE, b""))
    assert dk._recv(sa)[0] == "ok"
    dk._send(sa, ("init", 0, dk._pack_arr(np.zeros(4, np.float32))))
    assert dk._recv(sa)[0] == "ok"
    result = {}

    def push_blocking():
        dk._send(sa, ("push", 0, dk._pack_arr(np.ones(4, np.float32))))
        result["reply"] = dk._recv(sa)

    t = threading.Thread(target=push_blocking, daemon=True)
    t.start()
    t.join(timeout=0.3)
    assert "reply" not in result, "the push should wait for worker B"
    b.close()
    t.join(timeout=30)
    assert result.get("reply", ("none",))[0] == "err", result
    assert "aborted" in result["reply"][1]
    a.close()
    sa.close()


def _scheduler(port, num_workers=0):
    from mxnet_tpu_torch.parallel.dist_kvstore import run_scheduler
    cfg = {"role": "scheduler", "root_host": "127.0.0.1", "root_port": port,
           "num_workers": num_workers, "num_servers": 0}
    t = threading.Thread(target=run_scheduler, args=(cfg,), daemon=True)
    t.start()
    return cfg, t


def _members(cfg, *names, **kw):
    from mxnet_tpu_torch.parallel.dist_kvstore import MembershipClient
    return [MembershipClient(n, cfg=cfg, heartbeat_ms=50, **kw).start()
            for n in names]


def test_membership_join_progress_closing():
    cfg, sched = _scheduler(_free_port())
    a, b = _members(cfg, "A", "B", capacity=2)
    try:
        v = a.wait_for(lambda v: len(v["members"]) == 2, timeout=30)
        assert v is not None and v["epoch"] == 2
        assert v["members"]["B"]["capacity"] == 2
        b.set_progress(7)
        b.beat_now()
        assert a.wait_for(lambda v: v["members"].get("B", {})
                          .get("progress") == 7, timeout=30) is not None
        e0 = a.epoch
        b.leave()
        v = a.wait_epoch_above(e0, timeout=30)
        assert v is not None and "B" not in v["members"]
        assert not v["closing"] and not a.expelled
        a.leave(final=True)
        sched.join(timeout=30)
        assert not sched.is_alive()
    finally:
        a.close()
        b.close()


def test_membership_connection_loss_bumps_epoch():
    cfg, sched = _scheduler(_free_port())
    a, b = _members(cfg, "A", "B")
    try:
        assert a.wait_for(lambda v: len(v["members"]) == 2, 30) is not None
        e0 = a.epoch
        b._stop.set()
        b._sock.close()
        v = a.wait_epoch_above(e0, timeout=30)
        assert v is not None and "B" not in v["members"]
        a.leave(final=True)
        sched.join(timeout=30)
        assert not sched.is_alive()
    finally:
        a.close()
        b.close()


def test_membership_expiry_fences_partitioned_member(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_ELASTIC_EXPIRY_MS", "400")
    cfg, sched = _scheduler(_free_port())
    a, b = _members(cfg, "A", "B")
    try:
        assert a.wait_for(lambda v: len(v["members"]) == 2, 30) is not None
        e0 = a.epoch
        b.pause_beats(1.0)
        v = a.wait_epoch_above(e0, timeout=30)
        assert v is not None and "B" not in v["members"]
        assert b.wait_for(lambda v: b.expelled, timeout=30) is not None
        assert not a.expelled
        a.leave(final=True)
        sched.join(timeout=30)
    finally:
        a.close()
        b.close()


def test_membership_mdead_verdict():
    cfg, sched = _scheduler(_free_port())
    a, b = _members(cfg, "A", "B")
    try:
        assert a.wait_for(lambda v: len(v["members"]) == 2, 30) is not None
        e0 = a.epoch
        a.report_dead("B", reason="watchdog-death")
        v = a.wait_epoch_above(e0, timeout=30)
        assert v is not None and "B" not in v["members"]
        assert b.wait_for(lambda v: b.expelled, timeout=30) is not None
        a.leave(final=True)
        sched.join(timeout=30)
    finally:
        a.close()
        b.close()


def test_connect_deadline_and_retry_counter():
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel.dist_kvstore import _connect
    before = telemetry.counter("dist.connect_retries").value()
    with pytest.raises(MXNetError, match="cannot reach"):
        _connect("127.0.0.1", _free_port(), timeout_ms=400)
    assert telemetry.counter("dist.connect_retries").value() > before


def test_rpc_retries_transient_drop():
    """A server that drops the connection mid-exchange once: ``_rpc``
    reconnects and the retried request gets its reply."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel.dist_kvstore import (DistKVStore, _connect,
                                                       _recv, _send)
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(2)
    port = lsock.getsockname()[1]

    def server():
        c1, _ = lsock.accept()
        _recv(c1)
        c1.close()
        c2, _ = lsock.accept()
        _recv(c2)
        _send(c2, ("ok", "pong"))
        c2.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    kv = DistKVStore.__new__(DistKVStore)
    kv._sock_locks = {0: threading.Lock()}
    kv._server_addrs = {0: ("127.0.0.1", port)}
    kv._server_socks = {0: _connect("127.0.0.1", port)}
    before = telemetry.counter("dist.rpc_retries").value()
    try:
        assert kv._rpc(0, ("ping",)) == ("ok", "pong")
        assert telemetry.counter("dist.rpc_retries").value() == before + 1
    finally:
        kv._server_socks[0].close()
        lsock.close()
        t.join(timeout=30)


# ---------------------------------------------------------------------------
# launched clusters
# ---------------------------------------------------------------------------

def _launch(kind, tmp_path, workers=2, servers=2):
    from mxnet_tpu_torch.parallel.launch import launch_local
    env = {"KV_TEST_OUT": str(tmp_path),
           "MXNET_KVSTORE_BIGARRAY_BOUND": BOUND, "PYTHONPATH": _ROOT}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        codes = launch_local([sys.executable, os.path.abspath(__file__),
                              kind], num_workers=workers,
                             num_servers=servers, root_port=_free_port(),
                             timeout=240, return_codes=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert codes == [0] * workers, codes
    return [json.loads((tmp_path / f"worker_{r}.json").read_text())
            for r in range(workers)]


def test_dist_sync_aggregation_and_fit(tmp_path):
    """``dist_sync`` over 2 servers: the striped key and the small key
    bitwise the closed form on both workers (checked in the workers),
    then the MLP through ``FeedForward.fit`` and through ``Module.fit``
    above 0.9 on every worker, with bitwise equal parameters (both
    pulled them from the servers)."""
    res = _launch("dist_sync", tmp_path)
    assert sorted(r["rank"] for r in res) == [0, 1]
    for r in res:
        assert min(r["acc"]) > 0.9, res
    for what in ("mlp", "mod"):
        p0, p1 = (np.load(tmp_path / f"{what}_{r}.npz") for r in (0, 1))
        assert sorted(p0.files) == ["fc1_bias", "fc1_weight", "fc2_bias",
                                    "fc2_weight"]
        for n in p0.files:
            assert p0[n].tobytes() == p1[n].tobytes(), (what, n)


def test_dist_async_applies_every_push_once(tmp_path):
    """``dist_async``: the servers apply each push as it comes; after a
    barrier every worker pulls the closed form, which counts
    ``NREPEAT`` updates of each worker on each key, striped key
    included."""
    res = _launch("dist_async", tmp_path)
    assert sorted(r["rank"] for r in res) == [0, 1]


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
