"""The collective tier's heartbeat watchdog of the PyTorch port
(``parallel/watchdog.py``, ``init_distributed(watchdog=True)``) against
the JAX package's, after ``tests/test_watchdog.py``.

* The wire is the JAX module's: the ``MXWD1`` magic, the beat byte and
  the 10-byte ``A``/``K`` frames, held here byte for byte.
* Three processes of the port's :class:`Watchdog` (this file as the
  program: ``python tests/test_torch_watchdog.py wd ...``) form a
  heartbeat mesh and one dies silently:
  - a worker dies: the rank-0 monitor declares it dead and broadcasts the
    abort; every survivor's ``on_failure`` writes who died (also with the
    JAX package's ``Watchdog`` as the monitor and the port's as peers:
    the two speak one wire);
  - the monitor (rank 0) dies: each survivor exhausts the reconnect
    window and declares rank 0 dead; with the default ``on_failure``
    each exits with code 70, after its ``on_death`` observer wrote who
    died.
  A peer starts its watchdog once the monitor is up, and a rank dies only
  once every rank reported its watchdog up, through files: no wall-clock
  wait decides an outcome.
* ``init_distributed(device="cpu", watchdog=True)`` over two gloo
  processes (``python tests/test_torch_watchdog.py init ...``) starts a
  watchdog on ``MXTPU_WATCHDOG``'s address (the JAX defaults: interval
  2 s, timeout 10 s), and with ``watchdog`` a dict of the watchdog's
  keyword arguments on the coordinator's port + 1; ``shutdown()`` stops
  it and both processes exit 0.

The children import torch and the port only (the JAX monitor's child
imports the JAX package).
"""
import json
import os
import socket
import struct
import subprocess
import sys
import time

import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

INTERVAL, TIMEOUT = 0.3, 1.2
WAIT = 90.0     # a child that outlives this has failed: it is killed


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_for(path, deadline):
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


# ---------------------------------------------------------------------------
# the children's program
# ---------------------------------------------------------------------------

def wd_child(rank, world, port, out, mode, impl, failure):
    """One watchdog process.  ``mode`` ``die``: exit silently once every
    rank's watchdog is up; ``work``: run until the watchdog aborts it.
    ``failure`` ``marker``: ``on_failure`` writes ``abort_<rank>.txt`` and
    exits 0; ``default``: the default ``on_failure`` (exit 70), whose log
    line names the dead rank, with an ``on_death`` observer that writes
    ``death_<rank>.txt`` where an abort frame arrives."""
    if impl == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from mxnet_tpu.parallel.watchdog import Watchdog
    else:
        from mxnet_tpu_torch.parallel.watchdog import Watchdog

    def write(name, text):
        tmp = os.path.join(out, name + ".tmp")
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, os.path.join(out, name))

    def on_failure(dead_rank):
        write(f"abort_{rank}.txt", str(dead_rank))
        os._exit(0)

    kw = {}
    if failure == "marker":
        kw["on_failure"] = on_failure
    else:
        kw["on_death"] = lambda d: write(f"death_{rank}.txt", str(d))
        import logging
        logging.basicConfig(level=logging.ERROR)
    deadline = time.monotonic() + WAIT
    # the monitor is up before any peer dials it
    if rank and not _wait_for(os.path.join(out, "ready_0"), deadline):
        return 3
    wd = Watchdog(rank=rank, world=world, monitor_addr=("127.0.0.1", port),
                  interval=INTERVAL, timeout=TIMEOUT, **kw)
    wd.start()
    write(f"ready_{rank}", "")
    if mode == "die":
        for r in range(world):
            if not _wait_for(os.path.join(out, f"ready_{r}"), deadline):
                return 3
        os._exit(1)  # silent death, no goodbye
    while time.monotonic() < deadline:
        time.sleep(0.05)
    write(f"timeout_{rank}.txt", "no abort")
    return 2


def init_child(out):
    """A rank of a two-process gloo group joined with the watchdog on
    (``watchdog=True`` under ``MXTPU_WATCHDOG``, else the watchdog's
    keyword arguments): writes where its watchdog dialed, then leaves in
    order."""
    from mxnet_tpu_torch.parallel import dist
    dist.init_distributed(device="cpu", watchdog=(
        True if os.environ.get("MXTPU_WATCHDOG")
        else {"interval": INTERVAL, "timeout": TIMEOUT}))
    wd = dist._watchdog
    rank = dist.process_index()
    res = {"rank": rank, "world": wd.world, "wd_rank": wd.rank,
           "addr": list(wd.monitor_addr), "monitor": wd._server is not None,
           "threads": sum(t.is_alive() for t in wd._threads),
           "interval": wd.interval, "timeout": wd.timeout}
    dist.shutdown()
    res["stopped"] = dist._watchdog is None and wd._stop.is_set()
    with open(os.path.join(out, f"init_{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_wire_frames_match_jax():
    from mxnet_tpu.parallel import watchdog as jwd
    from mxnet_tpu_torch.parallel import watchdog as twd
    assert (twd._MAGIC, twd._ACK) == (jwd._MAGIC, jwd._ACK) == (b"MXWD1",
                                                                 b"K")
    hello = twd._MAGIC + struct.pack("<i", 3)
    abort = twd._MAGIC + b"A" + struct.pack("<i", 2)
    assert len(hello) == 9 and len(abort) == 10
    assert twd.Watchdog(1, 3, ("127.0.0.1", 1)).timeout == \
        jwd.Watchdog(1, 3, ("127.0.0.1", 1)).timeout == 10.0


# ---------------------------------------------------------------------------
# three processes
# ---------------------------------------------------------------------------

def _run_mesh(tmp_path, modes, impls=("port",) * 3, failure="marker"):
    """Start the ranks (each peer starts its watchdog once rank 0's
    monitor is up) and wait for every child (killed past ``WAIT``).
    Returns the exit codes and the children's stderr."""
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "wd", str(rank),
         str(len(modes)), str(port), str(tmp_path), mode, impl, failure],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for rank, (mode, impl) in enumerate(zip(modes, impls))]
    deadline = time.monotonic() + WAIT
    codes, errs = [], []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            codes.append(p.returncode)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return codes, errs


@pytest.mark.parametrize("monitor", ["port", "jax"])
def test_watchdog_aborts_survivors_on_peer_death(tmp_path, monitor):
    """Rank 2 dies silently; ranks 0 and 1 are aborted by the watchdog,
    each recording that rank 2 died.  With ``monitor="jax"`` rank 0 runs
    the JAX package's ``Watchdog`` and ranks 1 and 2 the port's."""
    codes, errs = _run_mesh(tmp_path, ["work", "work", "die"],
                            impls=(monitor, "port", "port"))
    assert codes == [0, 0, 1], (codes, errs)
    for rank in (0, 1):
        marker = tmp_path / f"abort_{rank}.txt"
        assert marker.exists(), (rank, errs)
        assert marker.read_text() == "2"
        assert not (tmp_path / f"timeout_{rank}.txt").exists()


@pytest.mark.parametrize("failure", ["marker", "default"])
def test_watchdog_survivors_detect_monitor_death(tmp_path, failure):
    """Rank 0 (the monitor) dies: after the reconnect window each
    survivor declares rank 0 dead.  ``default``: the default
    ``on_failure`` logs the verdict and exits 70."""
    codes, errs = _run_mesh(tmp_path, ["die", "work", "work"],
                            failure=failure)
    want = 0 if failure == "marker" else 70
    assert codes == [1, want, want], (codes, errs)
    for rank in (1, 2):
        assert not (tmp_path / f"timeout_{rank}.txt").exists()
        if failure == "marker":
            assert (tmp_path / f"abort_{rank}.txt").read_text() == "0"
        else:
            assert "declaring rank 0 dead" in errs[rank], errs[rank]
            assert "peer rank 0 declared DEAD" in errs[rank], errs[rank]


# ---------------------------------------------------------------------------
# init_distributed(watchdog=True) over two gloo processes
# ---------------------------------------------------------------------------

def _two_free_ports():
    """A port whose successor is free too (the watchdog's default)."""
    for _ in range(50):
        port = _free_port()
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
        finally:
            s.close()
    raise RuntimeError("no two consecutive free ports")


@pytest.mark.parametrize("where", ["MXTPU_WATCHDOG", "coordinator+1"])
def test_init_distributed_starts_the_watchdog(tmp_path, where):
    port = _two_free_ports()
    wd_port = _free_port() if where == "MXTPU_WATCHDOG" else port + 1
    env = dict(os.environ, PYTHONPATH=_ROOT,
               MXTPU_COORDINATOR=f"127.0.0.1:{port}", MXTPU_NUM_PROC="2")
    env.pop("MXTPU_WATCHDOG", None)
    if where == "MXTPU_WATCHDOG":
        env["MXTPU_WATCHDOG"] = f"127.0.0.1:{wd_port}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "init", str(tmp_path)],
        env=dict(env, MXTPU_PROC_ID=str(rank)), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    codes, errs = [], []
    try:
        for p in procs:
            _, err = p.communicate(timeout=WAIT)
            codes.append(p.returncode)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert codes == [0, 0], errs
    res = [json.loads((tmp_path / f"init_{r}.json").read_text())
           for r in range(2)]
    for r, got in enumerate(res):
        assert got["addr"] == ["127.0.0.1", wd_port]
        assert (got["rank"], got["wd_rank"], got["world"]) == (r, r, 2)
        assert got["monitor"] == (r == 0)   # rank 0 runs the monitor
        assert got["threads"] >= 1 and got["stopped"]
        assert (got["interval"], got["timeout"]) == (
            (2.0, 10.0) if where == "MXTPU_WATCHDOG" else (INTERVAL, TIMEOUT))


if __name__ == "__main__":
    if sys.argv[1] == "wd":
        sys.exit(wd_child(int(sys.argv[2]), int(sys.argv[3]),
                          int(sys.argv[4]), sys.argv[5], sys.argv[6],
                          sys.argv[7], sys.argv[8]))
    sys.exit(init_child(sys.argv[2]))
