"""The launcher CLI of the PyTorch port (``tools/torch_launch.py``)
against ``tools/launch.py``, both run as subprocesses.

* ``--launcher ssh -H <hostfile>`` through a stand-in ``ssh`` that prints
  its arguments: the same lines (scheduler, servers round-robin, workers),
  up to the job id, and the same exit code.
* ``--launcher local``: the exit code is the workers' largest, and a
  command without arguments is refused, as by ``tools/launch.py``.
* ``--launcher local`` runs a two-worker ``dist_async`` job of
  ``tests/test_torch_dist_kvstore.py`` (2 servers) to exit 0, every pull
  the closed form.
"""
import json
import os
import socket
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
TOOLS = {"jax": os.path.join(_ROOT, "tools", "launch.py"),
         "port": os.path.join(_ROOT, "tools", "torch_launch.py")}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(tool, args, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **kw.pop("env", {}))
    return subprocess.run([sys.executable, TOOLS[tool], *args],
                          capture_output=True, text=True, timeout=180,
                          env=env, cwd=_ROOT, **kw)


def test_ssh_launcher_prints_the_same_lines(tmp_path):
    fake = tmp_path / "ssh"
    fake.write_text("#!/bin/sh\nprintf '%s\\n' \"$*\"\n")
    fake.chmod(0o755)
    hosts = tmp_path / "hosts"
    hosts.write_text("u@h1\n# a comment\nh2\n\n")
    args = ["-n", "3", "-s", "2", "--launcher", "ssh", "-H", str(hosts),
            "--ssh-bin", str(fake), "--root-port", "1234", "python",
            "train.py", "--x", "a b"]
    lines = {}
    for tool in TOOLS:
        proc = _run(tool, args)
        assert proc.returncode == 0, proc.stderr
        job = proc.stdout.split("MXTPU_JOB_ID=")[1].split()[0]
        lines[tool] = sorted(proc.stdout.replace(job, "<job>").splitlines())
    assert len(lines["port"]) == 6     # scheduler, 2 servers, 3 workers
    assert lines["port"] == lines["jax"]


def test_local_launcher_exit_codes_match(tmp_path):
    prog = ("import os, sys; sys.exit(3 if os.environ['MXTPU_ROLE'] == "
            "'worker' and os.environ['MXTPU_WORKER_ID'] == '1' else 0)")
    args = ["-n", "2", "-s", "0", "--root-port", str(_free_port()),
            sys.executable, "-c", prog]
    codes = {tool: _run(tool, args).returncode for tool in TOOLS}
    assert codes == {"jax": 3, "port": 3}, codes
    # no command: refused by the argument parser (exit 2), as by launch.py
    proc = _run("port", ["-n", "2"])
    assert proc.returncode == 2 and "no command given" in proc.stderr


def test_local_launcher_runs_a_dist_async_job(tmp_path):
    proc = _run("port", [
        "-n", "2", "-s", "2", "--launcher", "local", "--root-port",
        str(_free_port()), sys.executable,
        os.path.join(_HERE, "test_torch_dist_kvstore.py"), "dist_async"],
        env={"KV_TEST_OUT": str(tmp_path), "PYTHONPATH": _ROOT,
             "MXNET_KVSTORE_BIGARRAY_BOUND": "4096"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ranks = sorted(json.loads((tmp_path / f"worker_{r}.json").read_text())
                   ["rank"] for r in range(2))
    assert ranks == [0, 1]

