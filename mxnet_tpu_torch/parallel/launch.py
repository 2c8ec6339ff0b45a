"""Cluster launcher (the reference's ``tools/launch.py``).

Counterpart of ``mxnet_tpu/parallel/launch.py``, with the same functions
and environment (``MXTPU_ROLE``, ``MXTPU_PS_ROOT_URI``,
``MXTPU_PS_ROOT_PORT``, ``MXTPU_NUM_WORKER``, ``MXTPU_NUM_SERVER``,
``MXTPU_WORKER_ID``):

* ``launch_local`` starts 1 scheduler, N servers and W workers of one
  command on this host, each a fresh interpreter (``subprocess``, never a
  fork of a process that may have touched the card);
* ``launch_ssh`` runs the same roles on cluster hosts over ``ssh``
  (hostfile placement, round-robin), tagging each workload's ``argv[0]``
  with a job id so a ``pkill -f`` sweep reaps stragglers;
* the collective tier needs no launcher: :func:`mxnet_tpu_torch.parallel.
  dist.init_distributed` rendezvous replaces the scheduler.

Where the JAX launcher lets a timed-out worker's ``TimeoutExpired``
through after a grace wait, the port's kills every child at once and
raises :class:`~mxnet_tpu_torch.base.MXNetError` naming the worker.
"""
from __future__ import annotations

import os
import shlex
import subprocess
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["launch_local", "launch_ssh", "submit"]


def _env_for(role: str, num_workers: int, num_servers: int,
             root_host: str, root_port: int) -> Dict[str, str]:
    env = dict(os.environ)
    env.update({
        "MXTPU_ROLE": role,
        "MXTPU_PS_ROOT_URI": root_host,
        "MXTPU_PS_ROOT_PORT": str(root_port),
        "MXTPU_NUM_WORKER": str(num_workers),
        "MXTPU_NUM_SERVER": str(num_servers),
    })
    return env


def launch_local(cmd: Sequence[str], num_workers: int, num_servers: int = 1,
                 root_port: int = 9091,
                 worker_env: Optional[Dict[str, str]] = None,
                 timeout: Optional[float] = None,
                 return_codes: bool = False):
    """Fork 1 scheduler + N servers + W workers of ``cmd`` on localhost.

    Server/scheduler processes run the SAME command: their
    ``kvstore.create('dist*')`` call becomes the blocking server loop
    (reference ``kvstore_server._init_kvstore_server_module``).  Returns
    the max worker exit code — or, with ``return_codes=True``, the full
    per-worker exit-code list (worker index order), which elastic chaos
    harnesses need: a deliberately killed worker's nonzero code must be
    attributable instead of masking the survivors' verdict.  ``timeout``
    (seconds, for all the workers together): past it every child is
    killed and :class:`MXNetError` names the worker that was still
    running.
    """
    root_host = "127.0.0.1"
    procs: List[subprocess.Popen] = []

    def spawn(role: str, extra: Optional[Dict[str, str]] = None):
        env = _env_for(role, num_workers, num_servers, root_host, root_port)
        if extra:
            env.update(extra)
        return subprocess.Popen(list(cmd), env=env)

    sched = spawn("scheduler")
    procs.append(sched)
    for _ in range(num_servers):
        procs.append(spawn("server"))
    workers = []
    for i in range(num_workers):
        w = spawn("worker", dict(worker_env or {}, MXTPU_WORKER_ID=str(i)))
        workers.append(w)
        procs.append(w)
    codes = []
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for i, w in enumerate(workers):
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            try:
                codes.append(w.wait(timeout=left))
            except subprocess.TimeoutExpired:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                raise MXNetError(
                    f"launch_local: worker {i} (pid {w.pid}) did not finish "
                    f"within {timeout} s; killed the scheduler, "
                    f"{num_servers} server(s) and {num_workers} worker(s)")
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    return codes if return_codes else max([0] + codes)


_SSH_OPTS = ("-o", "StrictHostKeyChecking=no", "-o", "BatchMode=yes")


def launch_ssh(cmd: Sequence[str], hosts: Sequence[str], num_workers: int,
               num_servers: int = 1, root_host: Optional[str] = None,
               root_port: int = 9091, ssh_bin: str = "ssh",
               root_uri: Optional[str] = None,
               timeout: Optional[float] = None) -> int:
    """Execute 1 scheduler + N servers + W workers of ``cmd`` over ssh.

    ``hosts`` come from a hostfile (one host per line); the scheduler runs
    on ``root_host`` (default ``hosts[0]``, which every host must be able
    to reach at ``root_port``), servers and workers are placed round-robin.
    Teardown reaps remote stragglers two ways (the reference's
    ``tools/kill-mxnet.py`` pattern): the workload's ``argv[0]`` is tagged
    with a unique job id (``exec -a 'mxtpu[<id>]'``) so a ``pkill -f``
    sweep can match it, and ssh runs with ``-tt`` so the remote shell gets
    SIGHUP when the local client is killed.  Returns the max worker exit
    code.
    """
    if not hosts:
        raise MXNetError("ssh launcher needs at least one host")
    root_host = root_host or hosts[0]
    # hostfile entries are ssh destinations (possibly user@host); the
    # rendezvous URI every process connects to must be a bare address —
    # an explicit root_uri wins, else strip the ssh user part
    root_uri = root_uri or root_host.rsplit("@", 1)[-1]
    job_id = uuid.uuid4().hex[:12]
    cwd = os.getcwd()
    procs: List[Tuple[str, subprocess.Popen]] = []

    def spawn(host: str, role: str, extra: Optional[Dict[str, str]] = None):
        env = {k: v for k, v in _env_for(
            role, num_workers, num_servers, root_uri, root_port).items()
            if k.startswith("MXTPU_")}
        env["MXTPU_JOB_ID"] = job_id
        env.update(extra or {})
        kv = " ".join(f"{k}={shlex.quote(v)}" for k, v in sorted(env.items()))
        # tag argv[0] of the workload with the job id: env vars are NOT in
        # /proc cmdline, so the pkill sweep below could never match them —
        # `exec -a` puts the tag where pkill -f looks
        tag = f"mxtpu[{job_id}]:{cmd[0]}"
        argv = " ".join(shlex.quote(c) for c in cmd)
        remote = (f"cd {shlex.quote(cwd)} 2>/dev/null; "
                  f"env {kv} bash -c 'exec -a \"$0\" \"$@\"' "
                  f"{shlex.quote(tag)} {argv}")
        p = subprocess.Popen([ssh_bin, "-tt", *_SSH_OPTS, host, remote],
                             stdin=subprocess.DEVNULL)
        procs.append((host, p))
        return p

    spawn(root_host, "scheduler")
    for i in range(num_servers):
        spawn(hosts[i % len(hosts)], "server")
    workers = [spawn(hosts[i % len(hosts)], "worker",
                     {"MXTPU_WORKER_ID": str(i)})
               for i in range(num_workers)]
    code = 0
    try:
        for w in workers:
            code = max(code, w.wait(timeout=timeout))
    finally:
        leftover_hosts = set()
        for host, p in procs:
            if p.poll() is None:
                leftover_hosts.add(host)
                p.kill()
        # killing the local ssh client does not reap the remote process;
        # sweep by the job-id tag baked into the workload's argv[0]
        for host in leftover_hosts:
            subprocess.run(
                [ssh_bin, *_SSH_OPTS, host, f"pkill -f {job_id} || true"],
                timeout=30, capture_output=True, check=False)
    return code


def _read_hostfile(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.strip().startswith("#")]


def submit(args) -> int:
    """CLI entry used by ``tools/launch.py``."""
    if args.launcher == "local":
        return launch_local(args.command, args.num_workers, args.num_servers,
                            root_port=args.root_port)
    if args.launcher == "ssh":
        if not getattr(args, "hostfile", None):
            raise MXNetError("ssh launcher requires --hostfile")
        return launch_ssh(args.command, _read_hostfile(args.hostfile),
                          args.num_workers, args.num_servers,
                          root_uri=(args.root_uri
                                    if args.root_uri != "127.0.0.1" else None),
                          root_port=args.root_port,
                          ssh_bin=getattr(args, "ssh_bin", "ssh"))
    raise MXNetError(f"unknown launcher {args.launcher!r} (local|ssh)")
