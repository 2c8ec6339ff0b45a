#!/usr/bin/env python
"""Launch a distributed mxnet_tpu_torch job (the PyTorch port's twin of
``tools/launch.py``, with the same arguments and exit codes).

Example (4 workers, 2 servers, all on localhost)::

    python tools/torch_launch.py -n 4 -s 2 --launcher local \
        python train.py --kv-store dist_sync

Every spawned process runs the same command; role env vars make
``kvstore.create('dist*')`` act as scheduler/server/worker, and
``parallel.dist_kvstore.MembershipClient`` join the scheduler's
membership views.  The ``ssh`` launcher runs each role on a host of the
hostfile through ``--ssh-bin``.  The collective tier
(``mxnet_tpu_torch.parallel.dist``) needs no launcher.  Imports the port
only.
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from mxnet_tpu_torch.parallel.launch import submit  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=1)
    ap.add_argument("--launcher", default="local", choices=["local", "ssh"])
    ap.add_argument("-H", "--hostfile", default=None,
                    help="one host per line (ssh launcher)")
    ap.add_argument("--ssh-bin", default="ssh")
    ap.add_argument("--root-uri", default="127.0.0.1")
    ap.add_argument("--root-port", type=int, default=9091)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    if not args.command:
        ap.error("no command given")
    sys.exit(submit(args))


if __name__ == "__main__":
    main()
