"""Planted faults against the checks of ``chip_smoke.py`` phase 23 (c).

Runs phase 23 (c) (the LM and the BatchNorm net over a data mesh of 2
processes, against one process) on the card once for each named case, and
prints the numbers its checks read.  ``none`` runs this checkout as it
is; every other case copies the port and ``chip_smoke.py`` into a
temporary directory and plants one fault there:

* ``scale``: the cross-process gradient reduction scaled by 2 (a sum
  where a mean belongs);
* ``skip``: the cross-process gradient reduction left out (each process
  trains on its own rows);
* ``local``: the cross-process meetings see this process's values in
  place of the others' (batch moments and global heads stay local).

In a faulted copy a failed check is printed (``CHECK FAILED: ...``) and
the run goes on, so that every number is read.  A limit of phase 23 (c)
belongs between what ``none`` reads and what the faults read::

    python3 tools/torch_collective_faults.py none scale skip local

Needs a CUDA card; ``--two-cards`` runs the layout over two cards (NCCL)
in place of one card (gloo).
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REDUCE = ("tdist.all_reduce(piece, group=(None if ranks is None\n"
           "                                           else "
           "dist.subgroup(ranks)))")
_GATHER = "tdist.all_gather(bufs, flat.contiguous(), group=subgroup(ranks))"
FAULTS = {
    "scale": ("mxnet_tpu_torch/parallel/collectives.py", _REDUCE,
              _REDUCE + "\n            piece.mul_(2)"),
    "skip": ("mxnet_tpu_torch/parallel/collectives.py", _REDUCE, "pass"),
    "local": ("mxnet_tpu_torch/parallel/dist.py", _GATHER,
              _GATHER + "\n        bufs = [flat.clone() for _ in ranks]"),
}

# the phase itself, in a fresh interpreter over the tree at argv[1]
_RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as cs
if sys.argv[3] == "lenient":
    cs.check = lambda c, m: c or print("CHECK FAILED:", m, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _build
from mxnet_tpu_torch.ops import fused_update as fu, nn_ops
from mxnet_tpu_torch.parallel import flash_attention as fa
_build.build_all()
_, stats = cs.phase_multiprocess(torch, np, mx, nn_ops, fu, fa,
                                 parts=(sys.argv[2],))
print("RESULT " + json.dumps(stats["lm"]), flush=True)
"""


def plant(case, dst):
    shutil.copytree(os.path.join(ROOT, "mxnet_tpu_torch"),
                    os.path.join(dst, "mxnet_tpu_torch"), symlinks=True)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    path, old, new = FAULTS[case]
    path = os.path.join(dst, path)
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{case}: the line to change is not in {path}")
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def run(case, parts):
    with tempfile.TemporaryDirectory(prefix=f"fault-{case}-") as tmp:
        tree = ROOT
        if case != "none":
            plant(case, tmp)
            tree = tmp
        proc = subprocess.run(
            [sys.executable, "-c", _RUN, tree, parts,
             "strict" if case == "none" else "lenient"],
            capture_output=True, text=True, timeout=900)
    failed = [ln[len("CHECK FAILED: "):] for ln in proc.stdout.splitlines()
              if ln.startswith("CHECK FAILED")]
    result = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("RESULT ")]
    if proc.returncode or not result:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
        raise SystemExit(f"{case}: the run failed ({proc.returncode})")
    return {"case": case,
            "ranks_differ": sum(m.endswith(" differ") for m in failed),
            "failed": [m for m in failed if not m.endswith(" differ")],
            "lm": json.loads(result[0][len("RESULT "):])}


def main(argv):
    parts = "lm-two-cards" if "--two-cards" in argv else "lm"
    cases = [a for a in argv if not a.startswith("--")] or ["none"]
    for case in cases:
        if case != "none" and case not in FAULTS:
            raise SystemExit(f"unknown case {case}; cases: none, "
                             + ", ".join(FAULTS))
    for case in cases:
        print(json.dumps(run(case, parts)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
