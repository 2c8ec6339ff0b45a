"""Negative control of the port's lint corpus: every construct of the
seeded files, used correctly.  No rule may fire here.

Lint-only — this module is never imported, it only has to parse.
"""
import threading
import time

import torch

from mxnet_tpu_torch.compile_cache import CapturedProgram, program_key


def step(params, batch):
    # device work only: nothing is read back under the capture
    return torch.softmax(params @ batch, dim=-1), batch.shape[0]


def build(fp, params, batch, dev):
    t0 = time.perf_counter()                    # host time, outside
    prog = CapturedProgram("step", lambda: step(params, batch), dev)
    key = program_key(fp, (params, batch), donate=(0,))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = prog.body()
    return key, out, time.perf_counter() - t0


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0                   # shared: guarded_by=_lock

    def bump(self):
        with self._lock:
            self._n += 1


def spawn(items):
    batch = list(items)

    def worker():
        return len(batch)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    return t
