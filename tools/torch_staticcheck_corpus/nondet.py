"""Seeded corpus: nondeterminism frozen into a captured program
(source.nondet): it runs once, at capture, and every replay reuses it.

Lint-only — this module is never imported, it only has to parse.
"""
import random
import time

import numpy as np
import torch

from mxnet_tpu_torch.compile_cache import CapturedProgram


def stamp(x):
    return x + time.time()                      # BAD: source.nondet


def noisy(x):
    noise = np.random.randn(4, 4)               # BAD: source.nondet
    return x + torch.from_numpy(noise)


def build(x, dev):
    progs = [CapturedProgram("stamp", stamp, dev),
             CapturedProgram("noisy", noisy, dev)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x * random.random()                 # BAD: source.nondet
    return progs, y
