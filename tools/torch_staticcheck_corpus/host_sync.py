"""Seeded corpus: host syncs in code that runs under a CUDA-graph capture
(source.host-sync).

Lint-only — this module is never imported, it only has to parse.
"""
import numpy as np
import torch

from mxnet_tpu_torch.compile_cache import CapturedProgram


def step_with_item(params, batch):
    logits = params @ batch
    host = logits.item()                        # BAD: source.host-sync
    return logits * host


def scale_by_norm(g):
    norm = float((g * g).sum().sqrt())          # BAD: source.host-sync
    return g / norm


def np_on_captured(x):
    return np.sum(x)                            # BAD: source.host-sync


def ok_shape_math(x):
    # negative control: np on .shape metadata is static and fine
    return x.reshape((int(np.prod(x.shape)),))


def build(params, batch, g, x, dev):
    progs = [CapturedProgram("a", lambda: step_with_item(params, batch),
                             dev),
             CapturedProgram("b", body=lambda: scale_by_norm(g), device=dev),
             CapturedProgram("c", np_on_captured, dev),
             CapturedProgram("d", ok_shape_math, dev)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x * 2
        peek = y.cpu()                          # BAD: source.host-sync
        torch.cuda.synchronize()                # BAD: source.host-sync
        n = int(np.prod(y.shape))               # fine: shape math
    return progs, peek, n
