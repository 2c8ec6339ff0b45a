"""Seeded corpus: buffers read after being donated
(source.donated-mutation): a position of ``program_key``'s ``donate=``
set is a static buffer the program's replay overwrites.

Lint-only — this module is never imported, it only has to parse.
"""
from mxnet_tpu_torch.compile_cache import program_key


def update(fp, params, grads, replay):
    key = program_key(fp, (params, grads), donate=(0,))
    new = replay(key)
    print(params)                               # BAD: source.donated-mutation
    return new


def update_dict(fp, state, batch, replay):
    avals = {"state": state, "batch": batch}
    key = program_key(fp, avals, donate=(0, 1))
    out = replay(key)
    return out, batch                           # BAD: source.donated-mutation


def reuse_after_mark(arr):
    arr.mark_donated("step")
    return arr.sum()                            # BAD: source.donated-mutation


def rebind_clears(fp, params, fresh):
    key = program_key(fp, (params,), donate=(0,))
    params = fresh
    return key, params                          # fine: rebound
