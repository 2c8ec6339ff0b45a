"""Seeded-bad step programs of the port's program corpus.

Loaded by file path by ``tools/torch_staticcheck.py gate`` and
``tests/test_torch_program_audit.py``.  Each builder records one run of
a tiny torch step with one deliberate hazard on the CPU and returns
``(trace, audit_kwargs)`` for
:func:`mxnet_tpu_torch.analysis.program.audit_traced`; ``PROGRAMS`` maps
a builder's name to the rules that must fire on it (an empty list is a
negative control, on which nothing may fire).  The twin of
``tests/golden/staticcheck/bad_programs.py`` for every rule with a port
meaning (no ``donation_miss``: a captured graph donates nothing).

One difference by design: ``hbm_bytes_widened`` and
``hbm_bytes_quantized`` reduce over two CPU members (``cpu(0)``,
``cpu(1)``).  A reduction over one member returns its input unchanged
and leaves nothing on a wire; over a one-device mesh the JAX reference
likewise leaves no collective in its jaxpr (jax 0.9.0), so its quantized
negative control finds no reduction at all and fails.  With two members
the port's control means what it says: the reduction is there and its
payload is 1 byte wide.

Imports only torch, numpy and the port.
"""
import numpy as np
import torch

from mxnet_tpu_torch.analysis.program import record_program, tag
from mxnet_tpu_torch.ops.fused_update import fused_update
from mxnet_tpu_torch.parallel.collectives import psum, psum_compressed
from mxnet_tpu_torch.serve import kvcache
from mxnet_tpu_torch.serve.flash_decode import flash_decode_attention

DEV = "cpu"


def _record(name, step, inputs):
    return record_program(f"corpus.{name}", lambda: step(**inputs), DEV,
                          inputs=inputs)


def _rand(*shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


def carry_widen():
    """The widened metric carry in torch's spelling: an int32 carry
    accumulated with an unpinned bool sum, which torch promotes to int64,
    so the carry leaves wider than it entered."""
    def step(carry, pred, label):
        hits = (pred.to(torch.int32) == label.to(torch.int32)).sum()
        return carry + hits
    trace = _record("carry_widen", step, {
        "carry": torch.zeros((), dtype=torch.int32),
        "pred": _rand(16), "label": _rand(16, seed=1)})
    return trace, {"carry_pairs": [(0, 0, "metric carry")]}


def host_transfer():
    """``.item()`` inside the step: a read back to the host per call."""
    def step(x):
        y = torch.tanh(x)
        return y * y.sum().item()
    return _record("host_transfer", step, {"x": _rand(8)}), {}


_TABLE = torch.arange(65536, dtype=torch.float32)      # 256 KiB


def captured_const():
    """A large tensor the step closes over: a captured graph reads the
    address it had at capture time."""
    def step(idx):
        return _TABLE[idx]
    return _record("captured_const", step,
                   {"idx": torch.arange(4, dtype=torch.int64)}), {}


def clean():
    """Negative control: the gate fails if anything fires here."""
    def step(x, y):
        return x @ y
    return _record("clean", step, {"x": _rand(4, 4),
                                   "y": _rand(4, 4, seed=1)}), {}


def fused_regress():
    """The fused-update regression: a step that tags its flat bucket as
    fused but runs the multi-pass chain — the bucket is traversed for the
    rescale and again for the momentum update (not 1 read / 1 write)."""
    def step(g, w, m):
        g = tag(g, "gradbucket:0")
        g = g * 0.0625                  # pass 1: rescale sweep
        m2 = 0.9 * m - 0.1 * g          # pass 2: momentum sweep
        return w + m2, m2
    trace = _record("fused_regress", step, {
        "g": _rand(64), "w": _rand(64, seed=1), "m": _rand(64, seed=2)})
    return trace, {"expect_fused": True}


def fused_clean():
    """Negative control for ``expect_fused``: the tagged bucket feeds one
    fused-update kernel call, so the audit reports exactly 1 read / 1
    write and stays silent."""
    def step(g, w, m, lr):
        g = tag(g, "gradbucket:0")
        return fused_update(g, w, (m,), (lr,), kind="sgd_momentum",
                            momentum=0.9, rescale_grad=0.0625)
    trace = _record("fused_clean", step, {
        "g": _rand(64), "w": _rand(64, seed=1), "m": _rand(64, seed=2),
        "lr": torch.full((1,), 0.1)})
    return trace, {"expect_fused": True}


def _members():
    """One gradient a member of two CPU members (``cpu(0)``, ``cpu(1)``:
    contexts of the one host device), 512 floats each."""
    return {"g0": _rand(512), "g1": _rand(512, seed=1)}


def hbm_bytes_widened():
    """The re-widened reduction: a step configured for quantized gradient
    reduction whose bucket silently re-widened — the reduction's payload
    is full-width f32, 4x the contracted wire bytes."""
    def step(g0, g1):
        return psum([g0, g1])           # f32 on the wire
    return _record("hbm_bytes_widened", step, _members()), \
        {"expect_wire_itemsize": 1}


def hbm_bytes_quantized():
    """Negative control for ``expect_wire_itemsize``: the bucket rides the
    block-quantized fp8 reduction, so the narrowest same-shape value in
    the reduction's cone is the 1-byte payload and the audit stays
    silent."""
    def step(g0, g1):
        return psum_compressed([g0, g1], "fp8")
    return _record("hbm_bytes_quantized", step, _members()), \
        {"expect_wire_itemsize": 1}


def _decode_read(quant):
    """One layer's paged decode attention (the K5 wrapper; its plain
    version on the CPU) over a pool that is f32 or fp8-quantized."""
    nb, bs, h, hd, b, mb = 16, 8, 2, 16, 2, 4
    if quant:
        pool = kvcache.QuantPool(
            _rand(nb, bs, h, hd).to(torch.float8_e4m3fn),
            torch.ones(nb, bs))
    else:
        pool = _rand(nb, bs, h, hd)

    def step(q, kp, vp, tables, lengths):
        return flash_decode_attention(q, kp, vp, tables, lengths)
    return _record(f"decode_kv_{'quantized' if quant else 'widened'}",
                   step, {
                       "q": _rand(b, h, hd, seed=1), "kp": pool, "vp": pool,
                       "tables": torch.arange(b * mb, dtype=torch.int32)
                       .reshape(b, mb),
                       "lengths": torch.tensor([5, 27], dtype=torch.int32)})


def decode_kv_widened():
    """The re-widened KV read: an engine configured for fp8 KV pools
    whose decode step reads a full-width f32 pool — 4x the contracted KV
    bytes per token."""
    return _decode_read(quant=False), {"expect_kv_itemsize": 1}


def decode_kv_quantized():
    """Negative control for ``expect_kv_itemsize``: the pools' payload is
    1-byte e4m3 (the f32 scales are rank 2, outside the KV-read shape
    filter), so the audit stays silent."""
    return _decode_read(quant=True), {"expect_kv_itemsize": 1}


PROGRAMS = {
    "carry_widen": (carry_widen, ["program.carry-widen", "program.widen"]),
    "host_transfer": (host_transfer, ["program.host-transfer"]),
    "captured_const": (captured_const, ["program.captured-const"]),
    "clean": (clean, []),
    "fused_regress": (fused_regress, ["program.fused-update"]),
    "fused_clean": (fused_clean, []),
    "hbm_bytes_widened": (hbm_bytes_widened, ["program.hbm-bytes"]),
    "hbm_bytes_quantized": (hbm_bytes_quantized, []),
    "decode_kv_widened": (decode_kv_widened, ["program.hbm-bytes"]),
    "decode_kv_quantized": (decode_kv_quantized, []),
}
