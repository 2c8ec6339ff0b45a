"""The profiler of the PyTorch port (mxnet_tpu_torch/profiler.py) against
the JAX package's, on the CPU.

* ``trace`` writes a Chrome trace that names an annotated region, and the
  start/stop errors are the JAX module's;
* the compile-event log, its report and the event counters equal the JAX
  module's for the same events;
* ``profile_step`` returns the JAX keys with their invariants
  (``host_gap_ms >= 0``, ``step_ms = device_ms + host_gap_ms``) on the
  port's trainer, replayed or eager, and ``format_step_profile`` renders a
  profile as the JAX function does.
"""
import glob
import json

import numpy as np
import pytest

from mxnet_tpu import profiler as jprof
from mxnet_tpu import telemetry as jtel

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import ShardedTrainer

KEYS = {"place_ms", "dispatch_ms", "device_ms", "fetch_ms", "host_gap_ms",
        "step_ms"}


@pytest.fixture(autouse=True)
def _fresh():
    for t in (jtel, ttel):
        t.reset_for_tests()
    for p in (jprof, tprof):
        p.reset_compile_events()
    yield
    for t in (jtel, ttel):
        t.reset_for_tests()
    for p in (jprof, tprof):
        p.reset_compile_events()


def test_public_names_equal_jax():
    assert tprof.__all__ == jprof.__all__


def test_trace_names_an_annotated_region(tmp_path):
    import torch
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("mxt-region"):
            torch.ones(64).sum()
    files = glob.glob(str(tmp_path / "trace.*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "mxt-region" in names


def test_start_stop_errors(tmp_path):
    with pytest.raises(MXNetError, match="not running"):
        tprof.stop()
    tprof.start(str(tmp_path))
    try:
        with pytest.raises(MXNetError, match="already running"):
            tprof.start(str(tmp_path))
    finally:
        assert tprof.stop() == str(tmp_path)
    with pytest.raises(MXNetError, match="not running"):
        tprof.stop()


EVENTS = [("trainer.train", 1.25, "capture"), ("serve.decode.8", 0.5,
                                                 "eager"),
          ("trainer.train", 0.001, "memory")]


def test_compile_events_and_report_equal_jax():
    for p in (jprof, tprof):
        for label, sec, src in EVENTS:
            p.record_compile(label, sec, source=src, digest="d" + label)
    assert tprof.compile_events() == jprof.compile_events()
    assert tprof.format_compile_report("t") == \
        jprof.format_compile_report("t")
    for t in (jtel, ttel):
        assert t.registry().get_value("compile.events",
                                      source="memory") == 1
    assert ttel.registry().get_value("compile.seconds") == \
        pytest.approx(1.751)
    assert tprof.format_compile_report("empty").startswith(
        "compile report [empty]")


def test_counters_equal_jax():
    for p in (jprof, tprof):
        p.bump("io.prefetch_retries")
        p.bump("io.prefetch_retries", 2)
        p.bump("resilience.skipped")
    for name in ("io.prefetch_retries", "resilience.skipped", "absent"):
        assert tprof.counter(name) == jprof.counter(name)
    assert tprof.counters("io.") == jprof.counters("io.") == {
        "io.prefetch_retries": 3}
    for p in (jprof, tprof):
        p.reset_counters("io.")
    assert tprof.counters() == jprof.counters()


def _trainer():
    S = mxt.symbol
    with mxt.name.NameManager():
        net = S.FullyConnected(data=S.Variable("data"), num_hidden=16,
                               name="fc1")
        net = S.Activation(data=net, act_type="relu")
        net = S.FullyConnected(data=net, num_hidden=4, name="fc2")
        sym = S.SoftmaxOutput(data=net, name="softmax")
    tr = ShardedTrainer(sym, "sgd", {"learning_rate": 0.1}, device="cpu")
    tr.bind({"data": (8, 6)}, {"softmax_label": (8,)})
    return tr


def _feeds(n=2):
    rng = np.random.RandomState(0)
    return [{"data": rng.rand(8, 6).astype(np.float32),
             "softmax_label": rng.randint(0, 4, 8).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["eager", "compiled"])
def test_profile_step_keys_and_invariants(compiled):
    tr = _trainer()
    if compiled:
        tr.compile()
    steps, repeats = 2, 1
    prof = tprof.profile_step(tr, _feeds(), steps=steps, repeats=repeats)
    assert set(prof) == KEYS
    assert all(isinstance(v, float) for v in prof.values())
    assert prof["host_gap_ms"] >= 0.0
    assert prof["host_gap_ms"] == max(
        0.0, prof["place_ms"] + prof["dispatch_ms"] - prof["device_ms"])
    assert prof["step_ms"] == prof["device_ms"] + prof["host_gap_ms"]
    assert prof["place_ms"] > 0 and prof["dispatch_ms"] > 0
    assert prof["fetch_ms"] >= 0
    assert tr._num_update == 2 + steps * (1 + 4 * repeats)
    assert tr.aot_stats["hits"] == (tr._num_update if compiled else 0)


def test_format_step_profile_equals_jax():
    prof = {"place_ms": 0.5, "dispatch_ms": 1.25, "device_ms": 3.0,
            "fetch_ms": 0.125, "host_gap_ms": 0.0, "step_ms": 3.0}
    assert tprof.format_step_profile(prof, "x") == \
        jprof.format_step_profile(prof, "x")
