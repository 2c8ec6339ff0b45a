"""The telemetry plane of the PyTorch port (mxnet_tpu_torch/telemetry)
against the JAX package's, on the CPU.

* The same call sequence gives equal ``snapshot_flat()``, equal
  structured snapshots (histogram buckets, labels, help strings), equal
  ``delta`` arithmetic and equal derived gauges in both packages, each on
  its own registry.
* A trace the port exports passes the JAX package's
  ``telemetry.tracing.validate`` and carries the keys of a JAX export of
  the same spans; a port flight dump parses with the JAX dump's keys and
  its trace tail validates too; the metrics JSONL rows carry the same
  keys.
* The environment knobs (``MXNET_TPU_METRICS_FILE``,
  ``MXNET_TPU_TRACE``, ``MXNET_TPU_FLIGHTREC``) are read once at first
  use, as in the JAX package.
"""
import json
import threading

import numpy as np
import pytest

from mxnet_tpu import telemetry as jtel
from mxnet_tpu_torch import telemetry as ttel

PKGS = [jtel, ttel]
_IDS = ["jax", "torch"]


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    for t in PKGS:
        t.reset_for_tests()
    yield
    for t in PKGS:
        t.reset_for_tests()


def _registry_sequence(tel):
    """One fixed sequence of metric calls on a fresh ``Registry``."""
    r = tel.Registry()
    r.counter("ev", "events").inc()
    r.counter("ev").inc(3, kind="late")
    r.counter("ev").inc(2, kind="late")
    r.counter("ev").inc(kind="early", replica=1)
    r.gauge("depth").set(7.5)
    r.gauge("depth").set(2, replica=0)
    r.gauge("untouched", "only labelled").set(4.0, a="b")
    h = r.histogram("lat_ms", "latency")
    rng = np.random.RandomState(0)
    values = list(rng.lognormal(2.0, 2.0, 200)) + list(tel.DEFAULT_BUCKETS)
    for v in values:
        h.observe(float(v))
    for v in (0.05, 3.0, 30000.0):
        h.observe(v, reason="x")
    r.histogram("custom", buckets=(1.0, 2.0)).observe(1.5)
    return r


def test_registry_snapshots_equal_jax():
    rj, rt = (_registry_sequence(t) for t in PKGS)
    assert rt.flat() == rj.flat()
    assert rt.snapshot() == rj.snapshot()
    snap = rt.snapshot()
    buckets = snap["lat_ms"]["series"][0]["buckets"]
    assert sum(buckets.values()) == 200 + len(ttel.DEFAULT_BUCKETS)
    assert snap["ev"]["help"] == "events"
    assert {tuple(s["labels"].items()) for s in snap["ev"]["series"]} == {
        (), (("kind", "late"),), (("kind", "early"), ("replica", "1"))}
    assert rt.flat()["ev{kind=late}"] == 5
    assert rt.get_value("ev", kind="late") == rj.get_value("ev", kind="late")
    assert rt.get_value("never") is None
    assert rt.counters_with_prefix("e") == rj.counters_with_prefix("e")
    for r in (rj, rt):
        with pytest.raises(TypeError):
            r.gauge("ev")            # kind collision is an error
        r.reset("dep", kinds=("counter",))
        assert "depth" in r.flat()   # gauges survive a counter sweep
        r.reset("dep")
        assert "depth" not in r.flat()
    assert rt.flat() == rj.flat()


def test_delta_equal_jax():
    out = []
    for tel in PKGS:
        r = tel.Registry()
        c = r.counter("step.count")
        h = r.histogram("step.ms")
        c.inc(5)
        h.observe(10.0)
        before = r.flat()
        for _ in range(10):
            c.inc()
        h.observe(30.0)
        d = tel.delta(r.flat(), before)
        assert d["step.count"] == 10.0 and d["step.ms.count"] == 1
        assert "step.ms.min" not in d          # unchanged keys drop out
        assert tel.delta(before, before) == {}
        out.append(d)
    assert out[0] == out[1]


def _module_sequence(tel):
    tel.counter("serve.shed").inc(reason="queue")
    tel.counter("serve.shed").inc(2, reason="kv")
    tel.gauge("serve.queue_depth").set(3)
    tel.histogram("serve.ttft_ms").observe(12.5)
    tel.set_program_costs(flops_per_step=2e9, hbm_bytes_per_step=1e9,
                          peak_flops_per_s=1e12)
    for ms in (4.0, 8.0, 2.0):
        tel.record_step({"step": 1, "host_ms": ms})
    tel.flight_recorder().record({"kind": "serve.shed", "req": 7})
    return tel.snapshot_flat(), tel.scrape()


def test_module_surface_equal_jax():
    (jflat, jscrape), (tflat, tscrape) = (_module_sequence(t) for t in PKGS)
    assert tflat == jflat
    assert tscrape == jscrape
    assert tflat["derived.mfu"] == pytest.approx(2e9 / 2e-3 / 1e12)
    assert tflat["step.count"] == 3
    assert ttel.flight_recorder().records() == jtel.flight_recorder(
    ).records()


def test_emitter_rows_carry_jax_keys(tmp_path):
    rows = []
    for tel, name in zip(PKGS, _IDS):
        path = str(tmp_path / f"{name}.jsonl")
        tel.configure(metrics_file=path, metrics_interval=0.001)
        tel.counter("t.ev").inc(2)
        tel.emit("event", {"event": "hello"})
        tel.record_step({"step": 1, "host_ms": 3.0})
        tel.flush_metrics()
        rows.append([json.loads(line) for line in open(path)])
    jrows, trows = rows
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["kind"] for r in trows] == [r["kind"] for r in jrows]
    assert [r for r in trows if r["kind"] == "metrics"][-1]["metrics"] == \
        [r for r in jrows if r["kind"] == "metrics"][-1]["metrics"]


def _trace_sequence(tel):
    with tel.span("serve.decode", step=1, bucket=4):
        with tel.span("serve.prefill", req=3):
            tel.annotate(extra="yes")
        with tel.span("serve.router.failover", req=3, to=1):
            pass

    def bg():
        tel.name_thread("client")
        with tel.span("client.stream"):
            pass

    t = threading.Thread(target=bg)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


def test_trace_export_validates_under_jax(tmp_path):
    docs = []
    for tel, name in zip(PKGS, _IDS):
        path = str(tmp_path / f"{name}.json")
        tel.configure(trace=path)
        assert tel.trace_enabled()
        _trace_sequence(tel)
        assert tel.export_trace() == path
        docs.append(json.load(open(path)))
    path = str(tmp_path / "torch.json")
    info = jtel.validate_trace(path)          # the JAX package's oracle
    assert info["span_names"] == {"serve.decode", "serve.prefill",
                                  "serve.router.failover", "client.stream"}
    assert "client" in info["tracks"].values()
    assert ttel.validate_trace(path) == info

    def shape(doc):
        return sorted((e["ph"], e["name"], tuple(sorted(e)),
                       tuple(sorted(e.get("args", {}))))
                      for e in doc["traceEvents"] if e["ph"] == "X")

    assert shape(docs[1]) == shape(docs[0])
    assert sorted(docs[1]) == sorted(docs[0])
    evs = docs[1]["traceEvents"]
    inner = next(e for e in evs if e.get("name") == "serve.prefill")
    outer = next(e for e in evs if e.get("name") == "serve.decode")
    assert inner["args"]["parent"] == outer["args"]["id"]
    assert inner["args"]["extra"] == "yes"


@pytest.mark.parametrize("tel", PKGS, ids=_IDS)
def test_trace_validate_rejects_overlap(tel, tmp_path):
    bad = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1,
         "args": {"id": 1}},
        {"name": "b", "ph": "X", "ts": 5, "dur": 10, "pid": 1, "tid": 1,
         "args": {"id": 2}}]}
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="overlap"):
        tel.validate_trace(str(p))


def test_span_disabled_is_shared_null():
    s1 = ttel.span("x")
    assert s1 is ttel.span("y", a=1)          # no allocation when off
    with s1:
        ttel.annotate(b=2)                    # no-op, must not raise


def test_flight_dump_parses_with_jax_keys(tmp_path):
    docs = []
    for tel, name in zip(PKGS, _IDS):
        # reset_for_tests keeps the ring's capacity, so pin it here
        tel.configure(trace=str(tmp_path / f"{name}-trace.json"),
                      flightrec_capacity=256)
        _trace_sequence(tel)
        tel.counter("serve.router.deaths").inc(cause="crash")
        tel.flight_recorder().record({"kind": "serve", "step": 4})
        path = str(tmp_path / f"{name}-dump.json")
        assert tel.dump_flight("serve-replica-death", path=path,
                               extra={"replica": 0}) == path
        docs.append(json.load(open(path)))
    jdoc, tdoc = docs
    assert sorted(tdoc) == sorted(jdoc) == sorted(
        ["reason", "time", "pid", "capacity", "records", "metrics",
         "trace_tail", "extra"])
    for key in ("reason", "capacity", "records", "metrics", "extra"):
        assert tdoc[key] == jdoc[key]
    # the tail holds span events as recorded; export adds the pid
    tail = tmp_path / "tail.json"
    tail.write_text(json.dumps({"traceEvents": [
        dict(e, pid=tdoc["pid"]) for e in tdoc["trace_tail"]]}))
    assert jtel.validate_trace(str(tail))["span_names"] == {
        "serve.decode", "serve.prefill", "serve.router.failover",
        "client.stream"}
    assert tdoc["metrics"]["flight.dumps{reason=serve-replica-death}"] == 1


def test_flight_without_dump_dir_never_writes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ttel.record_step({"step": 1})
    assert ttel.dump_flight("test-reason") is None
    assert list(tmp_path.iterdir()) == []
    assert ttel.flight_recorder().records() == [{"step": 1}]


@pytest.mark.parametrize("tel", PKGS, ids=_IDS)
def test_env_knobs_read_at_first_use(tel, tmp_path, monkeypatch):
    mfile = tmp_path / "m.jsonl"
    monkeypatch.setenv("MXNET_TPU_METRICS_FILE", str(mfile))
    monkeypatch.setenv("MXNET_TPU_METRICS_INTERVAL", "0.001")
    monkeypatch.setenv("MXNET_TPU_TRACE", str(tmp_path / "t.json"))
    monkeypatch.setenv("MXNET_TPU_FLIGHTREC", f"{tmp_path / 'fr'}:4")
    tel.reset_for_tests()
    with tel.span("first"):                 # the first entry reads the env
        pass
    assert tel.trace_enabled()
    fr = tel.flight_recorder()
    assert fr.capacity == 4 and fr.dump_dir == str(tmp_path / "fr")
    for i in range(10):
        fr.record({"i": i})
    assert [r["i"] for r in fr.records()] == [6, 7, 8, 9]
    out = tel.dump_flight("env")
    assert out is not None and out.startswith(str(tmp_path / "fr"))
    assert mfile.exists()
    monkeypatch.setenv("MXNET_TPU_FLIGHTREC", "off")
    tel.reset_for_tests()
    tel.snapshot_flat()
    assert tel.flight_recorder().dump_dir is None
