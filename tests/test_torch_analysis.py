"""The analysis tooling of the PyTorch port (``mxnet_tpu_torch.analysis``:
findings, the concurrency sanitizer, the schedule fuzzer, the source
linter; and ``mxnet_tpu_torch.visualization``) against the JAX package's
modules, in one process, on the CPU.

Every comparison feeds the same inputs to both packages, and the
expected result is equality unless a case says otherwise:

* findings: each rule id's severity (and its description, where the rule
  has no port meaning), the inline and CLI suppression functions, and a
  report's serialized form;
* the sanitizer: ``analyze_events`` over the same synthetic event lists
  (equal findings and metrics), ``ScheduleFuzzer(seed)`` over the same
  boundary sequence (equal decisions), each case of the seeded threads
  corpus under both ``audit_threads`` (the same fired rules);
* the linter: both on ``bad_source/conc_unguarded.py`` and on snippets
  for the four plain-Python rules (equal ``(rule, line)`` sets), and each
  rule with a port meaning on a port snippet against the JAX linter on
  the same snippet with ``jax.jit`` in place of the capture (the same
  lines flagged);
* schedules: the port's host scenarios over 2 seeds on the CPU, and one
  serve scenario at one seed, whose greedy streams equal the JAX
  router's (sampled streams replay only within the port: the packages'
  random bits differ);
* visualization: ``print_summary``'s text and ``plot_network``'s
  ``Digraph.source`` equal for the same nets.

Within the port: its own lint is clean with a reason on every
suppression, its env catalogue covers exactly what it reads, the capture
block and sync rules fire, a window restores every patch, and the
framework's threads audit clean.
"""
import ast
import builtins
import json
import logging
import os
import queue
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import analysis as janalysis
from mxnet_tpu import random as jrandom
from mxnet_tpu import telemetry as jtel
from mxnet_tpu import visualization as jviz
from mxnet_tpu.analysis import findings as JF
from mxnet_tpu.analysis import schedules as jsched
from mxnet_tpu.analysis import source as JS

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import analysis as tanalysis
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch import visualization as tviz
from mxnet_tpu_torch.analysis import findings as TF
from mxnet_tpu_torch.analysis import schedules as tsched
from mxnet_tpu_torch.analysis import source as TS
from mxnet_tpu_torch.base import MXNetError

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO_ROOT, "tests", "golden", "staticcheck")

SITE_A = ("mxnet_tpu/a.py", 10)
SITE_B = ("mxnet_tpu/b.py", 20)


@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


@pytest.fixture(autouse=True)
def _keep_port_random_state():
    """Restore the port's global key sequence and device generators after
    the test, so the test files that run after this one in the same
    process draw what they would draw without it."""
    from mxnet_tpu_torch import random as port_random
    saved = dict(port_random._state)
    gens = {d: g.get_state() for d, g in port_random._generators.items()}
    yield
    port_random._state.update(saved)
    for d in list(port_random._generators):
        if d in gens:
            port_random._generators[d].set_state(gens[d])
        else:
            del port_random._generators[d]


@pytest.fixture
def _telemetry():
    """Both packages' telemetry singletons, reset around the test."""
    jtel.reset_for_tests()
    ttel.reset_for_tests()
    yield
    jtel.reset_for_tests()
    ttel.reset_for_tests()


# the rules whose description is the port's own (findings.py's docstring)
PORT_MEANING = {"source.host-sync", "source.nondet",
                "source.donated-mutation", "source.env-undocumented",
                "source.env-stale", "program.widen", "program.carry-widen",
                "program.captured-const", "program.host-transfer",
                "program.fused-update", "program.hbm-bytes"}

# the JAX auditor's ids with no port meaning: data only
RESERVED = {"program.donation-miss", "program.donation-alias",
            "program.carry-sharding"}


def _patched_globals():
    return (threading.Lock, threading.RLock, threading.Condition,
            threading.Event, threading.Thread, queue.Queue, time.sleep,
            builtins.open)


# ---------------------------------------------------------------------------
# Findings: schema, catalogue, suppressions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", sorted(JF.RULES))
def test_rule_catalogue_matches_jax(rule):
    """Same ids and severities; the same description unless the rule has
    a port meaning; the three auditor ids with no port meaning reserved."""
    assert set(TF.RULES) == set(JF.RULES)
    assert TF.SCHEMA_VERSION == JF.SCHEMA_VERSION == 1
    assert TF.RESERVED_RULES == RESERVED
    sev_j, desc_j = JF.RULES[rule]
    sev_t, desc_t = TF.RULES[rule]
    assert sev_t == sev_j
    if rule in PORT_MEANING:
        assert desc_t != desc_j
    else:
        assert desc_t == desc_j
    assert (rule in TF.RESERVED_RULES) == (rule in RESERVED)


_SUPPRESSION_SRC = [
    "x = 1  # staticcheck: disable=source.host-sync -- demo\n",
    "# staticcheck: disable=conc.*,source.nondet -- both\ny = 2\n",
    "def f(x):  # staticcheck: traced\n    return x\n",
    "a = 1\n# staticcheck: disable=source.env-stale\nb = 2\n"
    "c = 3  # staticcheck: disable=program.widen -- reserved id\n",
]


@pytest.mark.parametrize("src", _SUPPRESSION_SRC)
def test_inline_parsing_matches_jax(src):
    assert TF.parse_inline_suppressions(src) == \
        JF.parse_inline_suppressions(src)
    assert TF.traced_directive_lines(src) == JF.traced_directive_lines(src)


def _findings(F):
    return [F.Finding("source.nondet", "m1", path="pkg/a.py", line=3),
            F.Finding("conc.data-race", "m2", path="pkg/b.py", line=7,
                      severity="info"),
            F.Finding("program.widen", "m3", program="trainer.train"),
            F.Finding("source.env-stale", "m4", path="docs.md")]


_CLI_SPECS = [[], ["source.nondet"], ["conc.*:pkg/*"],
              ["*:trainer.*", "source.env-stale:other.md"]]


@pytest.mark.parametrize("specs", _CLI_SPECS)
def test_suppressions_and_report_match_jax(specs):
    inline = {3: (["source.*"], "why"), 7: (["conc.lock-order"], "")}
    out = []
    for F in (JF, TF):
        fs = _findings(F)
        F.apply_inline(fs, inline)
        F.apply_cli(fs, specs)
        rep = F.Report(mode="lint")
        rep.extend(fs)
        out.append((rep.to_dict(), rep.format_text(show_suppressed=True),
                    rep.clean, rep.counts()))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# The sanitizer's analysis, fuzzer and live window
# ---------------------------------------------------------------------------

_EVENT_STREAMS = {
    "unlocked_race": [("access", "t1", "loc", True, SITE_A),
                      ("access", "t2", "loc", True, SITE_B)],
    "common_lock": [("acquire", "t1", "L", SITE_A, False),
                    ("access", "t1", "loc", True, SITE_A),
                    ("release", "t1", "L", False),
                    ("acquire", "t2", "L", SITE_B, False),
                    ("access", "t2", "loc", True, SITE_B),
                    ("release", "t2", "L", False)],
    "event_publish": [("access", "t1", "loc", True, SITE_A),
                      ("send", "t1", ("ev", 1)),
                      ("recv", "t2", ("ev", 1)),
                      ("access", "t2", "loc", True, SITE_B)],
    "release_acquire_not_hb": [("acquire", "t1", "L", SITE_A, False),
                               ("access", "t1", "loc", True, SITE_A),
                               ("release", "t1", "L", False),
                               ("access", "t2", "loc", True, SITE_B)],
    "read_write": [("access", "t1", "loc", False, SITE_A),
                   ("access", "t2", "loc", True, SITE_B)],
    "lock_order": [("acquire", "t1", "A", SITE_A, False),
                   ("acquire", "t1", "B", SITE_A, False),
                   ("release", "t1", "B", False),
                   ("release", "t1", "A", False),
                   ("acquire", "t2", "B", SITE_B, False),
                   ("acquire", "t2", "A", SITE_B, False),
                   ("release", "t2", "A", False),
                   ("release", "t2", "B", False)],
    "reentrant": [("acquire", "t1", "A", SITE_A, False),
                  ("acquire", "t1", "A", SITE_A, True),
                  ("release", "t1", "A", False),
                  ("release", "t1", "A", False)],
    "blocking": [("acquire", "t1", "L", SITE_A, False),
                 ("block", "t1", "time.sleep", SITE_A, None),
                 ("block", "t1", "Condition.wait", SITE_B, "L"),
                 ("acquire", "t1", "<extern>#L0", SITE_A, False),
                 ("block", "t1", "open", SITE_B, None)],
}


@pytest.mark.parametrize("name", sorted(_EVENT_STREAMS))
@pytest.mark.parametrize("policies", [None, {"loc": "info"}])
def test_analyze_events_matches_jax(name, policies):
    out = []
    for A, F in ((janalysis, JF), (tanalysis, TF)):
        rep = F.Report(mode="races")
        A.analyze_events(list(_EVENT_STREAMS[name]), rep, policies=policies)
        out.append(rep.to_dict())
    assert out[0] == out[1]
    expect_rules = {"unlocked_race": ["conc.data-race"], "common_lock": [],
                    "event_publish": [],
                    "release_acquire_not_hb": ["conc.data-race"],
                    "read_write": ["conc.data-race"],
                    "lock_order": ["conc.lock-order"], "reentrant": [],
                    "blocking": ["conc.blocking-under-lock"] * 2}[name]
    assert [f["rule"] for f in out[1]["findings"]] == expect_rules


@pytest.mark.parametrize("seed", [0, 11, 12])
def test_fuzzer_decisions_match_jax(seed):
    """The same boundary sequence (120 boundaries on this thread) gives
    the same decisions: crc32 of seed, thread name and counter."""
    out = []
    for A in (janalysis, tanalysis):
        fz = A.ScheduleFuzzer(seed=seed, sleep_s=0.0)
        for _ in range(120):
            fz.maybe_preempt()
        out.append((fz.decisions, fz.preemptions))
    assert out[0] == out[1]
    assert 0 < out[1][1] < 120


def _load_threads_corpus():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "corpus_threads_port", os.path.join(CORPUS, "bad_threads.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


with open(os.path.join(CORPUS, "expected.json")) as _f:
    _THREAD_CASES = json.load(_f)["threads"]


@pytest.mark.parametrize("case", _THREAD_CASES, ids=lambda e: e["case"])
def test_threads_corpus_fires_the_same_rules(case):
    mod = _load_threads_corpus()
    fired = []
    for A in (janalysis, tanalysis):
        with A.audit_threads() as audit:
            mod.CASES[case["case"]](audit)
        fired.append(sorted({f.rule for f in audit.report.findings
                             if not f.suppressed}))
    assert fired[0] == fired[1]
    assert fired[1] == ([] if case.get("clean") else [case["rule"]])


def test_window_restores_every_patch(tmp_path, _telemetry):
    """A port window (framework instrumented, a fuzzed schedule run
    inside another) leaves threading, queue, time.sleep, open and the
    wrapped framework attributes as they were."""
    from mxnet_tpu_torch import compile_cache
    before = _patched_globals()
    fr, reg = ttel.flight_recorder(), ttel.registry()
    cache = compile_cache.get_cache()
    attrs = [(fr, "_lock"), (fr, "_ring"), (reg, "_lock"),
             (reg, "_metrics"), (cache, "_lock"), (cache, "_mem")]
    vals = [getattr(o, a) for o, a in attrs]
    with tanalysis.audit_threads(instrument_framework=True) as audit:
        assert threading.Thread is not before[4]
        assert type(fr._ring).__name__ == "_TrackedMutable"
        with pytest.raises(RuntimeError, match="does not nest"):
            with tanalysis.audit_threads():
                pass
    assert _patched_globals() == before
    assert all(getattr(o, a) is v for (o, a), v in zip(attrs, vals))
    res = tanalysis.run_schedules(["ckpt_save_during_step"], n=1,
                                  device="cpu")
    assert res["ok"], res["failures"]
    assert _patched_globals() == before
    assert audit.report.clean


def test_framework_threads_audit_clean(tmp_path, _telemetry):
    """The port's async checkpoint writer (CPU tensors mutated in place
    after each save), device prefetcher and telemetry threads, under
    ``instrument_framework``: no race, cycle or blocking-under-lock, and
    every checkpoint restores byte-identical."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.io import DevicePrefetchIter, NDArrayIter
    logging.getLogger("mxnet_tpu_torch.telemetry.flight").setLevel(
        logging.ERROR)
    ttel.configure(metrics_file=str(tmp_path / "m.jsonl"),
                   metrics_interval=0.0)
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    want = {}
    with tanalysis.audit_threads(instrument_framework=True) as audit:
        mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=5,
                                async_write=True)
        it = DevicePrefetchIter(
            NDArrayIter(np.zeros((16, 4), np.float32), batch_size=4),
            depth=2, device="cpu")
        for step, _batch in enumerate(it):
            want[step] = w.numpy().tobytes()
            mgr.save(step, {"w": w})
            w.add_(100.0)                # the "next step", in place
            ttel.record_step({"step": step})
            if step == 1:
                ttel.dump_flight("t", path=str(tmp_path / "f.json"))
        it.close()
        mgr.wait_until_finished()
    for step, raw in want.items():
        got, _meta, s = mgr.restore(step)
        assert s == step and np.asarray(got["w"]).tobytes() == raw
    mgr.close()
    m = audit.report.metrics["races"]
    assert audit.report.clean, audit.report.format_text()
    assert m["events"] > 0 and m["threads"] >= 2 and len(want) == 4


# ---------------------------------------------------------------------------
# The linter
# ---------------------------------------------------------------------------

def _rule_lines(rep, rules=None):
    return sorted((f.rule, f.line) for f in rep.findings
                  if rules is None or f.rule in rules)


def test_conc_unguarded_corpus_matches_jax():
    path = os.path.join(CORPUS, "bad_source", "conc_unguarded.py")
    j = JS.lint_file(path, rel="c.py")
    t = TS.lint_file(path, rel="c.py")
    assert _rule_lines(t) == _rule_lines(j)
    assert [r for r, _ in _rule_lines(t)].count(
        "source.unguarded-shared-write") == 4
    assert ("source.daemon-capture", 40) in _rule_lines(t)


_PLAIN_SNIPPETS = {
    "guarded": """\
        import threading

        class Buf:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []   # shared: guarded_by=_lock

            def ok(self, x):
                with self._lock:
                    self._items.append(x)

            def racy(self, x):
                self._items.append(x)

            def rebind(self):
                self._items = [1]
    """,
    "daemon_racy": """\
        import threading

        def spawn(items):
            batch = []

            def worker():
                return len(batch)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            batch = list(items)
            return t
    """,
    "daemon_stable": """\
        import threading

        def spawn(items):
            batch = list(items)

            def worker():
                return len(batch)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            return t
    """,
    "suppressed": """\
        import threading

        class Buf:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0   # shared: guarded_by=_lock

            def bump(self):
                self._n += 1  # staticcheck: disable=source.* -- demo
    """,
}


@pytest.mark.parametrize("name", sorted(_PLAIN_SNIPPETS))
def test_plain_rules_match_jax(name):
    src = textwrap.dedent(_PLAIN_SNIPPETS[name])
    j = JS.lint_file("s.py", src=src, rel="s.py")
    t = TS.lint_file("s.py", src=src, rel="s.py")
    assert _rule_lines(t) == _rule_lines(j)
    assert [f.suppressed for f in t.findings] == \
        [f.suppressed for f in j.findings]
    expect = {"guarded": [("source.unguarded-shared-write", 13),
                          ("source.unguarded-shared-write", 16)],
              "daemon_racy": [("source.daemon-capture", 9)],
              "daemon_stable": [],
              "suppressed": [("source.unguarded-shared-write", 9)]}[name]
    assert _rule_lines(t) == expect


_ENV_SRC = """\
    import os
    _K = "MXNET_TPU_BY_CONST"
    a = os.environ.get("MXNET_TPU_DIRECT")
    b = os.getenv(_K)
    c = os.environ["MXNET_TPU_SUBSCRIPT"]
    d = "MXNET_TPU_MEMBER" in os.environ
    e = _env_flag("MXNET_TPU_WRAPPED")
    f = unrelated("MXNET_TPU_NOT_A_READ")
    g = os.environ.get("MXNET_TPU_QUIET")  # staticcheck: disable=source.env-undocumented -- demo
"""


def test_env_rules_match_jax(tmp_path):
    """The same package file and the same catalogue text, laid out as
    each package expects: equal env findings and reads."""
    src = textwrap.dedent(_ENV_SRC)
    doc = "- `MXNET_TPU_DIRECT`\n- `MXNET_TPU_MEMBER`\n- `MXNET_TPU_OLD`\n"
    reps = []
    for pkg, docs, S in (("mxnet_tpu", "docs/env_vars.md", JS),
                         ("mxnet_tpu_torch", "mxnet_tpu_torch/ENV_VARS.md",
                          TS)):
        root = tmp_path / pkg
        (root / pkg).mkdir(parents=True)
        (root / pkg / "knobs.py").write_text(src)
        (root / docs).parent.mkdir(parents=True, exist_ok=True)
        (root / docs).write_text(doc)
        rep = S.lint_paths(str(root))
        reps.append(sorted((f.rule, f.line, f.details["var"])
                           for f in rep.findings))
    assert reps[0] == reps[1]
    assert reps[1] == [
        ("source.env-stale", 0, "MXNET_TPU_OLD"),
        ("source.env-undocumented", 4, "MXNET_TPU_BY_CONST"),
        ("source.env-undocumented", 5, "MXNET_TPU_SUBSCRIPT"),
        ("source.env-undocumented", 7, "MXNET_TPU_WRAPPED")]
    tree = ast.parse(src)
    assert TS.env_reads_in_source(src, tree) == \
        JS.env_reads_in_source(src, tree)


# each pair: the port snippet (a capture) and the JAX snippet (jax.jit in
# its place), line for line; the flagged lines must be the same
_PORT_SNIPPETS = {
    "source.host-sync": ("""\
        import numpy as np
        from mxnet_tpu_torch.compile_cache import CapturedProgram

        def step(x):
            n = float(x.sum())
            pad = int(np.prod(x.shape))
            m = x.item()
            return np.tanh(x) + n + pad + m

        prog = CapturedProgram("step", step, "cuda")
    """, """\
        import numpy as np
        import jax

        def step(x):
            n = float(x.sum())
            pad = int(np.prod(x.shape))
            m = x.item()
            return np.tanh(x) + n + pad + m

        prog = jax.jit(step)
    """, [5, 7, 8]),
    "source.nondet": ("""\
        import random
        import time
        import numpy as np
        from mxnet_tpu_torch import compile_cache as cc

        def step(x):
            return x * time.time() + np.random.rand() + random.random()

        prog = cc.CapturedProgram("step", lambda: step(1.0), "cuda")
    """, """\
        import random
        import time
        import numpy as np
        import jax

        def step(x):
            return x * time.time() + np.random.rand() + random.random()

        prog = jax.jit(lambda: step(1.0))
    """, [7, 7, 7]),
    "source.donated-mutation": ("""\
        from mxnet_tpu_torch.compile_cache import program_key

        def update(fp, params, grads, run, fresh):
            key = program_key(fp, (params, grads), donate=(0,))
            out = run(key)
            bad = params
            params = fresh
            ok = params
            return out, bad, ok
    """, """\
        import jax

        def update(fp, params, grads, run, fresh):
            step = jax.jit(run, donate_argnums=(0,))
            out = step(params, grads)
            bad = params
            params = fresh
            ok = params
            return out, bad, ok
    """, [6]),
}


@pytest.mark.parametrize("rule", sorted(_PORT_SNIPPETS))
def test_port_meaning_rules_flag_the_jax_lines(rule):
    port_src, jax_src, lines = _PORT_SNIPPETS[rule]
    t = TS.lint_file("p.py", src=textwrap.dedent(port_src), rel="p.py")
    j = JS.lint_file("j.py", src=textwrap.dedent(jax_src), rel="j.py")
    assert _rule_lines(t) == _rule_lines(j) == [(rule, n) for n in lines]


def test_capture_block_and_sync_rules():
    """Port-only forms: a ``torch.cuda.graph`` block (every local counts
    as captured, shape math stays static), ``.cpu()``/``.numpy()``, a
    synchronize anywhere in traced code, the traced directive, and the
    body handed by keyword or through ``functools.partial``."""
    src = textwrap.dedent("""\
        import functools
        import time
        import numpy as np
        import torch
        from mxnet_tpu_torch.compile_cache import CapturedProgram

        def a(x):
            return x.cpu()

        def b(x, k):
            torch.cuda.synchronize()
            return x.numpy() * k

        def helper(x):  # staticcheck: traced
            return x.tolist()

        def host_only(x):
            return x.item() + time.time()

        def build(x, g, dev):
            p = [CapturedProgram("a", body=a, device=dev),
                 CapturedProgram("b", functools.partial(b, x), dev)]
            with torch.cuda.graph(g):
                y = x * 2
                n = int(np.prod(y.shape))
                z = y.sum().item()
                w = float(n)
            t0 = time.time()
            return p, z, w, t0
    """)
    t = TS.lint_file("p.py", src=src, rel="p.py")
    assert _rule_lines(t) == [("source.host-sync", n)
                              for n in (8, 11, 12, 15, 26)]


@pytest.fixture(scope="module")
def port_lint():
    return tanalysis.lint_paths(REPO_ROOT)


def test_port_lint_is_clean_with_reasons(port_lint):
    """The port's own lint over ``mxnet_tpu_torch/``: no error, no
    warning, and every suppression carries its reason."""
    rep = port_lint
    assert rep.clean, rep.format_text()
    assert not rep.unsuppressed("warn"), rep.format_text()
    for f in rep.findings:
        assert f.suppressed and f.suppress_reason not in (
            "", "inline suppression"), f.format()
    assert rep.metrics["lint"]["files"] > 90


def test_env_catalogue_is_exactly_what_the_port_reads(port_lint):
    rep = port_lint
    reads = set(rep.metrics["lint"]["env_reads"])
    assert set(rep.metrics["lint"]["env_documented"]) == reads
    assert {"MXNET_TPU_CONC_SCHEDULES", "MXNET_TPU_CONC_SEED",
            "MXTPU_PS_ROOT_PORT", "MXTPU_WATCHDOG"} <= reads


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ckpt_save_during_step",
                                  "emitter_snapshot_race",
                                  "flight_dump_during_append"])
def test_host_scenarios_on_the_cpu(name, _telemetry):
    before = ttel.registry().flat().get("staticcheck.schedules_run", 0)
    res = tanalysis.run_schedules([name], n=2, seed=3, device="cpu")
    assert res["ok"], res["failures"]
    assert res["device"] == "cpu"
    assert res["scenarios"][name]["runs"] == 2
    assert ttel.registry().flat()["staticcheck.schedules_run"] == before + 2


def test_run_schedules_goes_to_the_card_by_default(monkeypatch):
    """No device given means the card: without one it raises before any
    scenario runs, never falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tanalysis.run_schedules(["ckpt_save_during_step"], n=1)


def test_serve_scenario_greedy_streams_match_jax_router(_telemetry):
    """``failover_during_decode`` at one seed on the CPU; the port's
    single-threaded reference streams: greedy ones equal the JAX
    router's on the same weights and prompts, sampled ones replay within
    the port (the packages' random bits differ)."""
    res = tanalysis.run_schedules(["failover_during_decode"], n=1, seed=5,
                                  device="cpu")
    assert res["ok"], res["failures"]
    jp, tp = jsched._params(), tsched._params()
    assert sorted(jp) == sorted(tp)
    assert all(np.array_equal(jp[k], tp[k]) for k in jp)
    port_ref, jax_ref = tsched._reference("cpu"), jsched._reference()
    greedy = [i for i, kw in enumerate(tsched._KW)
              if kw["temperature"] == 0.0]
    assert greedy == [0, 2] and tsched._PROMPTS == jsched._PROMPTS
    assert [port_ref[i] for i in greedy] == [jax_ref[i] for i in greedy]
    assert all(len(s) == 6 for s in port_ref)


# ---------------------------------------------------------------------------
# Visualization
# ---------------------------------------------------------------------------

_NETS = {"mlp": {"data": (32, 784)},
         "lenet": {"data": (8, 1, 28, 28)},
         "inception-bn-28-small": {"data": (2, 3, 28, 28)}}


def _both_nets(name):
    with jmx.name.NameManager():
        js = jmx.models.get_symbol(name)
    with tmx.name.NameManager():
        ts = tmx.models.get_symbol(name)
    return js, ts


@pytest.mark.parametrize("name", sorted(_NETS))
def test_print_summary_matches_jax(name, capsys):
    js, ts = _both_nets(name)
    jviz.print_summary(js, shape=_NETS[name])
    want = capsys.readouterr().out
    tmx.viz.print_summary(ts, shape=_NETS[name])
    got = capsys.readouterr().out
    assert got == want and "Total params: " in got


@pytest.mark.parametrize("name", sorted(_NETS))
def test_plot_network_matches_jax(name):
    js, ts = _both_nets(name)
    want = jviz.plot_network(js, title=name, shape=_NETS[name]).source
    got = tviz.plot_network(ts, title=name, shape=_NETS[name]).source
    assert got == want and "->" in got


def test_plot_network_without_graphviz_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "graphviz", None)
    js, ts = _both_nets("mlp")
    with pytest.raises(jmx.MXNetError, match="graphviz"):
        jviz.plot_network(js)
    with pytest.raises(MXNetError, match="graphviz"):
        tviz.plot_network(ts)
