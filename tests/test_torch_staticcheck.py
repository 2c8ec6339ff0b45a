"""``tools/torch_staticcheck.py``, the port's twin of
``tools/staticcheck.py``, on the CPU.

As the JAX CLI's tests (``tests/test_staticcheck.py``,
``tests/test_concurrency_check.py``): ``lint``, ``races`` and ``gate``
exit 0 on the shipped tree with the JSON schema; a seeded tree exits 1
and ``--suppress`` clears it (a location glob that does not match does
not); an internal error exits 2; ``audit --device cpu`` exits 0 with the
schema and the HBM-pass lines; one host schedule scenario sweeps; the
gate holds the program corpus; and the port's lint
corpus under ``tools/torch_staticcheck_corpus/`` fires every
expectation while its negative control stays silent.  ``races`` and
``schedules`` run with ``--device cpu``: without it they go to the card.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from mxnet_tpu_torch import analysis
from mxnet_tpu_torch.analysis import findings as F

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(REPO_ROOT, "tools", "torch_staticcheck.py")
PORT_CORPUS = os.path.join(REPO_ROOT, "tools", "torch_staticcheck_corpus")


def _run_cli(*argv):
    return subprocess.run([sys.executable, CLI, *argv],
                          capture_output=True, text=True, cwd=REPO_ROOT,
                          timeout=300)


def test_cli_lint_clean_json_schema_and_exit_zero():
    proc = _run_cli("lint", "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout)
    assert out["schema"] == F.SCHEMA_VERSION
    assert out["command"] == "lint" and out["ok"] and out["clean"]
    assert out["metrics"]["lint"]["files"] > 90
    assert all(f["suppressed"] for f in out["findings"])


def test_cli_gate_passes_on_shipped_tree():
    proc = _run_cli("gate", "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout)
    assert out["command"] == "gate" and out["ok"] and out["clean"]
    assert out["corpus"]["failures"] == []
    assert set(out["corpus"]["cases"]) == {
        "data_race", "lock_order", "blocking", "clean_locked",
        "clean_event_publish"}
    port = out["corpus"]["lint"]["tools/torch_staticcheck_corpus"]
    assert port["host_sync.py:source.host-sync"] >= 5
    assert not any(k.startswith("clean.py") for k in port)
    progs = out["corpus"]["programs"]
    assert progs["corpus.hbm_bytes_widened:program.hbm-bytes"] >= 1
    assert not any(k.startswith(("corpus.clean:", "corpus.fused_clean:",
                                 "corpus.hbm_bytes_quantized:",
                                 "corpus.decode_kv_quantized:"))
                   for k in progs)
    assert set(out["metrics"]) == {"lint"} | {
        f"{n}.trainer.{k}" for n in ("fc", "transformer-lm")
        for k in ("train", "train_acc")}


def test_cli_races_passes_on_the_cpu():
    proc = _run_cli("races", "--device", "cpu", "--json")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["command"] == "races" and out["ok"] and out["clean"]
    assert out["metrics"]["races"]["events"] > 0
    assert out["metrics"]["races"]["threads"] >= 2
    assert out["corpus"]["failures"] == []


def test_cli_exit_codes_and_suppression_on_seeded_tree(tmp_path):
    pkg = tmp_path / "mxnet_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text(textwrap.dedent("""\
        import time
        from mxnet_tpu_torch.compile_cache import CapturedProgram

        def step(x):
            return x + time.time()

        prog = CapturedProgram("step", step, "cuda")
    """))
    (pkg / "ENV_VARS.md").write_text("# none\n")

    proc = _run_cli("lint", "--root", str(tmp_path), "--json")
    assert proc.returncode == 1, proc.stderr
    out = json.loads(proc.stdout)
    assert out["counts"] == {"source.nondet": 1}
    (bad,) = [f for f in out["findings"] if not f["suppressed"]]
    assert bad["path"].endswith("bad.py") and bad["line"] == 5

    proc = _run_cli("lint", "--root", str(tmp_path),
                    "--suppress", "source.nondet:*bad.py")
    assert proc.returncode == 0, proc.stdout

    proc = _run_cli("lint", "--root", str(tmp_path),
                    "--suppress", "source.nondet:*other.py")
    assert proc.returncode == 1          # location glob must not match


def test_cli_internal_error_and_audit_exit_two():
    """An internal error exits 2 (an unknown schedule scenario; an unknown
    audit network, as the JAX CLI's); ``audit --json --device cpu`` exits
    0 with the schema, and its text form prints the HBM-pass lines."""
    proc = _run_cli("schedules", "--scenarios", "no-such-scenario",
                    "--device", "cpu")
    assert proc.returncode == 2
    assert "internal error" in proc.stderr
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_staticcheck", CLI)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    with pytest.raises(ValueError, match="unknown audit network"):
        cli.main(["audit", "--networks", "no-such-net", "--device", "cpu"])
    proc = _run_cli("audit", "--json", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["schema"] == F.SCHEMA_VERSION
    assert out["command"] == "audit" and out["ok"] and out["clean"]
    assert set(out["metrics"]) == {
        f"{n}.trainer.{k}" for n in ("fc", "transformer-lm")
        for k in ("train", "train_acc")}
    for m in out["metrics"].values():
        assert m["hbm_passes"]["max_reads"] == 1
        assert m["hbm_passes"]["max_writes"] == 1
    rep = analysis.Report(mode="audit")
    rep.metrics.update(out["metrics"])
    lines = cli._hbm_lines(rep)
    assert "fc.trainer.train: hbm buckets=1 max_reads=1 max_writes=1" \
        in lines


def test_cli_schedules_single_scenario_exit_zero():
    proc = _run_cli("schedules", "--scenarios", "emitter_snapshot_race",
                    "--n", "2", "--seed", "0", "--device", "cpu", "--json")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["command"] == "schedules" and out["ok"]
    sc = out["schedules"]["scenarios"]
    assert list(sc) == ["emitter_snapshot_race"]
    assert sc["emitter_snapshot_race"]["runs"] == 2
    assert out["schedules"]["device"] == "cpu"


with open(os.path.join(PORT_CORPUS, "expected.json")) as _f:
    _EXPECTED = json.load(_f)


@pytest.mark.parametrize("entry", _EXPECTED["source"],
                         ids=lambda e: e["rule"])
def test_port_corpus_expectation_fires(entry):
    path = os.path.join(PORT_CORPUS, entry["file"])
    rep = analysis.lint_paths(PORT_CORPUS, paths=[path])
    got = [f for f in rep.findings if f.rule == entry["rule"]]
    assert len(got) >= entry["min_count"]
    assert {f.rule for f in rep.findings} == {entry["rule"]}


@pytest.mark.parametrize("name", _EXPECTED["clean"])
def test_port_corpus_negative_control_is_silent(name):
    rep = analysis.lint_paths(PORT_CORPUS,
                              paths=[os.path.join(PORT_CORPUS, name)])
    assert rep.findings == []
