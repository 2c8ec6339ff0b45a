#!/usr/bin/env python
"""Static and runtime analysis gate for mxnet_tpu_torch, the PyTorch port.

The port's twin of ``tools/staticcheck.py``: the same subcommands,
exit codes, ``--json`` schema and ``--suppress``.

- ``lint``  — AST linter over ``mxnet_tpu_torch/`` (host syncs and
  nondeterminism in code that runs under a CUDA-graph capture, reads of
  donated program buffers, env-var drift against
  ``mxnet_tpu_torch/ENV_VARS.md``, unguarded shared writes, daemon
  closure captures).
- ``races`` — runtime lockset sanitizer (``conc.*`` rules): drive the
  port's real threaded paths (telemetry record/dump and the JSONL
  emitter, the async checkpoint writer racing in-place mutation of
  tensors on ``--device``, the device prefetcher) under
  ``analysis.audit_threads(instrument_framework=True)``, then re-run
  every seeded violation in ``tests/golden/staticcheck/bad_threads.py``
  (with clean negative controls).
- ``schedules`` — deterministic schedule fuzzer: N seeded
  interleavings per hot concurrent scenario
  (``mxnet_tpu_torch/analysis/schedules.py``) on ``--device``, each
  asserting byte-identity invariants.  ``MXNET_TPU_CONC_SCHEDULES`` /
  ``MXNET_TPU_CONC_SEED`` (or ``--n`` / ``--seed``) set the sweep; a
  failure prints the replayable ``(scenario, seed)`` pair.
- ``audit`` — record the framework's own step programs (the FC
  classifier and the transformer-LM trainer of the JAX CLI, at its sizes;
  ``--networks``, ``--programs``) on ``--device`` and run the program
  rules over their aten ops and kernel notes
  (``mxnet_tpu_torch/analysis/program.py``): dtype widening, the metric
  carry, host transfers, captured constants, and the HBM-pass count per
  gradient bucket — the fused update's measuring stick.
- ``gate``  — CI entry, host only: ``lint`` and the ``audit`` on the CPU
  must be clean, every seeded violation must still be detected — the
  races corpus above, the plain-Python lint rules over
  ``tests/golden/staticcheck/bad_source/``, the three lint rules with a
  port meaning over ``tools/torch_staticcheck_corpus/`` and the program
  corpus ``tools/torch_staticcheck_corpus/bad_programs.py`` — and the
  negative controls stay silent.

``--device`` (``audit``, ``races``, ``schedules``) is the card unless
``cpu`` is passed.  Exit codes: 0 clean, 1 findings / missed
expectations, 2 internal error.  ``--json`` emits the machine-readable report (schema
in ``mxnet_tpu_torch/analysis/findings.py``); ``--suppress
RULE[:LOCATION]`` (repeatable, globs allowed) silences known findings
with an audit trail.
"""
import argparse
import importlib.util
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_DIR = os.path.join(REPO_ROOT, "tests", "golden", "staticcheck")
PORT_CORPUS_DIR = os.path.join(REPO_ROOT, "tools",
                               "torch_staticcheck_corpus")

# audited by `audit` and `gate`: the JAX CLI's acceptance programs, a
# plain FC classifier and the transformer-LM, through ShardedTrainer
AUDIT_NETWORKS = ("fc", "transformer-lm")

# rules of the shared corpus that are plain Python: the port's linter
# reads those files as they are
PLAIN_LINT_RULES = ("source.env-undocumented",
                    "source.unguarded-shared-write",
                    "source.daemon-capture")


def _repo_import():
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    from mxnet_tpu_torch import analysis
    return analysis


# ----------------------------------------------------------------------
# Trainer builders and the audit (the JAX CLI's networks and sizes)
# ----------------------------------------------------------------------

def _build_trainer(network, device):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import ShardedTrainer

    mx.random.seed(7)
    with mx.name.NameManager():
        if network == "fc":
            data = mx.symbol.Variable("data")
            net = mx.symbol.FullyConnected(data=data, num_hidden=32,
                                           name="fc1")
            net = mx.symbol.Activation(data=net, act_type="relu")
            net = mx.symbol.FullyConnected(data=net, num_hidden=10,
                                           name="fc2")
            sym = mx.symbol.SoftmaxOutput(data=net, name="softmax")
            tr = ShardedTrainer(sym, optimizer="sgd",
                                optimizer_params={"learning_rate": 0.1,
                                                  "momentum": 0.9},
                                device=device)
            tr.bind(data_shapes={"data": (16, 8)},
                    label_shapes={"softmax_label": (16,)})
            return tr
        if network == "transformer-lm":
            from mxnet_tpu_torch import models
            B, L, V = 8, 16, 128
            sym = models.get_symbol("transformer-lm", vocab_size=V,
                                    num_layers=2, d_model=64, heads=2,
                                    batch_size=B, seq_len=L)
            tr = ShardedTrainer(sym, optimizer="adam",
                                optimizer_params={"learning_rate": 1e-3},
                                device=device)
            tr.bind(data_shapes={"data": (B, L)},
                    label_shapes={"softmax_label": (B, L)})
            return tr
    raise ValueError(f"unknown audit network: {network!r} "
                     f"(choose from {AUDIT_NETWORKS})")


def _run_audit(analysis, networks, programs, device):
    report = analysis.Report(mode="audit")
    for network in networks:
        tr = _build_trainer(network, device)
        sub = analysis.audit_trainer(tr, programs=programs)
        # prefix program labels/metrics with the network name so the two
        # trainers' findings stay distinguishable in one report
        for f in sub.findings:
            if f.program:
                f.program = f"{network}.{f.program}"
        report.findings.extend(sub.findings)
        for k, v in sub.metrics.items():
            report.metrics[f"{network}.{k}"] = v
    return report


def _hbm_lines(report):
    lines = []
    for prog, m in sorted(report.metrics.items()):
        hbm = (m or {}).get("hbm_passes")
        if not hbm:
            continue
        lines.append(f"{prog}: hbm buckets={len(hbm.get('buckets', []))} "
                     f"max_reads={hbm.get('max_reads')} "
                     f"max_writes={hbm.get('max_writes')}")
        for b in hbm.get("buckets", []):
            lines.append(f"  bucket[{b['index']}] {b['dtype']} "
                         f"{b['bytes']} B ({len(b['params'])} params): "
                         f"{b['reads']} reads / {b['writes']} writes")
    return lines


# ----------------------------------------------------------------------
# Corpora (gate)
# ----------------------------------------------------------------------

def _count_by_file_rule(report):
    out = {}
    for f in report.findings:
        if not f.suppressed:
            key = (f.path.replace(os.sep, "/"), f.rule)
            out[key] = out.get(key, 0) + 1
    return out


def _check_lint_corpora(analysis):
    """Returns (ok, failures, details).  A failure is a seeded violation
    the linter no longer detects, or a finding on a negative control."""
    failures = []
    with open(os.path.join(CORPUS_DIR, "expected.json")) as f:
        shared = [e for e in json.load(f)["source"]
                  if e["rule"] in PLAIN_LINT_RULES]
    with open(os.path.join(PORT_CORPUS_DIR, "expected.json")) as f:
        port = json.load(f)
    counts = {}
    for root, entries, clean in ((CORPUS_DIR, shared, []),
                                 (PORT_CORPUS_DIR, port["source"],
                                  port.get("clean", []))):
        files = sorted({e["file"] for e in entries} | set(clean))
        rep = analysis.lint_paths(
            root, paths=[os.path.join(root, p) for p in files])
        by = _count_by_file_rule(rep)
        counts[os.path.relpath(root, REPO_ROOT)] = {
            f"{p}:{r}": n for (p, r), n in sorted(by.items())}
        for e in entries:
            got = by.get((e["file"], e["rule"]), 0)
            want = e.get("min_count", 1)
            if got < want:
                failures.append(f"corpus: {e['rule']} fired {got}x on "
                                f"{e['file']} (expected >= {want})")
        for p in clean:
            hits = sorted(r for (q, r) in by if q == p)
            if hits:
                failures.append(f"corpus: negative control {p} "
                                f"triggered {hits}")
    return not failures, failures, {"lint": counts, "failures": failures}


# ----------------------------------------------------------------------
# Concurrency: live lockset run + threads corpus (races)
# ----------------------------------------------------------------------

def _races_live(analysis, device):
    """Drive the port's real threaded paths under the lockset sanitizer
    and return the analyzed report: telemetry step recording with
    mid-append flight dumps, the JSONL emitter, the async checkpoint
    writer racing in-place mutation of tensors on ``device``, and the
    device prefetch worker."""
    import logging
    import tempfile
    import threading

    import numpy as np
    import torch

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.checkpoint.manager import CheckpointManager
    from mxnet_tpu_torch.context import resolve_device
    from mxnet_tpu_torch.io import DevicePrefetchIter, NDArrayIter

    dev = resolve_device(device)
    report = analysis.Report(mode="races")
    telemetry.reset_for_tests()
    # the mid-append dumps are the point of the exercise, not news
    logging.getLogger("mxnet_tpu_torch.telemetry.flight").setLevel(
        logging.ERROR)
    with tempfile.TemporaryDirectory(prefix="mxtpu_races_") as td:
        telemetry.configure(metrics_file=os.path.join(td, "m.jsonl"),
                            metrics_interval=0.0)
        with analysis.audit_threads(report=report,
                                    instrument_framework=True):
            def ticker(tag):
                for i in range(30):
                    telemetry.record_step({"step": i, "tag": tag})
                    telemetry.counter(f"races.{tag}").inc()

            ts = [threading.Thread(target=ticker, args=(k,),
                                   name=f"races-tick-{k}")
                  for k in ("a", "b")]
            for t in ts:
                t.start()
            for i in range(5):   # dumps race the appending tickers
                telemetry.dump_flight("races",
                                      path=os.path.join(td, f"f{i}.json"))
            for t in ts:
                t.join()
            telemetry.flush_metrics()

            tensors = {"w": torch.arange(32, dtype=torch.float32,
                                         device=dev)}
            mgr = CheckpointManager(os.path.join(td, "ckpt"), keep_last=3,
                                    async_write=True)
            for s in range(2):
                mgr.save(s, tensors)
                with torch.no_grad():
                    tensors["w"].add_(1.0)   # in-place "train step"
            mgr.wait_until_finished()
            mgr.close()

            it = DevicePrefetchIter(
                NDArrayIter(np.zeros((16, 4), dtype=np.float32),
                            batch_size=4), depth=2, device=dev)
            for _ in it:
                pass
            it.close()
    telemetry.configure(metrics_file="")   # drop the tmpdir emitter
    races = report.metrics.get("races", {}).get("races_found", 0)
    telemetry.counter("staticcheck.races_found").inc(races)
    return report


def _load_threads_corpus():
    path = os.path.join(CORPUS_DIR, "bad_threads.py")
    spec = importlib.util.spec_from_file_location(
        "mxtpu_torch_staticcheck_threads", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_programs_corpus():
    path = os.path.join(PORT_CORPUS_DIR, "bad_programs.py")
    spec = importlib.util.spec_from_file_location(
        "mxtpu_torch_staticcheck_programs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_programs_corpus(analysis):
    """Record and audit every seeded program on the host: each must
    still produce its rule, and the negative controls stay silent."""
    with open(os.path.join(PORT_CORPUS_DIR, "expected.json")) as f:
        expected = json.load(f)
    mod = _load_programs_corpus()
    report = analysis.Report(mode="audit")
    for name, (builder, _rules) in mod.PROGRAMS.items():
        trace, kwargs = builder()
        analysis.audit_traced(trace, f"corpus.{name}", report=report,
                              **kwargs)
    by = {}
    for f in report.findings:
        by[(f.program, f.rule)] = by.get((f.program, f.rule), 0) + 1
    failures = []
    for e in expected["programs"]:
        prog = e["program"]
        if e.get("clean"):
            hits = sorted(r for (p, r) in by if p == prog)
            if hits:
                failures.append(f"corpus: negative control {prog} "
                                f"triggered {hits}")
            continue
        if by.get((prog, e["rule"]), 0) < e.get("min_count", 1):
            failures.append(f"corpus: {e['rule']} did not fire on {prog}")
    return not failures, failures, {
        "programs": {f"{p}:{r}": n for (p, r), n in sorted(by.items())},
        "failures": failures}


def _check_threads_corpus(analysis):
    """Re-run every seeded concurrency violation: each case drives real
    threads under its own audit window and must still produce its rule
    (negative controls must stay silent)."""
    with open(os.path.join(CORPUS_DIR, "expected.json")) as f:
        expected = json.load(f)
    mod = _load_threads_corpus()
    failures = []
    per_case = {}
    for e in expected.get("threads", []):
        name = e["case"]
        with analysis.audit_threads() as audit:
            mod.CASES[name](audit)
        rules = sorted({f.rule for f in audit.report.findings
                        if not f.suppressed})
        per_case[name] = rules
        if e.get("clean"):
            if rules:
                failures.append(f"threads corpus: negative control "
                                f"{name} triggered {rules}")
            continue
        got = sum(1 for f in audit.report.findings
                  if f.rule == e["rule"] and not f.suppressed)
        if got < e.get("min_count", 1):
            failures.append(f"threads corpus: {e['rule']} did not fire "
                            f"on {name}")
    return not failures, failures, {"cases": per_case, "failures": failures}


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="torch_staticcheck",
        description="program auditor, source linter and concurrency "
                    "sanitizer of the PyTorch port")
    ap.add_argument("command",
                    choices=("lint", "audit", "gate", "races", "schedules"))
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    ap.add_argument("--suppress", action="append", default=[],
                    metavar="RULE[:LOCATION]",
                    help="suppress findings (repeatable; fnmatch globs)")
    ap.add_argument("--show-suppressed", action="store_true")
    ap.add_argument("--root", default=REPO_ROOT,
                    help="repo root to lint (default: this checkout)")
    ap.add_argument("--device", default=None,
                    help="device of audit, races and schedules (default: "
                         "the card; 'cpu' runs on the host)")
    ap.add_argument("--networks", default=",".join(AUDIT_NETWORKS),
                    help="comma-separated audit networks "
                         f"(default {','.join(AUDIT_NETWORKS)})")
    ap.add_argument("--programs", default="train,train_acc",
                    help="trainer program kinds to audit")
    ap.add_argument("--scenarios", default="",
                    help="comma-separated schedule scenarios "
                         "(default: all; see analysis/schedules.py)")
    ap.add_argument("--n", type=int, default=None,
                    help="interleavings per scenario "
                         "(default MXNET_TPU_CONC_SCHEDULES=50)")
    ap.add_argument("--seed", type=int, default=None,
                    help="base fuzzer seed (default MXNET_TPU_CONC_SEED=0)")
    args = ap.parse_args(argv)

    analysis = _repo_import()
    networks = [n for n in args.networks.split(",") if n]
    programs = tuple(p for p in args.programs.split(",") if p)
    out = {"schema": analysis.SCHEMA_VERSION, "command": args.command}
    extra_lines = []
    corpus_ok = True
    corpus_failures = []
    if args.command == "lint":
        report = analysis.lint_paths(args.root)
    elif args.command == "audit":
        report = _run_audit(analysis, networks, programs, args.device)
        extra_lines = _hbm_lines(report)
    elif args.command == "races":
        report = _races_live(analysis, args.device)
        corpus_ok, corpus_failures, corpus_details = \
            _check_threads_corpus(analysis)
        out["corpus"] = corpus_details
        m = report.metrics.get("races", {})
        extra_lines = [f"races: live run: {m.get('events', 0)} events, "
                       f"{m.get('threads', 0)} threads, "
                       f"{m.get('locations', 0)} tracked locations, "
                       f"{m.get('races_found', 0)} race(s)"]
    elif args.command == "schedules":
        report = analysis.Report(mode="schedules")
        scenarios = [s for s in args.scenarios.split(",") if s] or None
        res = analysis.run_schedules(
            scenarios=scenarios, n=args.n, seed=args.seed,
            log=None if args.json else print, device=args.device)
        out["schedules"] = res
        corpus_ok = res["ok"]
        corpus_failures = [
            f"schedules: {f['scenario']} failed at seed {f['seed']} "
            f"({f['error']}) — replay: torch_staticcheck schedules "
            f"--scenarios {f['scenario']} --n 1 --seed {f['seed']}"
            for f in res["failures"]]
    else:  # gate
        report = analysis.Report(mode="gate")
        report.merge(analysis.lint_paths(args.root))
        audit = _run_audit(analysis, networks, programs, "cpu")
        report.merge(audit)
        extra_lines = _hbm_lines(audit)
        lint_ok, lint_failures, lint_details = \
            _check_lint_corpora(analysis)
        threads_ok, threads_failures, threads_details = \
            _check_threads_corpus(analysis)
        progs_ok, progs_failures, progs_details = \
            _check_programs_corpus(analysis)
        corpus_ok = lint_ok and threads_ok and progs_ok
        corpus_failures = lint_failures + threads_failures + progs_failures
        out["corpus"] = {"lint": lint_details["lint"],
                         "cases": threads_details["cases"],
                         "programs": progs_details["programs"],
                         "failures": corpus_failures}

    analysis.apply_cli(report.findings, args.suppress)
    ok = report.clean and corpus_ok

    out.update(report.to_dict())
    out["ok"] = ok
    if args.json:
        print(json.dumps(out, indent=2, default=str))
    else:
        print(report.format_text(show_suppressed=args.show_suppressed))
        for line in extra_lines:
            print(line)
        for fail in corpus_failures:
            print(fail)
        if args.command in ("gate", "races", "schedules"):
            print(f"{args.command}: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"torch_staticcheck: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        sys.exit(2)
