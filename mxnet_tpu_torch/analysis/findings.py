"""Typed findings, the rule catalogue, and suppression plumbing shared by
the port's analysis tools: the program auditor
(:mod:`mxnet_tpu_torch.analysis.program`), the source linter
(:mod:`mxnet_tpu_torch.analysis.source`) and the concurrency sanitizer
(:mod:`mxnet_tpu_torch.analysis.concurrency`).

Counterpart of ``mxnet_tpu/analysis/findings.py``: the same schema, rule
ids, severities and suppression syntax, so a report from either package
reads the same.  A *finding* is one concrete hazard at one location (a
source line or a program).  Rules are stable string ids
(``source.host-sync``, ``conc.data-race``, ...) so suppressions and CI
baselines survive refactors.

Two kinds of entries differ from the JAX catalogue by design:

* three ``program.*`` ids have no meaning here and are data only
  (:data:`RESERVED_RULES`): ``program.donation-miss`` and
  ``program.donation-alias`` (a captured graph donates no buffer: its
  state is written in place) and ``program.carry-sharding`` (a mesh
  member holds whole tensors, never a sharding that could change);
  nothing in the port emits them;
* the rules with a port meaning say what they mean here: the program
  rules check the aten ops and kernel notes of one recorded run of a
  program's body (a captured constant is a tensor the body closes over,
  a host transfer an aten op, a reduce collective a ``psum`` note, a KV
  read a decode-kernel note or a gather over a pool); of the source
  rules, "traced" code is code that runs inside a CUDA-graph capture,
  "donated" a position of ``compile_cache.program_key``'s ``donate=``
  set, and the environment catalogue is ``mxnet_tpu_torch/ENV_VARS.md``.
  Their ids and severities are the JAX package's.
"""

from __future__ import annotations

import fnmatch
import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 1

# rule id -> (default severity, one-line description)
RULES: Dict[str, Tuple[str, str]] = {
    "program.widen": (
        "error", "an aten op of a program's body outputs a 64-bit float or "
        "int from narrower inputs (torch's int64 defaults, an unpinned "
        "widening) and the value reaches an output or state"),
    "program.carry-widen": (
        "error", "a carried value (fit's metric carry, an executor's aux "
        "states) leaves the program with another dtype or shape than it "
        "entered"),
    "program.captured-const": (
        "warn", "large tensor the body closes over that is none of its "
        "inputs or state: a captured graph bakes in its address, so a "
        "rebinding leaves the replay reading stale memory"),
    "program.host-transfer": (
        "error", "aten op inside the step program that reads back to the "
        "host (.item(), a data-dependent output size) or, on the card, "
        "copies between the host and the card"),
    "program.donation-miss": (
        "warn", "argument was donated but XLA could not alias it to any "
        "output (the buffer is freed + reallocated every step)"),
    "program.donation-alias": (
        "error", "donation contract violation: a buffer the framework "
        "must never donate (weights on the legacy optimizer path) is "
        "donated, or a donated carry does not alias its own output slot"),
    "program.carry-sharding": (
        "error", "a carried value changes sharding across the step, or a "
        "scalar carry is not fully replicated — every call regathers or "
        "re-traces"),
    "program.fused-update": (
        "error", "a fused-update program breaks the single-pass HBM "
        "contract: an aten op outside the fused kernel touches a tagged "
        "gradient bucket (reads/writes > 1), or no bucket is tagged"),
    "program.hbm-bytes": (
        "error", "a quantized program breaks its bytes contract: a "
        "bucket-scale reduce collective (psum note) puts a wider payload "
        "on the wire than the configured compression allows, a paged KV "
        "read is wider than the pool's quantized width, or the "
        "quantized reduction or read is not in the trace at all"),
    "source.host-sync": (
        "error", ".item()/.cpu()/.numpy()/.tolist()/.asnumpy()/float()/"
        "np.* applied to a captured value, or a synchronize, inside code "
        "that runs under a CUDA-graph capture (the capture fails, or the "
        "graph replays a value read once at capture time)"),
    "source.env-undocumented": (
        "error", "os.environ read of an MXNET_TPU_*/MXTPU_* variable that "
        "mxnet_tpu_torch/ENV_VARS.md does not document"),
    "source.env-stale": (
        "warn", "mxnet_tpu_torch/ENV_VARS.md documents an MXNET_TPU_*/"
        "MXTPU_* variable that no code of the port reads"),
    "source.nondet": (
        "error", "nondeterminism (time.*, random.*, np.random.*, "
        "datetime.now) inside code that runs under a CUDA-graph capture "
        "— runs once at capture time, and every replay reuses its value"),
    "source.donated-mutation": (
        "error", "a buffer is read or mutated after being donated "
        "(mark_donated / a position of program_key's donate= set, whose "
        "static buffer the program's replay overwrites)"),
    "source.unguarded-shared-write": (
        "error", "an attribute declared `# shared: guarded_by=<lock>` "
        "is mutated outside a `with self.<lock>:` block (and outside "
        "__init__, which is single-threaded construction)"),
    "source.daemon-capture": (
        "warn", "a daemon thread's target closure captures a local the "
        "enclosing function rebinds after the thread starts — the "
        "worker races the rebind"),
    "conc.data-race": (
        "error", "two threads touched the same shared mutable state "
        "(at least one write) with no common lock and no "
        "happens-before edge between the accesses (eraser-style "
        "lockset intersection, vector-clock HB via Event/Queue/Thread/"
        "Condition publish)"),
    "conc.lock-order": (
        "error", "the lock-acquisition graph has a cycle: two threads "
        "acquire the same locks in opposite orders — a potential "
        "deadlock even if this run got lucky"),
    "conc.blocking-under-lock": (
        "error", "a blocking operation (queue get/put, Event.wait, "
        "Thread.join, time.sleep, file open) runs while holding a "
        "framework lock — every other thread needing that lock stalls "
        "behind the I/O"),
}

#: the JAX auditor's ids with no meaning in the port (a graph donates
#: nothing; a mesh member holds whole tensors): kept as data so reports
#: and suppressions read the same in both packages, never emitted
RESERVED_RULES = frozenset({"program.donation-miss",
                            "program.donation-alias",
                            "program.carry-sharding"})

SEVERITIES = ("error", "warn", "info")


@dataclass
class Finding:
    rule: str
    message: str
    path: str = ""                 # source file, repo-relative when known
    line: int = 0                  # 1-based; 0 = whole file / program
    program: str = ""              # program label for auditor findings
    severity: str = ""             # defaults to the rule's severity
    details: Dict[str, Any] = field(default_factory=dict)
    suppressed: bool = False
    suppress_reason: str = ""

    def __post_init__(self):
        if not self.severity:
            self.severity = RULES.get(self.rule, ("error", ""))[0]

    @property
    def location(self) -> str:
        if self.program:
            return self.program
        if self.line:
            return f"{self.path}:{self.line}"
        return self.path or "<repo>"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "path": self.path,
            "line": self.line,
            "program": self.program,
            "details": self.details,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }

    def format(self) -> str:
        flag = "suppressed" if self.suppressed else self.severity
        out = f"{self.location}: [{self.rule}] {flag}: {self.message}"
        if self.suppressed and self.suppress_reason:
            out += f"  ({self.suppress_reason})"
        return out


# ----------------------------------------------------------------------
# Suppressions
# ----------------------------------------------------------------------

# inline:  ... # staticcheck: disable=rule[,rule]  -- why it is fine
_INLINE_RE = re.compile(
    r"#\s*staticcheck:\s*disable=([\w.,\-*]+)(?:\s*--\s*(.*))?")
# inline:  # staticcheck: traced   (marks a def as traced for the linter)
_TRACED_RE = re.compile(r"#\s*staticcheck:\s*traced\b")


def parse_inline_suppressions(src: str) -> Dict[int, Tuple[List[str], str]]:
    """``{line: ([rules], reason)}`` for every inline disable comment.
    A comment suppresses matching findings on its own line; a comment on
    an otherwise blank line also covers the next line."""
    out: Dict[int, Tuple[List[str], str]] = {}
    for i, text in enumerate(src.splitlines(), start=1):
        m = _INLINE_RE.search(text)
        if not m:
            continue
        rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
        reason = (m.group(2) or "").strip()
        out[i] = (rules, reason)
        if text.strip().startswith("#"):
            out.setdefault(i + 1, (rules, reason))
    return out


def traced_directive_lines(src: str) -> List[int]:
    return [i for i, text in enumerate(src.splitlines(), start=1)
            if _TRACED_RE.search(text)]


def _rule_matches(pattern: str, rule: str) -> bool:
    return fnmatch.fnmatchcase(rule, pattern)


def apply_inline(findings: Iterable[Finding],
                 inline: Dict[int, Tuple[List[str], str]]) -> None:
    for f in findings:
        hit = inline.get(f.line)
        if not hit:
            continue
        rules, reason = hit
        if any(_rule_matches(p, f.rule) for p in rules):
            f.suppressed = True
            f.suppress_reason = reason or "inline suppression"


def apply_cli(findings: Iterable[Finding],
              specs: Sequence[str]) -> None:
    """CLI-level suppression: each spec is ``rule`` or ``rule:location``
    where both halves allow ``*`` globs and location matches the finding's
    path or program label."""
    parsed = []
    for s in specs:
        rule, _, loc = s.partition(":")
        parsed.append((rule.strip(), loc.strip()))
    for f in findings:
        for rule, loc in parsed:
            if not _rule_matches(rule, f.rule):
                continue
            if loc and not (fnmatch.fnmatchcase(f.path, loc)
                            or fnmatch.fnmatchcase(f.program, loc)):
                continue
            f.suppressed = True
            f.suppress_reason = f.suppress_reason or "cli suppression"
            break


# ----------------------------------------------------------------------
# Report
# ----------------------------------------------------------------------

class Report:
    """Accumulates findings + metrics from one audit/lint run."""

    def __init__(self, mode: str = ""):
        self.mode = mode
        self.findings: List[Finding] = []
        self.metrics: Dict[str, Any] = {}

    def add(self, finding: Finding) -> Finding:
        self.findings.append(finding)
        return finding

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def merge(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.metrics.update(other.metrics)

    def unsuppressed(self, severity: Optional[str] = None) -> List[Finding]:
        out = [f for f in self.findings if not f.suppressed]
        if severity is not None:
            out = [f for f in out if f.severity == severity]
        return out

    @property
    def clean(self) -> bool:
        """No unsuppressed error-severity findings (warn/info do not
        fail the gate; they are still printed and serialized)."""
        return not self.unsuppressed("error")

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            if not f.suppressed:
                out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA_VERSION,
            "mode": self.mode,
            "clean": self.clean,
            "counts": self.counts(),
            "findings": [f.to_dict() for f in self.findings],
            "metrics": self.metrics,
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False,
                          default=str)

    def format_text(self, show_suppressed: bool = False) -> str:
        lines = []
        for f in self.findings:
            if f.suppressed and not show_suppressed:
                continue
            lines.append(f.format())
        n_err = len(self.unsuppressed("error"))
        n_warn = len(self.unsuppressed("warn"))
        n_sup = sum(1 for f in self.findings if f.suppressed)
        lines.append(f"{self.mode or 'staticcheck'}: {n_err} error(s), "
                     f"{n_warn} warning(s), {n_sup} suppressed -- "
                     f"{'CLEAN' if self.clean else 'FINDINGS'}")
        return "\n".join(lines)
