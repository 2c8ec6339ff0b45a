"""Static and runtime analysis for mxnet_tpu_torch: a framework-aware
source linter, a concurrency sanitizer over the port's threads, and a
deterministic schedule fuzzer (``tools/torch_staticcheck.py``).

Counterpart of ``mxnet_tpu/analysis`` with its names, except the program
auditor's (``audit_trainer``, ``assert_program_clean``, ...): the port's
auditor, over the aten ops a captured step dispatches, is the work that
comes next, and nothing here pretends to audit a program.  Its rule ids
stay in :data:`RULES` (:data:`RESERVED_RULES`).

Quick start::

    from mxnet_tpu_torch import analysis
    report = analysis.lint_paths(repo_root)         # AST linter
    with analysis.audit_threads() as audit:         # lockset sanitizer
        audit.track(obj, "_ring")
        ...
    analysis.run_schedules(device="cuda")           # schedule fuzzer
"""

from .concurrency import (ScheduleFuzzer, ThreadAudit, analyze_events,
                          audit_threads, run_schedules)
from .findings import (Finding, Report, RESERVED_RULES, RULES,
                       SCHEMA_VERSION, apply_cli, apply_inline,
                       parse_inline_suppressions)
from .source import (ENV_PREFIX, documented_env_vars, env_reads_in_source,
                     lint_file, lint_paths)

__all__ = [
    "Finding", "Report", "RULES", "RESERVED_RULES", "SCHEMA_VERSION",
    "apply_cli", "apply_inline", "parse_inline_suppressions",
    "ENV_PREFIX", "documented_env_vars", "env_reads_in_source",
    "lint_file", "lint_paths",
    "ScheduleFuzzer", "ThreadAudit", "analyze_events",
    "audit_threads", "run_schedules",
]
