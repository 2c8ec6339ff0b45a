"""Static and runtime analysis for mxnet_tpu_torch: a program auditor
over the aten ops and kernel launches of the port's captured programs, a
framework-aware source linter, a concurrency sanitizer over the port's
threads, and a deterministic schedule fuzzer
(``tools/torch_staticcheck.py``).

Counterpart of ``mxnet_tpu/analysis`` with its names.  Three rule ids of
the JAX auditor have no meaning here and stay data only
(:data:`RESERVED_RULES`): ``program.donation-miss`` and
``program.donation-alias`` (a captured graph donates no buffer) and
``program.carry-sharding`` (a mesh member holds whole tensors).

Quick start::

    from mxnet_tpu_torch import analysis
    report = analysis.audit_trainer(trainer)        # typed findings
    analysis.assert_program_clean(trainer)          # pytest helper
    with analysis.audit_on_compile() as report:     # the captured programs
        trainer.compile(programs=("train",))
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
from .program import (AuditConfig, assert_program_clean, audit_executor,
                      audit_module, audit_on_compile, audit_optimizer,
                      audit_traced, audit_trainer, mark_grads, tag,
                      update_passes)
from .source import (ENV_PREFIX, documented_env_vars, env_reads_in_source,
                     lint_file, lint_paths)

__all__ = [
    "Finding", "Report", "RULES", "RESERVED_RULES", "SCHEMA_VERSION",
    "apply_cli", "apply_inline", "parse_inline_suppressions",
    "AuditConfig", "assert_program_clean", "audit_executor",
    "audit_module", "audit_on_compile", "audit_optimizer",
    "audit_traced", "audit_trainer", "mark_grads", "tag",
    "update_passes",
    "ENV_PREFIX", "documented_env_vars", "env_reads_in_source",
    "lint_file", "lint_paths",
    "ScheduleFuzzer", "ThreadAudit", "analyze_events",
    "audit_threads", "run_schedules",
]
