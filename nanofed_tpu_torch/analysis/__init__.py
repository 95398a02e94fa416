"""Static analysis, program audit and runtime contracts for round programs
(counterpart of ``nanofed_tpu/analysis/``).

Three layers, one goal — turn the execution contract of the round engine from tribal
knowledge into enforced fact:

* :mod:`nanofed_tpu_torch.analysis.fedlint` — the AST-based static pass (rules FED000-
  FED010 less the dropped FED003/FED004, pure stdlib).  Run it with ``python -m
  nanofed_tpu_torch.analysis``.
* :mod:`nanofed_tpu_torch.analysis.program_audit` — the program auditor: each rank's
  program run on meta tensors under a dispatch recorder and recorded collectives
  (collective-schedule consistency across ranks, mesh discipline, dtype drift on
  program inputs, host reads inside the program).  Zero execution.  Run it with
  ``python -m nanofed_tpu_torch.analysis --programs``, the CLI ``audit`` subcommand,
  or ``ProgramCatalog.audit()``.
* :mod:`nanofed_tpu_torch.analysis.contracts` — runtime strict mode:
  :func:`check_round_step` / :func:`check_round_block` validate a round program's
  output shapes, dtypes and structure on meta tensors without executing it, and
  :func:`strict_mode` arms ``torch.cuda.set_sync_debug_mode("error")`` around
  dispatch to prove the hot path never waits for the card (``Coordinator(
  strict=True)`` / CLI ``--strict``).

The JAX package's ``__all__`` is exported whole.
"""

from nanofed_tpu_torch.analysis.contracts import (
    ContractViolation,
    check_input_shardings,
    check_round_block,
    check_round_step,
    strict_mode,
)
from nanofed_tpu_torch.analysis.fedlint import (
    RULES,
    Diagnostic,
    lint_paths,
    lint_source,
    render_text,
)
from nanofed_tpu_torch.analysis.program_audit import (
    AUDIT_CHECKS,
    AuditFinding,
    AuditReport,
    audit_program,
    format_audit_reports,
    run_mutation_suite,
    seeded_mutants,
)

__all__ = [
    "AUDIT_CHECKS",
    "RULES",
    "AuditFinding",
    "AuditReport",
    "ContractViolation",
    "Diagnostic",
    "audit_program",
    "check_input_shardings",
    "check_round_block",
    "check_round_step",
    "format_audit_reports",
    "lint_paths",
    "lint_source",
    "render_text",
    "run_mutation_suite",
    "seeded_mutants",
    "strict_mode",
]
