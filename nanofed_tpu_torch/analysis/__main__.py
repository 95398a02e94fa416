"""``python -m nanofed_tpu_torch.analysis`` — run the analysis passes from the command
line (counterpart of ``nanofed_tpu/analysis/__main__.py``).

Default: fedlint over the given paths (default ``nanofed_tpu_torch``).  ``--programs``
also audits the reference program catalog (``analysis.program_audit``: each variant's
every rank on meta tensors, on ``--device``, default the card); ``--mutants`` runs
the mutation self-test (every seeded broken program must trigger exactly its audit
check — proof no check is vacuous).  One exit-code contract across all passes: 0
when everything is clean (or explicitly suppressed with a reason), 1 when findings
remain or a mutant fails to fire, 2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import sys

from nanofed_tpu_torch.analysis.fedlint import RULES, lint_paths, render_text


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nanofed_tpu_torch.analysis",
        description="fedlint + program audit: static analysis for federated round "
                    "programs",
    )
    parser.add_argument(
        "paths", nargs="*", default=["nanofed_tpu_torch"],
        help="files or directory trees to lint (default: nanofed_tpu_torch)",
    )
    parser.add_argument(
        "--select", default=None, metavar="FED001,FED002",
        help="comma-separated rule codes to report (default: all)",
    )
    parser.add_argument(
        "--format", choices=["text", "json"], default="text",
        help="diagnostic output format",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalogue and exit"
    )
    parser.add_argument(
        "--programs", action="store_true",
        help="also audit the reference program catalog: every rank of each variant's "
             "mesh on meta tensors, its collectives recorded",
    )
    parser.add_argument(
        "--mutants", action="store_true",
        help="run the audit mutation self-test: each seeded broken program must "
             "trigger exactly its check",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the reference catalog's tiny populations (default cuda; "
             "without a card --programs raises unless given --device cpu)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for code, title in sorted(RULES.items()):
            print(f"{code}  {title}")
        return 0

    select = None
    if args.select:
        select = {c.strip() for c in args.select.split(",") if c.strip()}
        unknown = select - set(RULES)
        if unknown:
            print(f"error: unknown rule code(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    diagnostics = lint_paths(args.paths, select=select)
    failed = bool(diagnostics)
    out: dict[str, object] = {
        "fedlint": [
            {"path": d.path, "line": d.line, "col": d.col, "code": d.code,
             "message": d.message}
            for d in diagnostics
        ]
    }
    if args.format == "text":
        print(render_text(diagnostics))

    if args.programs:
        from nanofed_tpu_torch.analysis.program_audit import (
            format_audit_reports,
            reference_catalog,
        )
        from nanofed_tpu_torch.core.device import resolve_device

        reports = reference_catalog(device=resolve_device(args.device)).audit_all()
        failed = failed or any(not r.ok for r in reports)
        out["audit"] = [r.to_dict() for r in reports]
        if args.format == "text":
            print()
            print(format_audit_reports(reports))

    if args.mutants:
        from nanofed_tpu_torch.analysis.program_audit import run_mutation_suite

        results = run_mutation_suite()
        failed = failed or any(not r["ok"] for r in results.values())
        out["mutants"] = results
        if args.format == "text":
            print()
            for name, r in results.items():
                status = "fires" if r["ok"] else (
                    f"FAILED (expected [{r['expected']}], got {r['fired']})"
                )
                print(f"{name}: {r['expected']} {status}")
            n_ok = sum(r["ok"] for r in results.values())
            print(f"mutation suite: {n_ok}/{len(results)} checks proven")

    if args.format == "json":
        # One object across all passes when the extra passes ran; the plain lint
        # invocation keeps its list-shaped output.
        if args.programs or args.mutants:
            print(json.dumps(out, indent=2, default=str))
        else:
            print(json.dumps(out["fedlint"], indent=2))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
