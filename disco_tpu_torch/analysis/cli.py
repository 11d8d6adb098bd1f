"""``disco-torch-lint`` — the AST invariant checker's command line.

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage error.  Hermetic by
construction: the linter imports nothing outside the stdlib and
``disco_tpu_torch.analysis`` (no torch, no jax), so it touches no device and
takes no ``--device``: it reads sources only, and runs the same on a host
without a card as beside a process that holds one.  The port's copy of
``disco_tpu/analysis/cli.py``, with its flags.

No reference counterpart: the reference repo has no static analysis.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    """The disco-torch-lint argument parser (no reference counterpart)."""
    p = argparse.ArgumentParser(
        prog="disco-torch-lint",
        description=(
            "AST invariant checker for the disco_tpu_torch fence/readback/"
            "atomicity/kernel-routing contracts.  Default targets: "
            "disco_tpu_torch/ and chip_smoke.py (repo-root relative).  Reads "
            "sources only: no device, no --device."
        ),
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to lint (default: the repo's "
                        "contract surface)")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="report format (json is the machine contract)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--no-suppressions", action="store_true",
                   help="ignore suppression comments and report everything "
                        "(audit mode: shows what the shipped waivers hold back)")
    p.add_argument("--show-suppressed", action="store_true",
                   help="text format: also list justified suppressions")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def main(argv=None) -> int:
    """Entry point (console script ``disco-torch-lint`` / ``python -m
    disco_tpu_torch.analysis.cli``).  No reference counterpart."""
    args = build_parser().parse_args(argv)
    from disco_tpu_torch.analysis import report, runner
    from disco_tpu_torch.analysis.registry import (
        SUPPRESSION_RULE_ID,
        SUPPRESSION_RULE_NAME,
        get_rules,
    )

    if args.list_rules:
        print(f"{SUPPRESSION_RULE_ID} {SUPPRESSION_RULE_NAME:<22} "
              "malformed/unjustified/unused suppression comments (engine rule)")
        for rid, rule in sorted(get_rules().items()):
            print(f"{rid} {rule.name:<22} {rule.summary}")
        return 0

    rules = None
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(get_rules()) - {SUPPRESSION_RULE_ID}
        if unknown:
            print(f"disco-torch-lint: unknown rule id(s): {sorted(unknown)}",
                  file=sys.stderr)
            return 2

    try:
        result = runner.lint_paths(
            paths=args.paths or None,
            rules=rules,
            use_suppressions=not args.no_suppressions,
        )
    except FileNotFoundError as e:
        print(f"disco-torch-lint: {e}", file=sys.stderr)
        return 2

    if result.outside:
        print(
            f"disco-torch-lint: warning: {len(result.outside)} target(s) outside "
            f"the repo root ({', '.join(result.outside[:3])}"
            f"{', ...' if len(result.outside) > 3 else ''}) — repo-path-"
            "scoped rules (readbacks/atomic-writes/purity/citations) do not "
            "apply to them",
            file=sys.stderr,
        )
    if args.format == "json":
        print(report.format_json(result))
    else:
        print(report.format_text(result,
                                 verbose_suppressed=args.show_suppressed))
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
