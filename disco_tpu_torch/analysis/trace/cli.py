"""``disco-torch-trace`` — the program-contract checker's command line
(counterpart of ``disco-trace``).

Exit codes: 0 clean, 1 findings, 2 usage error.  It traces the port's
programs for the card on fake tensors and needs no card.  ``--update``
rewrites the goldens under ``disco_tpu_torch/analysis/golden/`` after an
intended program change (or a torch upgrade); commit them with a message
saying what changed in the program.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    """The command line's argument parser."""
    p = argparse.ArgumentParser(
        prog="disco-torch-trace",
        description="operator-level program-contract checker of the port: golden "
                    "fingerprints, retrace budgets, dtype and donation audits over the "
                    "catalog programs, traced for the card on fake tensors.")
    p.add_argument("--update", action="store_true",
                   help="rewrite the golden fingerprints instead of diffing (audits still "
                        "run); commit the result")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="report format (json is the machine contract)")
    p.add_argument("--program", "--programs", dest="programs", default=None,
                   help="comma-separated program names (default: all; budgets run only on a "
                        "full check)")
    p.add_argument("--no-budgets", action="store_true", help="skip the retrace-budget workload")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default): trace for the card on fake tensors, no card needed; "
                        "cpu: trace the CPU route and hold it to the card's goldens on the "
                        "kernel ops, outputs and host syncs")
    p.add_argument("--list", "--list-programs", dest="list_programs", action="store_true",
                   help="print the program catalog and exit")
    return p


def main(argv=None) -> int:
    """Entry point (console script ``disco-torch-trace``)."""
    args = build_parser().parse_args(argv)
    from disco_tpu_torch.analysis.trace import check

    if args.list_programs:
        from disco_tpu_torch.analysis.trace.programs import PROGRAMS

        for name, spec in PROGRAMS.items():
            print(f"{name:<26} {spec.summary}{' [donated]' if spec.donate else ''}")
        return 0
    programs = None
    if args.programs:
        programs = {s.strip() for s in args.programs.split(",") if s.strip()}
    try:
        result = check.run_checks(update=args.update, programs=programs,
                                  budgets=not args.no_budgets and programs is None,
                                  device=args.device)
    except (KeyError, ValueError) as e:
        print(f"disco-torch-trace: {e.args[0]}", file=sys.stderr)
        return 2
    print(check.format_json(result) if args.format == "json" else check.format_text(result))
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
