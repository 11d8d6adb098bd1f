"""``disco-torch-meter`` — the cost-manifest gate's command line
(counterpart of ``disco-meter``).

Exit codes: 0 clean, 1 findings, 2 usage error.  ``--update`` rewrites the
manifests under ``disco_tpu_torch/analysis/golden/cost/`` after an
intended cost change; commit them saying what moved and why.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    """The command line's argument parser."""
    p = argparse.ArgumentParser(
        prog="disco-torch-meter",
        description="per-program cost manifests of the port (FLOPs, device-memory traffic, "
                    "live bytes, the kernels as fused islands) diffed against committed "
                    "goldens, with budget and registry-sync enforcement; no card needed.")
    p.add_argument("--update", action="store_true",
                   help="rewrite the manifests instead of diffing (budgets still run)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--program", "--programs", dest="programs", default=None,
                   help="comma-separated program names (default: all; registry sync and "
                        "cross budgets run only on a full pass)")
    p.add_argument("--list", "--list-programs", dest="list_programs", action="store_true",
                   help="print the program catalog and exit")
    return p


def main(argv=None) -> int:
    """Entry point (console script ``disco-torch-meter``)."""
    args = build_parser().parse_args(argv)
    from disco_tpu_torch.analysis.meter import check

    if args.list_programs:
        from disco_tpu_torch.analysis.trace.programs import PROGRAMS

        for name, spec in PROGRAMS.items():
            print(f"{name:<26} {spec.summary}")
        return 0
    programs = None
    if args.programs:
        programs = {s.strip() for s in args.programs.split(",") if s.strip()}
    try:
        result = check.run_checks(update=args.update, programs=programs)
    except KeyError as e:
        print(f"disco-torch-meter: {e.args[0]}", file=sys.stderr)
        return 2
    print(check.format_json(result) if args.format == "json" else check.format_text(result))
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
