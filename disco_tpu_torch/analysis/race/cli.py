"""``disco-torch-race`` — the thread-contract analyzer's command line.

Exit codes mirror ``disco-torch-lint``: 0 clean, 1 unsuppressed findings, 2
usage error.  Hermetic by construction: stdlib + ``disco_tpu_torch.analysis``
only, no torch or jax import anywhere (pinned by test): it reads the
sources, touches no device and takes no ``--device``, so it runs the same
on a host without a card as beside a process that holds one.  The port's
copy of ``disco_tpu/analysis/race/cli.py``, with its flags.

``--update`` regenerates the committed concurrency manifest
(``analysis/golden/threads.json``) after an *intended* topology change —
a new thread, a role acquiring a new lock; commit the diff with a message
saying WHAT changed in the threading topology and why.

No reference counterpart: the reference repo has no static analysis.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    """The disco-torch-race argument parser (no reference counterpart)."""
    p = argparse.ArgumentParser(
        prog="disco-torch-race",
        description=(
            "Static thread-contract analyzer: role-rooted call graph, "
            "torch-reachability, signal-handler safety, lock order and the "
            "committed concurrency manifest.  Targets: disco_tpu_torch/, "
            "chip_smoke.py (whole-program — no path arguments).  Reads "
            "sources only: no device, no --device."
        ),
    )
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="report format (json is the machine contract, "
                        "same key shape as disco-torch-lint)")
    p.add_argument("--update", action="store_true",
                   help="regenerate analysis/golden/threads.json instead "
                        "of diffing against it; commit the result")
    p.add_argument("--no-suppressions", action="store_true",
                   help="ignore suppression comments and report everything "
                        "(audit mode: shows what the shipped waivers hold "
                        "back)")
    p.add_argument("--show-suppressed", action="store_true",
                   help="text format: also list justified suppressions")
    p.add_argument("--list-checks", action="store_true",
                   help="print the check catalog and exit")
    return p


def main(argv=None) -> int:
    """Entry point (console script ``disco-torch-race`` / ``python -m
    disco_tpu_torch.analysis.race.cli``).  No reference counterpart."""
    args = build_parser().parse_args(argv)
    from disco_tpu_torch.analysis import report
    from disco_tpu_torch.analysis.race import runner
    from disco_tpu_torch.analysis.race.checks import CHECKS, HYGIENE_RULE

    if args.list_checks:
        print(f"{HYGIENE_RULE[0]} {HYGIENE_RULE[1]:<24} "
              "malformed/unjustified/unused suppression comments "
              "(engine rule)")
        for cid, (name, summary) in sorted(CHECKS.items()):
            print(f"{cid} {name:<24} {summary}")
        return 0

    if args.update:
        # ONE analysis both writes the manifest and judges the findings
        # (everything except drift, which --update just redefined)
        path, result = runner.update_golden(
            use_suppressions=not args.no_suppressions)
        print(f"disco-torch-race: wrote {path}")
    else:
        result = runner.analyze(use_suppressions=not args.no_suppressions)

    if args.format == "json":
        print(report.format_json(result))
    else:
        print(_format_text(report, result, args.show_suppressed))
    return 0 if result.clean else 1


def _format_text(report, result, verbose) -> str:
    """The disco-torch-lint text format with the tool name corrected in the
    summary line."""
    text = report.format_text(result, verbose_suppressed=verbose)
    head, sep, tail = text.rpartition("disco-torch-lint:")
    return f"{head}disco-torch-race:{tail}" if sep else text


if __name__ == "__main__":
    sys.exit(main())
