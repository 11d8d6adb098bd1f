"""Text and JSON reporters for lint results (the port's copy of
``disco_tpu/analysis/report.py``: the same JSON schema, so one reader
takes either gate's report).

No reference counterpart: the reference repo has no static analysis.  The
JSON document is the machine contract (``disco-torch-lint --format json``) — its
top-level keys (``findings``/``suppressed``/``counts``/``clean``) are
consumed by CI tooling and pinned by tests; stdout stays exactly one
document per run in either format.
"""
from __future__ import annotations

import json


def format_text(result, verbose_suppressed: bool = False) -> str:
    """Human-readable report: one ``path:line:col: DLnnn [...]`` line per
    finding plus a one-line summary (and, optionally, the justified
    waivers)."""
    lines = [f.render() for f in result.findings]
    if verbose_suppressed and result.suppressed:
        lines.append("suppressed (justified):")
        lines.extend(
            f"  {f.render()}  -- {just}" for f, just in result.suppressed
        )
    lines.append(
        f"disco-torch-lint: {len(result.findings)} finding(s), "
        f"{len(result.suppressed)} suppressed, {result.n_files} file(s) scanned"
    )
    return "\n".join(lines)


def format_json(result) -> str:
    """Machine-readable report (one JSON document)."""
    per_rule: dict = {}
    for f in result.findings:
        per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
    return json.dumps(
        {
            "clean": result.clean,
            "counts": {
                "findings": len(result.findings),
                "suppressed": len(result.suppressed),
                "files": result.n_files,
                "by_rule": per_rule,
            },
            "findings": [f.to_dict() for f in result.findings],
            "suppressed": [
                {**f.to_dict(), "justification": just}
                for f, just in result.suppressed
            ],
        },
        indent=2,
    )
