"""The meter gate: cost manifests vs goldens, budgets, registry sync
(counterpart of ``disco_tpu/analysis/meter/check.py``).

Every catalog program is traced as the trace gate traces it, costed by
:mod:`.costmodel`, and its manifest diffed against the one committed under
``disco_tpu_torch/analysis/golden/cost/``.  On top: the unmodeled ceilings
and the fused-vs-eigh cross budgets (:mod:`.budgets`; ``--update``
refuses a manifest that breaches its own budget), and the registry sync —
every catalog program has a manifest and every manifest names a program.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from disco_tpu_torch.analysis.trace.check import GOLDEN_DIR as _TRACE_GOLDEN_DIR

#: where the committed cost manifests live
GOLDEN_DIR = _TRACE_GOLDEN_DIR / "cost"


@dataclasses.dataclass
class MeterResult:
    """Everything one gate run produced.  ``findings``: dicts with
    ``program``, ``check`` (``manifest``/``golden``/``budget``/``cross``/
    ``registry``) and ``message``."""

    findings: list
    reports: dict
    n_programs: int
    updated: list

    @property
    def clean(self) -> bool:
        return not self.findings


def _finding(program: str, check: str, message: str) -> dict:
    return {"program": program, "check": check, "message": message}


def golden_path(name: str, golden_dir: Path | None = None) -> Path:
    """Where program ``name``'s committed golden lives."""
    return (golden_dir or GOLDEN_DIR) / f"{name}.json"


def load_golden(name: str, golden_dir: Path | None = None) -> dict | None:
    """Program ``name``'s committed golden, or None when there is none."""
    path = golden_path(name, golden_dir)
    return json.loads(path.read_text()) if path.is_file() else None


def run_checks(update: bool = False, programs=None, golden_dir: Path | None = None,
               reports: dict | None = None) -> MeterResult:
    """Run the gate.  ``update=True`` rewrites the manifests (budgets still
    run).  The registry sync and the cross budgets run on a full pass only.
    ``reports`` replaces the costing of the named programs (the tests
    break a program's report to see the gate fail)."""
    from disco_tpu_torch.analysis.meter import budgets, costmodel
    from disco_tpu_torch.analysis.trace.check import select
    from disco_tpu_torch.analysis.trace.programs import PROGRAMS

    golden_dir = golden_dir or GOLDEN_DIR
    findings: list = []
    out: dict = {}
    updated: list = []
    for name, spec in select(programs).items():
        report = (reports or {}).get(name) or costmodel.cost_of_spec(spec)
        out[name] = report
        budget_msgs = budgets.check_unmodeled(report)
        findings += [_finding(name, "budget", m) for m in budget_msgs]
        if update:
            if budget_msgs:
                findings.append(_finding(name, "golden", "refusing to write a manifest that "
                                         "breaches its own unmodeled budget"))
            else:
                golden_dir.mkdir(parents=True, exist_ok=True)
                golden_path(name, golden_dir).write_text(costmodel.dumps(report))
                updated.append(name)
        else:
            golden = load_golden(name, golden_dir)
            if golden is None:
                findings.append(_finding(name, "golden", f"no committed cost manifest at "
                                         f"{golden_path(name, golden_dir)} — generate one with "
                                         "`disco-torch-meter --update` and commit it"))
            else:
                findings += [_finding(name, "manifest", line)
                             for line in costmodel.diff_reports(golden, report)]
    if programs is None:
        findings += [_finding("-", "cross", m) for m in budgets.check_cross(out)]
        committed = {p.stem for p in golden_dir.glob("*.json")}
        for name in sorted(set(PROGRAMS) - committed - set(updated)):
            findings.append(_finding(name, "registry", "program is in the trace catalog but "
                                     "has no cost manifest — run `disco-torch-meter --update`"))
        for stem in sorted(committed - set(PROGRAMS)):
            findings.append(_finding(stem, "registry", "stale cost manifest: no such program "
                                     f"in the trace catalog — delete {golden_path(stem, golden_dir)}"))
    return MeterResult(findings=findings, reports=out, n_programs=len(out), updated=updated)


def format_text(result: MeterResult) -> str:
    """Human-readable gate report (one line per program + findings)."""
    lines = []
    bad = {f["program"] for f in result.findings if f["check"] in ("manifest", "golden")}
    for name, rep in result.reports.items():
        ai = rep.get("arithmetic_intensity")
        islands = ",".join(k.split("::")[1] for k in rep.get("fused_islands", ())) or "-"
        lines.append(f"manifest {name:<24} {'DRIFT' if name in bad else 'ok':>5}  "
                     f"{rep['flops']:>13,d} flops  {rep['traffic_bytes']:>13,d} B  "
                     f"AI={ai if ai is not None else '-':<10}  islands[{islands}]  "
                     f"unmodeled={rep['unmodeled']['traffic_fraction']}")
    if result.updated:
        lines.append("updated manifests: " + ", ".join(result.updated))
    for f in result.findings:
        lines.append(f"FINDING [{f['check']}] {f['program']}: {f['message']}")
    lines.append(f"disco-torch-meter: {len(result.findings)} finding(s), "
                 f"{result.n_programs} program(s) metered")
    return "\n".join(lines)


def format_json(result: MeterResult) -> str:
    """Machine-readable report (``clean``/``counts``/``findings`` + the
    manifests)."""
    per_check: dict = {}
    for f in result.findings:
        per_check[f["check"]] = per_check.get(f["check"], 0) + 1
    return json.dumps({
        "clean": result.clean,
        "counts": {"findings": len(result.findings), "programs": result.n_programs,
                   "by_check": per_check},
        "findings": result.findings,
        "reports": result.reports,
        "updated": result.updated,
    }, indent=2)


def main(argv=None) -> int:
    """Run every check and print the report; 0 when clean, 1 otherwise."""
    result = run_checks()
    print(format_text(result))
    return 0 if result.clean else 1


if __name__ == "__main__":
    raise SystemExit(main())
