"""The trace-contract gate: fingerprints vs goldens, budgets, audits
(counterpart of ``disco_tpu/analysis/trace/check.py``).

Every catalog program (:data:`~.programs.PROGRAMS`) is traced for the card
on fake tensors (or on real CPU tensors where it reads back), its
fingerprint diffed against the golden committed under
``disco_tpu_torch/analysis/golden/``; the retrace-budget workload runs
from cleared signature sets; the dtype and donation audits run over the
same programs.  Nothing runs on a card and nothing needs one.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

#: where the golden fingerprints live (committed, one JSON per program)
GOLDEN_DIR = Path(__file__).resolve().parents[1] / "golden"


@dataclasses.dataclass
class TraceResult:
    """Everything one gate run produced (the JSON reporter's payload).
    ``findings``: dicts with ``program`` (``-`` for process-wide checks),
    ``check`` (``fingerprint``/``budget``/``donation``/``dtype``/
    ``golden``) and ``message``."""

    findings: list
    fingerprints: dict
    donation: list
    budgets: dict
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


def select(programs) -> dict:
    """The catalog restricted to ``programs`` (None: all); KeyError naming
    an unknown one."""
    from disco_tpu_torch.analysis.trace.programs import PROGRAMS

    for name in programs or ():
        if name not in PROGRAMS:
            raise KeyError(f"unknown program {name!r}; known: {sorted(PROGRAMS)}")
    return {n: s for n, s in PROGRAMS.items() if programs is None or n in programs}


def run_checks(update: bool = False, programs=None, budgets: bool = True, budget_extra=None,
               device: str = "cuda", golden_dir: Path | None = None,
               donation: bool = True) -> TraceResult:
    """Run the gate.  ``update=True`` rewrites the goldens instead of
    diffing (the audits still run: a golden with a device float64 leak is
    refused).  ``programs`` restricts the fingerprint and audit passes;
    ``budgets=False`` skips the workload.  ``device='cpu'`` traces the CPU
    route (the kernels' plain versions inside the same ops) and holds it to
    the card's goldens on what the two routes share: the kernel ops and
    their counts, the output signature and the host syncs."""
    from disco_tpu_torch.analysis.trace import audits, fingerprint

    cpu_route = torch.device(device).type == "cpu"
    if update and cpu_route:
        raise ValueError("the goldens are the card's: --update traces for the card, not the CPU")
    golden_dir = golden_dir or GOLDEN_DIR
    findings: list = []
    fps: dict = {}
    dons: list = []
    updated: list = []
    for name, spec in select(programs).items():
        fp = fingerprint.fingerprint_program(spec, device)
        fps[name] = fp
        dtype_msgs = audits.audit_dtypes(name, fp)
        findings += [_finding(name, "dtype", m) for m in dtype_msgs]
        if update:
            if dtype_msgs:
                findings.append(_finding(name, "golden", "refusing to write a golden whose "
                                         "fingerprint fails the dtype audit"))
            else:
                golden_dir.mkdir(parents=True, exist_ok=True)
                golden_path(name, golden_dir).write_text(fingerprint.dumps(fp))
                updated.append(name)
        else:
            golden = load_golden(name, golden_dir)
            if golden is None:
                findings.append(_finding(
                    name, "golden", f"no committed golden at {golden_path(name, golden_dir)} — "
                    "generate one with `disco-torch-trace --update` and commit it"))
            elif cpu_route:
                keys = [k for k in fingerprint.PORTABLE_KEYS if k != "f64"]
                findings += [_finding(name, "fingerprint", line)
                             for line in fingerprint.portable_diff(golden, fp, keys)]
            else:
                findings += [_finding(name, "fingerprint", line)
                             for line in fingerprint.diff_fingerprints(golden, fp)]
        if donation and spec.donate is not None:
            rep = audits.audit_donation(spec)
            dons.append(rep)
            if not rep["ok"]:
                findings.append(_finding(
                    name, "donation",
                    f"what donation buys does not hold: {rep['held_to_contract']} of "
                    f"{rep['declared_tensors']} carried tensors {rep['kind']} — {rep['note']}"))
    counts: dict = {}
    if budgets and not update:
        from disco_tpu_torch.analysis.trace import budgets as budgets_mod

        lines, counts = budgets_mod.check_budgets(extra=budget_extra)
        findings += [_finding("-", "budget", line) for line in lines]
    return TraceResult(findings=findings, fingerprints=fps, donation=dons, budgets=counts,
                       n_programs=len(fps), updated=updated)


def format_text(result: TraceResult) -> str:
    """Human-readable gate report (one line per program + findings)."""
    lines = []
    bad = {f["program"] for f in result.findings if f["check"] in ("fingerprint", "golden")}
    for name, fp in result.fingerprints.items():
        kernels = ",".join(f"{k.split('::')[1]}×{n}" for k, n in fp["kernel_ops"].items()) or "-"
        lines.append(f"fingerprint {name:<24} {'DRIFT' if name in bad else 'ok':>5}  "
                     f"{fp['n_ops']:>5} ops  {fp['traced']:<9} kernels[{kernels}]  "
                     f"syncs={fp['host_syncs']['scalar_reads']}+{fp['host_syncs']['d2h_copies']}"
                     f"  churn={fp['copy_churn']}")
    for rep in result.donation:
        lines.append(f"donation    {rep['program']:<24} {'ok' if rep['ok'] else 'FAIL':>5}  "
                     f"{rep['held_to_contract']}/{rep['declared_tensors']} {rep['kind']}; "
                     f"peak extra {rep['peak_extra_bytes']} B")
    if result.budgets:
        from disco_tpu_torch.analysis.trace.budgets import BUDGETS

        lines.append("budgets: " + "  ".join(f"{label}={n}/{BUDGETS[label]}"
                                            for label, n in sorted(result.budgets.items())))
    if result.updated:
        lines.append("updated goldens: " + ", ".join(result.updated))
    for f in result.findings:
        lines.append(f"FINDING [{f['check']}] {f['program']}: {f['message']}")
    lines.append(f"disco-torch-trace: {len(result.findings)} finding(s), "
                 f"{result.n_programs} program(s) checked")
    return "\n".join(lines)


def format_json(result: TraceResult) -> str:
    """Machine-readable report: the ``disco-lint --format json`` contract
    (``clean``/``counts``/``findings``) plus the per-program payloads."""
    per_check: dict = {}
    for f in result.findings:
        per_check[f["check"]] = per_check.get(f["check"], 0) + 1
    return json.dumps({
        "clean": result.clean,
        "counts": {"findings": len(result.findings), "programs": result.n_programs,
                   "by_check": per_check},
        "findings": result.findings,
        "fingerprints": result.fingerprints,
        "donation": result.donation,
        "budgets": result.budgets,
        "updated": result.updated,
    }, indent=2)


def main(argv=None) -> int:
    """The full gate, text report, exit 1 on findings."""
    result = run_checks()
    print(format_text(result))
    return 0 if result.clean else 1


if __name__ == "__main__":
    raise SystemExit(main())
