"""The race engine: collect sources, build the model, run checks, apply
suppressions (the port's copy of ``disco_tpu/analysis/race/runner.py``).

Whole-program by design (a thread contract is a statement about what a
role can REACH, not about one file), which is the one structural
difference from the per-file disco-torch-lint engine; everything else — finding
shape, suppression syntax, JSON schema — is shared with
:mod:`disco_tpu_torch.analysis`.

No reference counterpart: the reference repo has no static analysis.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from disco_tpu_torch.analysis import suppressions as sup
from disco_tpu_torch.analysis.findings import Finding
from disco_tpu_torch.analysis.race import manifest as manifest_mod
from disco_tpu_torch.analysis.race import roles as race_roles
from disco_tpu_torch.analysis.race.callgraph import Index
from disco_tpu_torch.analysis.race.checks import CHECKS, HYGIENE_RULE, Analysis, run_checks
from disco_tpu_torch.analysis.runner import collect_files, repo_root


def known_check_ids() -> frozenset:
    """Every id a ``# disco-torch-race:`` suppression may name."""
    return frozenset(CHECKS) | {HYGIENE_RULE[0]}


@dataclasses.dataclass
class RaceResult:
    """Everything one race-analysis run produced (the JSON reporter of
    :mod:`disco_tpu_torch.analysis.report` renders this shape directly — same
    machine contract as disco-torch-lint)."""

    findings: list
    suppressed: list     # (Finding, justification)
    n_files: int
    manifest: dict
    outside: list = dataclasses.field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings


def collect_sources(root=None, overrides=None) -> list:
    """``[(rel, source), ...]`` over the repo's contract surface (the
    disco-torch-lint DEFAULT_TARGETS).  ``overrides`` maps rel -> replacement
    source — the revert-fixture seam: tests re-analyze the repo with ONE
    file mutated back to a buggy shape without touching the checkout."""
    root = Path(root) if root is not None else repo_root()
    overrides = dict(overrides or {})
    out = []
    seen = set()
    for path, rel in collect_files(None, root=root):
        seen.add(rel)
        if rel in overrides:
            out.append((rel, overrides.pop(rel)))
        else:
            out.append((rel, path.read_text()))
    out.extend(sorted(overrides.items()))   # synthetic extra files
    return out


def analyze(
    root=None,
    *,
    files=None,
    overrides=None,
    roles=None,
    locks=None,
    dynamic_calls=None,
    attr_types=None,
    use_suppressions: bool = True,
    golden=None,
) -> RaceResult:
    """Run the full analysis.

    Defaults analyze the real repo against the shipped registries and the
    committed manifest.  Tests inject miniature programs via ``files``
    (``[(rel, source), ...]``) with their own ``roles``/``locks``/
    ``dynamic_calls``/``attr_types``, and ``golden=False`` skips the
    manifest diff (``golden`` may also be a dict to diff against).

    No reference counterpart (module docstring).
    """
    if files is None:
        files = collect_sources(root, overrides=overrides)
    index = Index()
    if locks is not None:
        index.locks = dict(locks)
    if dynamic_calls is not None:
        index.dynamic_calls = dict(dynamic_calls)
    if attr_types is not None:
        index.attr_types = dict(attr_types)
    findings: list = []
    parsed_files: list = []
    for rel, source in files:
        try:
            index.add_module(rel, source)
            parsed_files.append((rel, source))
        except SyntaxError as e:
            findings.append(Finding(
                path=rel, line=e.lineno or 1, col=e.offset or 0,
                rule=HYGIENE_RULE[0], name=HYGIENE_RULE[1],
                message=f"file does not parse: {e.msg}"))
    an = Analysis(index, roles if roles is not None else race_roles.ROLES)
    findings.extend(run_checks(an))
    built = manifest_mod.build(an)
    if golden is not False:
        committed = golden
        if committed is None:
            committed = load_golden(root)
        findings.extend(manifest_mod.drift_findings(committed, built))
    findings.sort()
    if not use_suppressions:
        return RaceResult(findings=findings, suppressed=[],
                          n_files=len(files), manifest=built)
    return _apply_suppressions(findings, parsed_files, built)


def load_golden(root=None):
    """The committed manifest, or None when absent."""
    root = Path(root) if root is not None else repo_root()
    path = root / manifest_mod.GOLDEN_REL
    if not path.exists():
        return None
    return json.loads(path.read_text())


def _apply_suppressions(findings, files, built) -> RaceResult:
    kept: list = []
    suppressed: list = []
    by_path: dict = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    sources = dict(files)
    known = known_check_ids()
    handled = set()
    for rel, source in sources.items():
        handled.add(rel)
        sups, problems = sup.parse(rel, source, known, tool="disco-torch-race",
                                   hygiene_rule=HYGIENE_RULE)
        file_kept, file_sup = sup.apply(by_path.get(rel, []), sups)
        kept.extend(file_kept)
        kept.extend(problems)
        kept.extend(sup.unused_problems(rel, sups, hygiene_rule=HYGIENE_RULE))
        suppressed.extend(file_sup)
    for rel, fs in by_path.items():
        if rel not in handled:   # findings on non-source paths (golden)
            kept.extend(fs)
    return RaceResult(findings=sorted(kept), suppressed=suppressed,
                      n_files=len(sources), manifest=built)


def update_golden(root=None, use_suppressions: bool = True):
    """Rebuild and write the committed manifest (``disco-torch-race --update``).
    Returns ``(path, result)`` — the one analysis both produced the
    manifest and judged the findings, so the CLI never runs it twice."""
    root = Path(root) if root is not None else repo_root()
    result = analyze(root, golden=False, use_suppressions=use_suppressions)
    path = root / manifest_mod.GOLDEN_REL
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(manifest_mod.dumps(result.manifest))
    return path, result
