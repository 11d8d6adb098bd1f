"""The lint engine: collect files, run rules, apply suppressions (the
port's copy of ``disco_tpu/analysis/runner.py``).

No reference counterpart: the reference repo has no static analysis.  The
engine is deliberately import-light — stdlib only: no torch, no jax, no
``disco_tpu`` module and no production ``disco_tpu_torch`` module — so
``disco-torch-lint`` runs hermetically on any host, with or without a card,
and never initializes CUDA.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

from disco_tpu_torch.analysis import suppressions as sup
from disco_tpu_torch.analysis.context import FileContext
from disco_tpu_torch.analysis.findings import Finding
from disco_tpu_torch.analysis.registry import get_rules, known_rule_ids

#: what ``disco-torch-lint`` scans by default, repo-root relative — the
#: port's package and ``chip_smoke.py``, the script that drives it on the
#: card (the contract surface, not the tests).
DEFAULT_TARGETS = ("disco_tpu_torch", "chip_smoke.py")


def repo_root() -> Path:
    """The checkout root: the directory containing the ``disco_tpu_torch``
    package this module was imported from."""
    return Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class LintResult:
    """Everything one lint run produced.

    ``findings`` are the unsuppressed (gate-failing) ones; ``suppressed``
    pairs each waived finding with its justification; ``n_files`` is the
    scan breadth for the summary line.
    """

    findings: list
    suppressed: list   # (Finding, justification)
    n_files: int
    #: targets that resolved OUTSIDE the repo root: they are linted, but
    #: the repo-path-scoped rules (DL002/DL004/DL005/DL006 scoping) cannot
    #: apply to them — the CLI warns so a "clean" result is not misread.
    #: Use :func:`lint_source` with a synthetic ``rel`` to lint a snippet
    #: "as" an in-repo path.
    outside: list = dataclasses.field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings


def collect_files(paths=None, root: Path | None = None) -> list:
    """Expand targets to ``(abspath, rel)`` pairs, sorted for determinism.

    ``paths`` defaults to :data:`DEFAULT_TARGETS` resolved against the repo
    root; directories are walked for ``*.py``.  A default target that does
    not exist (an installed package without ``chip_smoke.py``) is skipped;
    an explicitly named missing path raises.
    """
    root = Path(root) if root is not None else repo_root()
    explicit = paths is not None
    out = []
    for target in paths if explicit else DEFAULT_TARGETS:
        p = Path(target)
        if not p.is_absolute():
            p = root / p
        if p.is_dir():
            out.extend((f, _rel(f, root)) for f in sorted(p.rglob("*.py")))
        elif p.is_file():
            out.append((p, _rel(p, root)))
        elif explicit:
            raise FileNotFoundError(f"lint target does not exist: {target}")
    return sorted(set(out), key=lambda pair: pair[1])


def _rel(path: Path, root: Path) -> str:
    """Repo-relative POSIX path, or the bare name for files outside the
    root (rules scoped to repo paths then cannot match — the runner records
    such targets in ``LintResult.outside`` and the CLI warns)."""
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.name


def _is_outside(path: Path, root: Path) -> bool:
    try:
        path.resolve().relative_to(root.resolve())
        return False
    except ValueError:
        return True


def lint_source(
    source: str,
    rel: str,
    root: Path | None = None,
    rules=None,
    use_suppressions: bool = True,
) -> LintResult:
    """Lint one in-memory source blob as if it lived at ``rel``.

    The test-fixture entry point: rules scope by repo-relative path, so a
    snippet can be checked "as" ``disco_tpu_torch/enhance/x.py``.  ``rules``
    optionally restricts to a set of rule ids; ``use_suppressions=False``
    reports everything (how the tests prove the shipped suppression sets
    are load-bearing).
    """
    root = Path(root) if root is not None else repo_root()
    ctx = FileContext(rel, source, root)
    active = [
        r for rid, r in get_rules().items() if (rules is None or rid in rules)
    ]
    found = []
    for rule in active:
        if rule.applies(ctx):
            found.extend(rule.check(ctx))
    if not use_suppressions:
        return LintResult(findings=sorted(found), suppressed=[], n_files=1)
    sups, problems = sup.parse(rel, source, known_rule_ids())
    kept, suppressed = sup.apply(found, sups)
    # Malformed waivers are ALWAYS reported (they suppress nothing, under
    # any filter), but a waiver only counts as "unused" if its rule
    # actually RAN — otherwise a focused `--rules DL005` run would flag
    # every other rule's shipped suppressions as dead and fail a clean repo.
    kept.extend(problems)
    active_ids = {r.id for r in active}
    kept.extend(sup.unused_problems(
        rel, [s for s in sups if s.rule_id in active_ids]))
    return LintResult(findings=sorted(kept), suppressed=suppressed, n_files=1)


def lint_paths(
    paths=None,
    root: Path | None = None,
    rules=None,
    use_suppressions: bool = True,
) -> LintResult:
    """Lint files/directories (default: the repo's contract surface,
    :data:`DEFAULT_TARGETS`).  Returns a merged :class:`LintResult`."""
    root = Path(root) if root is not None else repo_root()
    findings: list = []
    suppressed: list = []
    files = collect_files(paths, root=root)
    outside = [rel for path, rel in files if _is_outside(path, root)]
    for path, rel in files:
        try:
            source = path.read_text()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding(
                path=rel, line=1, col=0, rule="DL000", name="lint-suppression",
                message=f"unreadable source file: {e}"))
            continue
        try:
            res = lint_source(source, rel, root=root, rules=rules,
                              use_suppressions=use_suppressions)
        except SyntaxError as e:
            findings.append(Finding(
                path=rel, line=e.lineno or 1, col=e.offset or 0,
                rule="DL000", name="lint-suppression",
                message=f"file does not parse: {e.msg}"))
            continue
        findings.extend(res.findings)
        suppressed.extend(res.suppressed)
    return LintResult(findings=sorted(findings), suppressed=suppressed,
                      n_files=len(files), outside=outside)
