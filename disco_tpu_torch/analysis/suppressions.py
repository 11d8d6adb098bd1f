"""Suppression comments: per-line and per-file, justification REQUIRED.

Syntax (the ``--`` separator and a non-empty justification are mandatory —
an unexplained suppression is itself a finding, ``DL000``)::

    x = risky()  # disco-torch-lint: disable=DL004 -- why this one is safe
    # disco-torch-lint: disable=DL002,DL003 -- applies to the NEXT line
    # disco-torch-lint: file-disable=DL001 -- whole-file waiver, stated once

A trailing comment suppresses findings reported on its own line; a comment
on a line of its own suppresses the next line (for calls too long to share
a line).  ``file-disable`` waives the rule for the whole file.  Unknown
rule ids and suppressions that no finding actually needed are reported as
``DL000`` — dead waivers hide regressions exactly like dead code.

No reference counterpart: the reference repo has no static analysis; the
syntax follows the ``# noqa``/``# pylint: disable`` lineage with the
justification made load-bearing instead of optional.  The port's copy of
``disco_tpu/analysis/suppressions.py``: the same grammar under the port's
own markers, so a port waiver is never read by the JAX gates (whose
``# disco-lint:`` / ``# disco-race:`` markers the ``disco-torch-*`` names
do not match) and a JAX waiver never silences a port finding.

The machinery is shared by every analyzer in this package: ``tool``
selects the comment marker (``disco-torch-lint`` by default;
``disco-torch-race`` passes its own name and hygiene rule id), so the race
analyzer's waivers carry exactly the same syntax, the same mandatory
justification and the same dead-waiver policing without a second
implementation.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize

from disco_tpu_torch.analysis.findings import Finding
from disco_tpu_torch.analysis.registry import SUPPRESSION_RULE_ID, SUPPRESSION_RULE_NAME


def _pattern(tool: str):
    return re.compile(
        rf"#\s*{re.escape(tool)}:\s*(?P<kind>file-disable|disable)\s*=\s*"
        r"(?P<ids>[A-Za-z0-9_,\s-]*?)\s*(?:--\s*(?P<just>.*))?$"
    )


def _marker(tool: str):
    return re.compile(rf"#\s*{re.escape(tool)}\b")


@dataclasses.dataclass
class Suppression:
    """One parsed waiver (line=None for file-wide)."""

    rule_id: str
    line: int | None     # the line findings must sit on; None = whole file
    comment_line: int    # where the comment itself lives (for DL000 reports)
    justification: str
    used: bool = False


def _hygiene(path, line, message, hygiene_rule=None) -> Finding:
    rid, name = hygiene_rule or (SUPPRESSION_RULE_ID, SUPPRESSION_RULE_NAME)
    return Finding(path=path, line=line, col=0, rule=rid,
                   name=name, message=message)


def parse(rel: str, source: str, known_ids: frozenset,
          tool: str = "disco-torch-lint", hygiene_rule=None):
    """Extract suppressions from ``source``.

    Returns ``(suppressions, problems)`` — ``problems`` are hygiene-rule
    findings (DL000 for disco-torch-lint, DR000 for disco-torch-race) for malformed
    comments (bad syntax, unknown rule id, missing justification).  A
    malformed comment suppresses nothing: failing open would let a typo
    silently waive a rule.  ``tool`` selects the comment marker
    (``# <tool>: disable=...``); ``hygiene_rule`` is the ``(id, name)``
    pair the problems are reported under.
    """
    sups: list = []
    problems: list = []
    code_lines = set()     # lines carrying non-comment tokens
    comments = []          # (line, text)
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                comments.append((tok.start[0], tok.string))
            elif tok.type not in (
                tokenize.NL, tokenize.NEWLINE, tokenize.INDENT,
                tokenize.DEDENT, tokenize.ENDMARKER,
            ):
                code_lines.add(tok.start[0])
    except tokenize.TokenError:
        # ast.parse succeeded upstream, so this should be unreachable;
        # degrade to "no suppressions" rather than crash the linter.
        return [], []

    hyg_id = (hygiene_rule or (SUPPRESSION_RULE_ID, SUPPRESSION_RULE_NAME))[0]
    marker, pattern = _marker(tool), _pattern(tool)
    sample = "DLnnn" if tool == "disco-torch-lint" else "DRnnn"
    for line, text in comments:
        if not marker.search(text):
            continue
        m = pattern.search(text)
        if not m:
            problems.append(_hygiene(
                rel, line,
                f"malformed {tool} comment (expected "
                f"'# {tool}: disable={sample}[,{sample}] -- justification')",
                hygiene_rule,
            ))
            continue
        ids = [s.strip() for s in m.group("ids").split(",") if s.strip()]
        just = (m.group("just") or "").strip()
        ok = True
        if not ids:
            problems.append(_hygiene(rel, line, "suppression names no rule ids",
                                     hygiene_rule))
            ok = False
        for rid in ids:
            if rid not in known_ids:
                problems.append(_hygiene(
                    rel, line, f"suppression names unknown rule id {rid!r}",
                    hygiene_rule))
                ok = False
            elif rid == hyg_id:
                problems.append(_hygiene(
                    rel, line, f"{hyg_id} (suppression hygiene) cannot be suppressed",
                    hygiene_rule))
                ok = False
        if not just:
            problems.append(_hygiene(
                rel, line,
                "suppression carries no justification (policy: every waiver "
                "states WHY the flagged code honors the contract anyway)",
                hygiene_rule,
            ))
            ok = False
        if not ok:
            continue
        if m.group("kind") == "file-disable":
            target = None
        else:
            # trailing comment -> this line; standalone comment -> next line
            target = line if line in code_lines else line + 1
        for rid in ids:
            sups.append(Suppression(rule_id=rid, line=target,
                                    comment_line=line, justification=just))
    return sups, problems


def apply(findings, suppressions):
    """Partition ``findings`` into (kept, suppressed-with-justification).

    Marks each matching suppression ``used``; call :func:`unused_problems`
    afterwards for the dead-waiver findings.
    """
    kept, suppressed = [], []
    for f in findings:
        hit = None
        for s in suppressions:
            if s.rule_id == f.rule and (s.line is None or s.line == f.line):
                hit = s
                s.used = True
                break
        if hit is None:
            kept.append(f)
        else:
            suppressed.append((f, hit.justification))
    return kept, suppressed


def unused_problems(rel: str, suppressions, hygiene_rule=None) -> list:
    """Hygiene findings for waivers that matched nothing."""
    return [
        _hygiene(
            rel, s.comment_line,
            f"unused suppression of {s.rule_id} (no finding on "
            f"{'this file' if s.line is None else f'line {s.line}'}): "
            "remove it, or the contract it waives has silently drifted",
            hygiene_rule,
        )
        for s in suppressions
        if not s.used
    ]
