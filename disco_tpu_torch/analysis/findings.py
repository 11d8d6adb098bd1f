"""Finding: one rule violation at one source location (the port's copy of
``disco_tpu/analysis/findings.py``, field for field, so the two gates'
JSON reports share one schema).

No reference counterpart: the reference repo has no static analysis; the
shape (rule id + location + message, machine- and human-renderable) follows
the convention of production linters (flake8/ruff diagnostics).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One violation of one rule at one location.

    ``path`` is repo-relative POSIX (stable across checkouts — the JSON
    reporter is consumed by CI); ``line``/``col`` are 1-/0-based like every
    other python linter.  Ordering is (path, line, col, rule) so reports are
    deterministic without a separate sort key.
    """

    path: str
    line: int
    col: int
    rule: str       # "DL004"
    name: str       # "atomic-write"
    message: str

    def render(self) -> str:
        """``path:line:col: DLnnn [name] message`` — the text-reporter line."""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} [{self.name}] {self.message}"

    def to_dict(self) -> dict:
        """JSON-reporter payload (field names are the public schema)."""
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "name": self.name,
            "message": self.message,
        }
