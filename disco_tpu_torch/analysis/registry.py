"""Rule base class and the process-global rule registry (the port's copy
of ``disco_tpu/analysis/registry.py``).

No reference counterpart: the reference repo has no static analysis.  The
decorator-registry shape mirrors the port's other closed registries (obs
``EVENT_KINDS``, chaos ``SEAMS``): a rule is registered once at import of
:mod:`disco_tpu_torch.analysis.rules` and addressed by a stable ``DLnnn``
id — the same ids, names and order as the JAX package's ``disco-lint``.
"""
from __future__ import annotations


class Rule:
    """One invariant checker.

    Subclasses set ``id`` ("DL004"), ``name`` (kebab-case slug), ``summary``
    (one line for ``--list-rules`` and the docs), and implement
    :meth:`check` yielding :class:`~disco_tpu_torch.analysis.findings.Finding`.
    ``applies`` pre-filters by file so ``check`` can assume its scope.
    """

    id: str = ""
    name: str = ""
    summary: str = ""

    def applies(self, ctx) -> bool:
        """Whether this rule runs on ``ctx`` at all (default: every file)."""
        return True

    def check(self, ctx):
        """Yield findings for one :class:`FileContext`."""
        raise NotImplementedError

    def finding(self, ctx, node, message):
        """Build a Finding anchored at an AST node of ``ctx``."""
        from disco_tpu_torch.analysis.findings import Finding

        return Finding(
            path=ctx.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            rule=self.id,
            name=self.name,
            message=message,
        )


#: id -> Rule instance, in registration (= documentation) order.
RULES: dict = {}

#: The engine-level suppression-hygiene pseudo-rule id (emitted by the
#: runner, not a Rule subclass; it cannot itself be suppressed).
SUPPRESSION_RULE_ID = "DL000"
SUPPRESSION_RULE_NAME = "lint-suppression"


def register(cls):
    """Class decorator: instantiate and register a :class:`Rule`."""
    inst = cls()
    if not inst.id or not inst.name:
        raise ValueError(f"rule {cls.__name__} must set id and name")
    if inst.id in RULES:
        raise ValueError(f"duplicate rule id {inst.id}")
    RULES[inst.id] = inst
    return cls


def get_rules() -> dict:
    """The populated registry (importing the rule modules on first use)."""
    import disco_tpu_torch.analysis.rules  # noqa: F401  (registers on import)

    return RULES


def known_rule_ids() -> frozenset:
    """Every id a suppression comment may name (rules + DL000)."""
    return frozenset(get_rules()) | {SUPPRESSION_RULE_ID}
