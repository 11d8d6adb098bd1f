"""disco_tpu_torch.analysis — the port's program contracts, cost model and
AST invariant checking (counterpart of ``disco_tpu/analysis``).

* :mod:`.trace` — ``disco-torch-trace``: golden fingerprints of the
  catalog programs traced for the card, retrace budgets, dtype and
  donation audits;
* :mod:`.meter` — ``disco-torch-meter``: cost manifests, budgets and the
  stage costs the roofline (``obs.roofline``) joins with measured times;
* the linter, ``disco-torch-lint`` (the JAX package's ``disco-lint``,
  rules DL000–DL016 re-read for torch on the card): :mod:`.registry`
  (Rule base class + ``DLnnn`` registry), :mod:`.rules` (the rule
  implementations, catalog in its docstring), :mod:`.suppressions`
  (``# disco-torch-lint: disable=... -- justification``),
  :mod:`.registries` (EVENT_KINDS / SEAMS / SPAN_STAGES /
  STATUS_SECTIONS read by parsing), :mod:`.runner` (:func:`lint_paths`),
  :mod:`.report` and :mod:`.cli`;
* :mod:`.race` — ``disco-torch-race``: the thread-contract analyzer
  (DR000–DR008) over the port's declared thread roles and locks.

The linter and :mod:`.race` are stdlib-only: they import no torch, no jax
and nothing of ``disco_tpu`` (the port keeps its own copies), read the
sources by parsing, touch no device and take no ``--device``.
:mod:`.trace` and :mod:`.meter` import torch, so nothing in the linter
imports them.

No reference counterpart: the reference repo has no static analysis of any
kind (SURVEY.md documents no tooling beyond setup.py).
"""
from disco_tpu_torch.analysis.findings import Finding
from disco_tpu_torch.analysis.registry import RULES, Rule, get_rules, register
from disco_tpu_torch.analysis.runner import (
    DEFAULT_TARGETS,
    LintResult,
    lint_paths,
    lint_source,
    repo_root,
)

__all__ = [
    "DEFAULT_TARGETS",
    "Finding",
    "LintResult",
    "RULES",
    "Rule",
    "get_rules",
    "lint_paths",
    "lint_source",
    "register",
    "repo_root",
]
