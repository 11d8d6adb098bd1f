"""DL006 — every public function documents its counterpart.

The port's reading of ``disco_tpu/analysis/rules/citations.py``: every
public module-level function under ``disco_tpu_torch/`` has (a) a
docstring and (b) a citation — of the reference (``file:line``, or a
reference / SURVEY.md / PARITY.md statement), of its JAX-package
counterpart (a ``disco_tpu/...py`` path, with or without its line, or the
dotted ``disco_tpu.`` module), or a statement that it has no counterpart
(``No ... counterpart: why``) — in the function docstring or, for modules
whose whole file shares one provenance, in the module docstring.

No reference counterpart: the reference repo does not document one.
"""
from __future__ import annotations

import ast
import re

from disco_tpu_torch.analysis.registry import Rule, register

#: "tango.py:189-225", "main:497", "SURVEY.md §5.1" all count as citations
_CITE = re.compile(r"[\w./-]+\.\w+:\d+|\bmain:\d+")
_MENTION = re.compile(r"\breference\b|\bSURVEY\.md\b|\bPARITY\.md\b|\bcounterpart\b", re.I)
#: the JAX package's counterpart: "disco_tpu/ops/cov_ops.py", "disco_tpu.obs"
_COUNTERPART = re.compile(r"\bdisco_tpu/[\w./-]+\.py\b|\bdisco_tpu\.\w")


def _cited(doc: str) -> bool:
    return bool(_CITE.search(doc) or _MENTION.search(doc) or _COUNTERPART.search(doc))


@register
class ReferenceCitation(Rule):
    id = "DL006"
    name = "reference-citation"
    summary = ("public function without a docstring, or whose docstring (and "
               "module docstring) never cites its reference or disco_tpu "
               "counterpart")

    def applies(self, ctx) -> bool:
        return ctx.in_dir("disco_tpu_torch")

    def check(self, ctx):
        module_ok = _cited(ctx.module_docstring())
        for node in ctx.tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name.startswith("_"):
                continue
            doc = ast.get_docstring(node)
            if doc is None:
                yield self.finding(
                    ctx, node,
                    f"public function {node.name!r} has no docstring "
                    "(every public function cites its reference or "
                    "disco_tpu counterpart)",
                )
            elif not (_cited(doc) or module_ok):
                yield self.finding(
                    ctx, node,
                    f"docstring of {node.name!r} cites no counterpart — add "
                    "'disco_tpu/<file>.py:<line>' or 'reference "
                    "<file>:<line>', or state 'No counterpart: <why>' "
                    "(function or module docstring)",
                )
