"""DL007 — traced-float seams take float literals, never ints.

The JAX rule (``disco_tpu/analysis/rules/tracedfloat.py``) catches the
``mu=1`` retrace trap: ``lambda_cor`` and ``mu`` are traced floats through
every jitted streaming/serve entry point, and a passed int traces a third,
int-typed program per shape bucket.  The port compiles no program per
call signature, but it keeps the contract and its counter: ``obs.accounting.
counted_jit`` counts a call signature the JAX package would trace anew,
and it counts a Python ``int`` and a ``float`` as distinct signatures
(``_signature``: the type of a scalar, whatever its value), so an int
literal for these keywords ticks ``jit_recompiles`` and breaks the
retrace budgets (``analysis/trace/budgets.py``) exactly as in JAX.  Int
literals for these keywords must be written as floats (``mu=1.0``).

No reference counterpart: the reference has no jit and no retrace hazard.
"""
from __future__ import annotations

import ast

from disco_tpu_torch.analysis.registry import Rule, register

#: the keyword seams with traced-float calling conventions
_SEAMS = ("lambda_cor", "mu")


@register
class TracedFloatLiteral(Rule):
    id = "DL007"
    name = "traced-float-literal"
    summary = ("literal int passed for lambda_cor=/mu= — a distinct "
               "counted_jit signature (an extra retrace in the budgets); "
               "write it as a float")

    def check(self, ctx):
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                # bool is an int subclass: True/False literals trip the same
                # retrace and are flagged too
                if (
                    kw.arg in _SEAMS
                    and isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, int)
                ):
                    yield self.finding(
                        ctx, kw.value,
                        f"literal {kw.value.value!r} for traced-float seam "
                        f"'{kw.arg}=': counted_jit counts an int and a float "
                        "as distinct signatures (the JAX package traces a "
                        "distinct int-typed program) — write "
                        f"{kw.arg}={float(kw.value.value)} (the mu=1 retrace "
                        "trap)",
                    )
