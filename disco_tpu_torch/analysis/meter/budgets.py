"""Declared cost budgets the meter gate enforces (counterpart of
``disco_tpu/analysis/meter/budgets.py``).

* **Unmodeled-traffic ceilings** — the cost model never zeroes an op it
  does not know; the op's boundary traffic lands in the ``unmodeled``
  bucket, and this module holds that bucket's share of a program's traffic
  under a declared ceiling.  A new op in a hot path either gets modeled
  (``costmodel.py``'s tables) or the gate goes red.
* **Cross-program assertions** — a design thesis as an inequality: the
  fused rank-1 GEVD-MWF solve models strictly less traffic than the
  separate-stage eigh path, in step 2 and in step 1.
"""
from __future__ import annotations

#: default ceiling on ``unmodeled.traffic_fraction``
UNMODELED_FRACTION_MAX = 0.05

#: per-program overrides of :data:`UNMODELED_FRACTION_MAX`, each reviewed
#: in the diff that adds it (none today)
UNMODELED_OVERRIDES: dict = {}

#: (smaller, larger, report key, thesis): ``report[smaller][key] <
#: report[larger][key]`` strictly
CROSS_BUDGETS = (
    (
        "tango_step2_fused", "tango_step2_eigh", "traffic_bytes",
        "the fused step-2 solve reads the (F, C, C) pencils once and writes back only the "
        "(F, C) weights — it must model strictly less traffic than the separate-stage eigh "
        "path",
    ),
    (
        "tango_step1_fused", "tango_step1_eigh", "traffic_bytes",
        "step 1's K×F local-MWF pencils ride one fused solve — it must model strictly less "
        "traffic than the eigh baseline",
    ),
)


def unmodeled_ceiling(program: str) -> float:
    """The largest unmodeled share of ``program``'s bytes the gate allows
    (its override, else :data:`UNMODELED_FRACTION_MAX`)."""
    return float(UNMODELED_OVERRIDES.get(program, UNMODELED_FRACTION_MAX))


def check_unmodeled(report: dict) -> list:
    """Messages when a report's unmodeled bucket breaches its ceiling."""
    unmodeled = report.get("unmodeled") or {}
    fraction = float(unmodeled.get("traffic_fraction") or 0.0)
    ceiling = unmodeled_ceiling(report.get("program", ""))
    if fraction <= ceiling:
        return []
    named = ", ".join(f"{k}×{v}" for k, v in sorted(unmodeled.get("primitives", {}).items()))
    return [f"unmodeled traffic fraction {fraction:.4f} exceeds the declared ceiling "
            f"{ceiling:.4f} (ops: {named or '?'}) — model them in costmodel.py or raise the "
            "ceiling in budgets.py (reviewed)"]


def check_cross(reports: dict) -> list:
    """Messages for every violated or unevaluable cross-program budget."""
    out: list = []
    for small, large, key, thesis in CROSS_BUDGETS:
        a, b = reports.get(small), reports.get(large)
        if a is None or b is None:
            missing = [n for n, r in ((small, a), (large, b)) if r is None]
            out.append(f"cross-budget {small} < {large} on {key}: program(s) "
                       f"{', '.join(missing)} missing from the run — the assertion cannot be "
                       "evaluated")
            continue
        va, vb = a.get(key), b.get(key)
        if not (isinstance(va, int) and isinstance(vb, int) and va < vb):
            out.append(f"cross-budget violated: {small}.{key}={va} is not strictly below "
                       f"{large}.{key}={vb} — {thesis}")
    return out
