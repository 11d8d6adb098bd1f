"""The rank-1 GEVD solver-spec grammar (the port's own copy of
``disco_tpu/solver_spec.py``; the port imports nothing of ``disco_tpu``).

Specs are ``'base'`` or ``'base:N'``: N power iterations for ``'power'``,
N Jacobi sweeps for the ``'jacobi*'`` and ``'fused*'`` families.
"""
from __future__ import annotations

#: every solver spec base the rank-1 GEVD dispatch table accepts
RANK1_SOLVERS = ("eigh", "power", "jacobi", "jacobi-pallas",
                 "fused", "fused-xla", "fused-pallas")

#: the fused solver family's spec -> kernel ``impl`` knob ('fused' is
#: 'auto': the hand-written kernel on a CUDA tensor, the plain version on
#: a CPU tensor)
FUSED_IMPLS = {"fused": "auto", "fused-xla": "xla", "fused-pallas": "pallas"}


def is_fused_spec(v: str | None) -> bool:
    """True when a solver spec selects the fused rank-1 GEVD-MWF family
    (``'fused'``/``'fused-xla'``/``'fused-pallas'``, optionally ``':N'``);
    ``None`` is not fused."""
    if v is None:
        return False
    return parse_solver_spec(v)[0] in FUSED_IMPLS


def parse_solver_spec(v: str) -> tuple[str, int | None]:
    """Parse ``'base'`` / ``'base:N'`` into (base, N-or-None); raises
    ValueError on an unknown base, an ``'eigh:N'`` suffix, or a malformed,
    empty or < 1 N."""
    base, sep, n_str = v.partition(":")
    if base not in RANK1_SOLVERS:
        raise ValueError(
            f"unknown GEVD solver {v!r}; expected one of {RANK1_SOLVERS}, "
            "optionally with ':N' (power iterations / jacobi sweeps)"
        )
    if not sep:
        return base, None
    if base == "eigh":
        raise ValueError(f"solver spec {v!r}: 'eigh' takes no ':N' suffix")
    try:
        n = int(n_str)
    except ValueError:
        n = 0
    if n < 1:
        raise ValueError(f"malformed solver spec {v!r}: '{base}:N' needs integer N >= 1")
    return base, n
