"""DL012 — magnitude recomputation and bf16 cast literals stay in ops/.

The port's reading of ``disco_tpu/analysis/rules/magnitude.py``.  The
analysis stage has a fused spec+magnitude STFT
(``ops.stft_ops.stft_with_mag``: ``csrc/stft.cu`` writes the magnitude in
the same pass as the spectrum) and a ``precision=`` compute-lane seam
(``ops.resolve``: 'f32'/'bf16', canonicalized once, whose rounding points
the bf16 kernels and their plain versions share).  Two call-site shapes
silently undo those seams:

* ``torch.abs(stft(...))`` / ``stft(...).abs()`` — recomputing the
  magnitude from a fresh STFT is exactly the separate pass over HBM the
  fused kernel deletes, and it bypasses the ``stft_impl`` resolution;
* bfloat16 cast literals — ``x.to(torch.bfloat16)``, ``x.bfloat16()``,
  ``x.type(torch.bfloat16)``, ``x.astype("bfloat16")``,
  ``dtype=torch.bfloat16`` — a hand-rolled precision change outside ops/
  creates a lane the ``precision=`` seam does not know: its rounding
  points are not ``ops.resolve``'s, so it escapes the lane's tolerance
  gates.  Comparing a dtype with ``torch.bfloat16`` is not a cast and is
  not flagged.

Inside ``disco_tpu_torch/ops/`` both shapes ARE the implementation (the
plain lane of ``stft_with_mag`` is ``abs`` of the spectrum; the bf16 casts
are the rounding points) — the rule exempts it.

No reference counterpart: the reference has one STFT path and one dtype
(float64 numpy).
"""
from __future__ import annotations

import ast

from disco_tpu_torch.analysis.context import attr_chain
from disco_tpu_torch.analysis.registry import Rule, register

#: callables whose result is a complex spectrogram the fused kernel already
#: pairs with a magnitude
_STFT_NAMES = ("stft", "_stft_rfft", "stft_matmul", "stft_kernel",
               "stft_bf16_kernel", "stft_fused", "stft_with_mag")

#: the magnitude callables the recomputation shape goes through
_ABS_NAMES = ("abs", "absolute")

#: cast methods whose first argument is a dtype
_CAST_METHODS = ("astype", "to", "type")


def _is_bf16_literal(node) -> bool:
    """True for the literal spellings of a bfloat16 dtype: the string
    ``"bfloat16"``/``"bf16"`` or an attribute chain ending in ``bfloat16``
    (``torch.bfloat16``, ``np.bfloat16``, ...).

    No reference counterpart (module docstring)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.strip().lower() in ("bfloat16", "bf16")
    chain = attr_chain(node)
    return bool(chain) and chain[-1] == "bfloat16"


def _is_stft_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    return bool(chain) and chain[-1] in _STFT_NAMES


@register
class MagnitudePrecisionSeam(Rule):
    id = "DL012"
    name = "fused-magnitude-precision"
    summary = ("torch.abs(stft(...)) magnitude recomputation or a bfloat16 "
               "cast literal outside ops/ — use the fused spec+mag STFT "
               "and the precision= seam")

    def applies(self, ctx) -> bool:
        return not ctx.in_dir("disco_tpu_torch/ops")

    def check(self, ctx):
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            chain = attr_chain(func)
            method = func.attr if isinstance(func, ast.Attribute) else None
            if ((chain and chain[-1] in _ABS_NAMES and node.args
                    and _is_stft_call(node.args[0]))
                    or (method in _ABS_NAMES and not node.args
                        and _is_stft_call(func.value))):
                yield self.finding(
                    ctx, node,
                    "magnitude recomputed as abs(stft(...)): the fused "
                    "spec+magnitude kernel (ops.stft_ops.stft_with_mag) "
                    "already emits it in the same pass — a separate abs is "
                    "one more HBM read of the full spec and bypasses the "
                    "stft_impl seam",
                )
            if (method in _CAST_METHODS and node.args and _is_bf16_literal(node.args[0])) \
                    or (method == "bfloat16" and not node.args):
                yield self.finding(
                    ctx, node,
                    "bfloat16 cast literal outside ops/: precision changes "
                    "go through the precision= seam (ops.resolve) so the "
                    "lane keeps its rounding points and tolerance gates",
                )
            for kw in node.keywords:
                if kw.arg == "dtype" and _is_bf16_literal(kw.value):
                    yield self.finding(
                        ctx, node,
                        "bfloat16 dtype literal outside ops/: request the "
                        "lane through the precision= seam (ops.resolve) "
                        "instead of constructing bf16 values directly",
                    )
