"""DL016 — fused-solver selection and kernel routing go through the
dispatch seams.

The port's reading of ``disco_tpu/analysis/rules/fusedsolver.py``.  The
fused rank-1 GEVD-MWF solve (``ops/mwf_ops.py``: ``csrc/mwf.cu`` and its
plain version) is selected by the ``solver='fused'``/``'fused-xla'``/
``'fused-pallas'`` specs of THE dispatch table
(``beam.filters.rank1_gevd`` via ``parse_solver_spec``), which hands the
impl to ``mwf_ops.rank1_gevd_fused`` (kernel on the card, plain version on
the CPU, ``ops.resolve.check_impl``).  Two call-site shapes silently
bypass those seams:

* calling the fused ops directly (``rank1_gevd_fused`` /
  ``fused_mwf_kernel`` / ``fused_mwf_plain``) outside ops/ and the
  dispatch table — the caller picks a kernel without the grammar
  validation or the sanitize policy the dispatch owns;
* branching on ``'fused'``-family string literals (``solver == "fused"``,
  ``base in ("fused", ...)``, ``solver.startswith("fused")``) — ad-hoc
  grammar re-implementation; the sanctioned family predicate is
  ``solver_spec.is_fused_spec``.

The port adds **kernel routing**: the five kernels are named torch ops
(``torch.ops.disco_torch.*``, defined by ``ops/_build.py::kernel_op``)
behind their wrappers in ``ops/``, which count each launch and pick the
kernel or its plain version by the tensor's device.  A
``torch.ops.disco_torch.*`` reference, or a call of ``ops/_build.py``'s
loader and launch plumbing (``load``/``build``/``check``/``kernel_op``/
``stream_handle``), outside ``disco_tpu_torch/ops/`` is a launch no
counter sees (the launch-count contract of ``chip_smoke.py``) or a build
outside the one loader.

Passing a fused spec AS DATA (``solver="fused"`` into ``rank1_gevd``/
``tango``/the CLI) is the sanctioned path and stays legal.  Inside
``disco_tpu_torch/ops/``, ``disco_tpu_torch/beam/filters.py`` (the
dispatch table) and ``disco_tpu_torch/solver_spec.py`` (the grammar
itself) the selection shapes ARE the implementation — exempt; the kernel
routing is exempt only under ``ops/``.

No reference counterpart: the reference solves every pencil one way only
(``scipy.linalg.eig``, internal_formulas.py:56-73).
"""
from __future__ import annotations

import ast

from disco_tpu_torch.analysis.context import attr_chain
from disco_tpu_torch.analysis.registry import Rule, register

#: the fused-solve entry points owned by the dispatch seams
_FUSED_CALLS = ("rank1_gevd_fused", "fused_mwf_kernel", "fused_mwf_plain")

#: the kernel ops' namespace (``ops/_build.py::OP_NAMESPACE``)
_OP_CHAIN = ("torch", "ops", "disco_torch")

#: ``ops/_build.py``'s loader and launch plumbing
_BUILD_MODULE = "disco_tpu_torch.ops._build"
_BUILD_CALLS = ("load", "build", "check", "kernel_op", "stream_handle")


def _build_aliases(ctx):
    """(module aliases of ``ops._build``, bare names imported from it)."""
    mods, bare = set(), set()
    for node in ctx.walk():
        if isinstance(node, ast.ImportFrom):
            if node.module == "disco_tpu_torch.ops":
                mods.update(a.asname or a.name for a in node.names if a.name == "_build")
            elif node.module == _BUILD_MODULE:
                bare.update(a.asname or a.name for a in node.names
                            if a.name in _BUILD_CALLS)
        elif isinstance(node, ast.Import):
            mods.update(a.asname for a in node.names if a.name == _BUILD_MODULE and a.asname)
    return mods, bare

#: the spec bases of the fused solver family (beam.filters._FUSED_IMPLS)
_FUSED_BASES = ("fused", "fused-xla", "fused-pallas")


def _fused_literal(node) -> bool:
    """True for a string constant of the fused solver family (optionally
    with a ``:N`` suffix), or a tuple/list/set display containing one.

    No reference counterpart (module docstring)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.partition(":")[0] in _FUSED_BASES
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return any(_fused_literal(el) for el in node.elts)
    return False


@register
class FusedSolverSeam(Rule):
    id = "DL016"
    name = "fused-solver-selection"
    summary = ("fused-solve selection bypassing parse_solver_spec, or a "
               "kernel op / ops._build loader called outside ops/ — direct "
               "fused-op calls, 'fused' literal comparisons, uncounted "
               "launches")

    def applies(self, ctx) -> bool:
        return not ctx.in_dir("disco_tpu_torch/ops")

    def _kernel_routing(self, ctx):
        mods, bare = _build_aliases(ctx)
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain:
                continue
            if chain[:3] == _OP_CHAIN:
                yield self.finding(
                    ctx, node,
                    f"kernel op {'.'.join(chain)} called outside ops/: the "
                    "wrappers in ops/ count every launch and pick the kernel "
                    "or its plain version by device — call the wrapper",
                )
            elif (len(chain) == 2 and chain[0] in mods and chain[1] in _BUILD_CALLS) \
                    or (len(chain) == 1 and chain[0] in bare):
                yield self.finding(
                    ctx, node,
                    f"ops._build.{chain[-1]}() outside ops/: the kernel "
                    "library is built, loaded and launched only behind the "
                    "ops/ wrappers (one loader, counted launches)",
                )

    def check(self, ctx):
        yield from self._kernel_routing(ctx)
        if ctx.is_file("disco_tpu_torch/beam/filters.py", "disco_tpu_torch/solver_spec.py"):
            return
        for node in ctx.walk():
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if chain and chain[-1] in _FUSED_CALLS:
                    yield self.finding(
                        ctx, node,
                        f"direct call to {chain[-1]} outside ops/ and the "
                        "rank1_gevd dispatch table: select the fused solve "
                        "with a solver spec ('fused[:N]'/'fused-xla'/"
                        "'fused-pallas') through parse_solver_spec so the "
                        "grammar, the impl resolution and the sanitize "
                        "policy stay owned by the seams",
                    )
                elif (chain and chain[-1] == "startswith"
                        and any(_fused_literal(a) for a in node.args)):
                    # solver.startswith("fused") — the prefix spelling of
                    # the same ad-hoc family check (a "fused-xla" spec
                    # matches it by accident, the next family member by
                    # luck only); the sanctioned predicate is
                    # solver_spec.is_fused_spec
                    yield self.finding(
                        ctx, node,
                        "'fused' family probe via startswith: solver-family "
                        "branching belongs behind solver_spec.is_fused_spec "
                        "/ parse_solver_spec — a prefix check drifts the "
                        "moment the spec grammar grows",
                    )
            elif isinstance(node, ast.Compare):
                operands = [node.left, *node.comparators]
                if any(_fused_literal(op) for op in operands):
                    yield self.finding(
                        ctx, node,
                        "comparison against a 'fused' solver literal: "
                        "solver-family branching belongs behind "
                        "parse_solver_spec / the rank1_gevd dispatch table "
                        "(beam/filters.py) — an ad-hoc family check drifts "
                        "the moment the spec grammar grows",
                    )
