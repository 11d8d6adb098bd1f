"""Per-file analysis context: parsed AST plus the shared helpers rules need
(the port's copy of ``disco_tpu/analysis/context.py``).

No reference counterpart: the reference repo has no static analysis.  The
helpers here are the whole vocabulary of the rule set — attribute-chain
resolution, loop-depth-aware call iteration, module-level import listing —
kept in one place so every rule reads the tree the same way.
"""
from __future__ import annotations

import ast
from pathlib import Path, PurePosixPath


class FileContext:
    """Everything a rule may ask about one source file.

    ``rel`` is the repo-relative POSIX path ("disco_tpu_torch/enhance/driver.py")
    — rules scope themselves by it, and tests inject synthetic ones via
    :func:`disco_tpu_torch.analysis.runner.lint_source`.  ``root`` is the repo
    root (where ``disco_tpu_torch/`` lives), used by rules that consult the
    in-repo registries (obs event kinds, chaos seams).
    """

    def __init__(self, rel: str, source: str, root: Path):
        self.rel = str(PurePosixPath(rel))
        self.source = source
        self.root = Path(root)
        self.tree = ast.parse(source)
        self._nodes = None

    def walk(self) -> list:
        """Every node of the tree in ``ast.walk`` order, walked once per
        file and shared by the rules (each rule used to walk it again)."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    # -- path predicates ----------------------------------------------------
    def in_dir(self, *dirs: str) -> bool:
        """True when the file lives under any of the given repo-relative
        directories (e.g. ``in_dir("disco_tpu_torch/enhance", "disco_tpu_torch/nn")``)."""
        return any(self.rel == d or self.rel.startswith(d.rstrip("/") + "/") for d in dirs)

    def is_file(self, *rels: str) -> bool:
        """Exact repo-relative path match."""
        return self.rel in rels

    # -- AST helpers --------------------------------------------------------
    def module_docstring(self) -> str:
        return ast.get_docstring(self.tree) or ""

    def module_level_imports(self):
        """Yield the Import/ImportFrom nodes executed at module import time
        (direct module body plus ``if``/``try`` blocks at top level — the
        compat-guard idiom — but NOT function/class bodies)."""
        def _walk(body):
            for node in body:
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    yield node
                elif isinstance(node, (ast.If, ast.Try)):
                    for block in _blocks(node):
                        yield from _walk(block)

        yield from _walk(self.tree.body)

    def calls_with_loop_depth(self):
        """Yield ``(Call, depth)`` for every call, where ``depth`` counts the
        enclosing per-iteration scopes (for/while bodies, comprehension
        elements).  A ``for`` statement's iterable — and a comprehension's
        FIRST generator iterable — runs once and is NOT in-loop; a
        ``while`` test re-runs every iteration and is."""
        yield from _calls(self.tree, 0)


def _blocks(node):
    if isinstance(node, ast.If):
        return [node.body, node.orelse]
    if isinstance(node, ast.Try):
        out = [node.body, node.orelse, node.finalbody]
        out.extend(h.body for h in node.handlers)
        return out
    return []


def _calls(node, depth):
    if isinstance(node, ast.Call):
        yield node, depth
    if isinstance(node, (ast.For, ast.AsyncFor)):
        yield from _calls_children((node.target, node.iter), depth)
        for child in (*node.body, *node.orelse):
            yield from _calls(child, depth + 1)
        return
    if isinstance(node, ast.While):
        # the test expression re-evaluates each iteration: in-loop
        for child in (node.test, *node.body, *node.orelse):
            yield from _calls(child, depth + 1)
        return
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
        # the FIRST generator's iterable evaluates once (same as a for
        # statement's); the element expr, conditions and inner generators
        # run per iteration
        first = node.generators[0]
        yield from _calls(first.iter, depth)
        for sub in (first.target, *first.ifs):
            yield from _calls(sub, depth + 1)
        for gen in node.generators[1:]:
            for sub in (gen.target, gen.iter, *gen.ifs):
                yield from _calls(sub, depth + 1)
        elts = (node.key, node.value) if isinstance(node, ast.DictComp) else (node.elt,)
        for sub in elts:
            yield from _calls(sub, depth + 1)
        return
    for child in ast.iter_child_nodes(node):
        yield from _calls(child, depth)


def _calls_children(nodes, depth):
    for n in nodes:
        yield from _calls(n, depth)


def attr_chain(node) -> tuple | None:
    """``jax.tree_util.tree_map`` -> ("jax", "tree_util", "tree_map");
    a bare name -> ("name",); anything rooted in a non-Name expression
    (calls, subscripts) -> None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def callee_name(call: ast.Call) -> str | None:
    """The final name of the called expression ("tick" for both ``tick(..)``
    and ``chaos.tick(..)``), or None for computed callees."""
    chain = attr_chain(call.func)
    return chain[-1] if chain else None


def str_literal(node) -> str | None:
    """The value of a string-literal expression node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def import_names(node) -> list:
    """The imported module names of an Import/ImportFrom ("jax.numpy" for
    ``import jax.numpy``; "jax" for ``from jax import x``; relative imports
    yield their (possibly empty) module text)."""
    if isinstance(node, ast.Import):
        return [alias.name for alias in node.names]
    if isinstance(node, ast.ImportFrom):
        return [node.module or ""]
    return []


def imports_module(node, *roots: str) -> bool:
    """True when an Import/ImportFrom pulls in any of the ``roots`` packages
    (exact name or a submodule of it)."""
    for name in import_names(node):
        for root in roots:
            if name == root or name.startswith(root + "."):
                return True
    return False


#: tensor methods that read a device tensor back to the host (attribute calls)
READBACK_METHODS = frozenset({"item", "cpu", "tolist", "numpy"})


def readback_method(call):
    """The readback method a call invokes (``x.cpu()`` -> "cpu"), or None;
    the outer half of a chained ``x.cpu().contiguous().numpy()`` is the
    same crossing, reported once at its innermost readback."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr in READBACK_METHODS) or call.args:
        return None
    inner = func.value
    while isinstance(inner, ast.Call) and isinstance(inner.func, ast.Attribute):
        if inner.func.attr in READBACK_METHODS:
            return None
        inner = inner.func.value
    return func.attr
