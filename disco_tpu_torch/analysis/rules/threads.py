"""DL015: bare thread-primitive creation outside the race registries.

The port's copy of ``disco_tpu/analysis/rules/threads.py``, checked
against the port's own registries.  The race analyzer
(``disco-torch-race``, :mod:`disco_tpu_torch.analysis.race`) models the
port's concurrency from two declared registries: thread roles
(``race/roles.py``) and named locks (``race/registries.py``).  The model
is only as complete as the registries, so this rule closes the loop at
LINT time, per file and purely lexically:

* a ``threading.Thread(target=...)`` / ``threading.Timer(...)`` whose
  target's final name is not the leaf of any registered role entry point
  is a finding — the thread would run code no role declares;
* a ``threading.Lock()``/``RLock()``/``Condition()`` assigned to a name
  that is not a registered lock attribute for its module/class — or not
  assigned to a name at all — is a finding: an anonymous lock cannot
  participate in the lock-order analysis.

The deep, call-graph-accurate version of both checks is disco-torch-race's
DR001/DR005 (which resolves targets module-qualified instead of by leaf
name); DL015 is the cheap per-file tripwire that fires inside the same
gate run as every other lint rule, exactly like DL009/DL010 police the
obs/chaos string registries.  The registries are imported directly:
:mod:`disco_tpu_torch.analysis.race` is stdlib-only by construction (pinned by
test), so the linter stays torch- and jax-free.

No reference counterpart: the reference repo is single-threaded.
"""
from __future__ import annotations

import ast

from disco_tpu_torch.analysis.context import attr_chain
from disco_tpu_torch.analysis.registry import Rule, register

_LOCK_CTORS = ("Lock", "RLock", "Condition")
_SPAWN_CTORS = ("Thread", "Timer")


def _threading_names(ctx) -> dict:
    """Map of local alias -> threading member name for this file
    (``threading.Thread`` and ``from threading import Thread`` forms)."""
    out = {}
    for node in ctx.walk():
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "threading":
                    out[alias.asname or "threading"] = "*"
        elif isinstance(node, ast.ImportFrom) and node.module == "threading":
            for alias in node.names:
                out[alias.asname or alias.name] = alias.name
    return out


@register
class BareThreadPrimitive(Rule):
    """DL015 (module docstring)."""

    id = "DL015"
    name = "bare-thread-primitive"
    summary = (
        "threading.Thread/Timer targets must be registered race-role "
        "entry points and Lock/RLock/Condition must land on registered "
        "lock attributes (disco_tpu_torch/analysis/race registries)"
    )

    def check(self, ctx):
        from disco_tpu_torch.analysis.race.callgraph import module_of
        from disco_tpu_torch.analysis.race.roles import entry_point_leaves

        aliases = _threading_names(ctx)
        if not aliases:
            return
        leaves = entry_point_leaves()
        module = module_of(ctx.rel)
        lock_assigns = set()    # Call node ids consumed by a named assign
        yield from self._check_lock_assigns(ctx, aliases, module,
                                            lock_assigns)
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            member = self._threading_member(node, aliases)
            if member in _SPAWN_CTORS:
                yield from self._check_spawn(ctx, node, member, leaves)
            elif member in _LOCK_CTORS and id(node) not in lock_assigns:
                yield self.finding(
                    ctx, node,
                    f"threading.{member}() not assigned to a named "
                    "module- or instance-level attribute — an anonymous "
                    "lock cannot be registered in race/registries.py",
                )

    def _threading_member(self, call: ast.Call, aliases: dict):
        chain = attr_chain(call.func)
        if chain is None:
            return None
        if len(chain) == 2 and aliases.get(chain[0]) == "*":
            return chain[1]
        if len(chain) == 1:
            member = aliases.get(chain[0])
            return member if member != "*" else None
        return None

    def _check_spawn(self, ctx, node: ast.Call, member: str, leaves):
        target = None
        if member == "Thread":
            target = next((k.value for k in node.keywords
                           if k.arg == "target"), None)
        else:   # Timer(interval, function, ...)
            target = (node.args[1] if len(node.args) > 1 else
                      next((k.value for k in node.keywords
                            if k.arg == "function"), None))
        if target is None:
            yield self.finding(
                ctx, node,
                f"threading.{member} without an explicit target callable "
                "— the race role cannot be checked")
            return
        chain = attr_chain(target)
        leaf = chain[-1] if chain else None
        if leaf is None or leaf not in leaves:
            shown = ".".join(chain) if chain else "<computed>"
            yield self.finding(
                ctx, node,
                f"threading.{member} target '{shown}' is not a registered "
                "race-role entry point — declare the thread's role in "
                "disco_tpu_torch/analysis/race/roles.py (disco-torch-race DR001 is "
                "the call-graph-accurate twin of this check)")

    def _check_lock_assigns(self, ctx, aliases, module, consumed):
        """Walk assignments with class scope tracked; mark named lock
        constructor calls consumed and judge their registry ids."""
        from disco_tpu_torch.analysis.race.registries import is_registered, lock_id

        def walk(body, cls):
            for stmt in body:
                if isinstance(stmt, ast.ClassDef):
                    yield from walk(stmt.body, stmt.name if cls is None else cls)
                    continue
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from walk(stmt.body, cls)
                    continue
                if isinstance(stmt, (ast.If, ast.Try, ast.With,
                                     ast.For, ast.While)):
                    for name in ("body", "orelse", "finalbody"):
                        yield from walk(getattr(stmt, name, []) or [], cls)
                    for h in getattr(stmt, "handlers", ()):
                        yield from walk(h.body, cls)
                    continue
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                value = stmt.value
                if not isinstance(value, ast.Call):
                    continue
                member = self._threading_member(value, aliases)
                if member not in _LOCK_CTORS:
                    continue
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                tchain = attr_chain(targets[0]) if targets else None
                lid = None
                if tchain and len(tchain) == 1 and cls is None:
                    lid = lock_id(module, None, tchain[0])
                elif (tchain and len(tchain) == 2 and tchain[0] == "self"
                      and cls is not None):
                    lid = lock_id(module, cls, tchain[1])
                consumed.add(id(value))
                if lid is None:
                    yield self.finding(
                        ctx, value,
                        f"threading.{member}() assigned to an expression "
                        "that is not a module-level name or self "
                        "attribute — it cannot carry a registry id")
                elif not is_registered(lid):
                    yield self.finding(
                        ctx, value,
                        f"lock '{lid}' is not registered in "
                        "disco_tpu_torch/analysis/race/registries.py — register "
                        "it with a one-line statement of what it guards")

        yield from walk(ctx.tree.body, None)
