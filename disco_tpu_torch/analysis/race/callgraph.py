"""AST index + module-qualified call resolution for the race analyzer (the
port's copy of ``disco_tpu/analysis/race/callgraph.py``; it recognizes
``torch``/``triton`` roots for DR002 and executor ``map`` as a spawn).

The analyzer is whole-program: checks are statements about what a THREAD
can reach, not about one file.  This module builds the program model —
every function indexed by ``module:dotted.qualname`` (class and enclosing
-function names dotted in, no ``<locals>`` marker), with per-function
facts collected under a tracked held-lock set:

* **calls**       — every call site, its attribute chain, and the locks
  held around it (``with``-statement nesting, resolved against the lock
  registry);
* **spawns**      — ``threading.Thread``/``Timer``, ``executor.submit``,
  ``loop.run_in_executor`` and ``signal.signal`` sites with their target
  expressions (DR001 resolves these against the role registry);
* **acquires**    — lock acquisitions with the set held *before* each
  (the edges of the lock-order graph);
* **creations**   — ``threading.Lock()/RLock()/Condition()`` assignment
  sites with their derived registry ids (DR005);
* **writes**      — ``self.attr`` mutations with held locks (DR007).

Resolution is module-qualified and deliberately conservative: bare names
resolve through nested defs, module scope and imports; ``self.m()``
through the enclosing class (then same-module bases); ``self.attr.m()``
and ``local.m()`` through inferred or declared attribute/local types;
everything else is unresolved UNLESS an explicit
:data:`~disco_tpu_torch.analysis.race.roles.DYNAMIC_CALLS` entry declares the
targets — dynamic dispatch is modeled by declaration, never by guessing
(a name-match fallback would flood the torch-reachability check with false
edges).

Stdlib-only by the same constraint as disco-torch-lint: no torch or jax
import, no production ``disco_tpu_torch`` module import — the model is
built by parsing.

No reference counterpart: the reference repo is single-threaded and has
no static analysis.
"""
from __future__ import annotations

import ast
import dataclasses

from disco_tpu_torch.analysis.context import attr_chain
from disco_tpu_torch.analysis.race import registries as race_registries
from disco_tpu_torch.analysis.race import roles as race_roles

#: with-item context names treated as lock-ish even when unresolved (an
#: unregistered lock must surface as DR005, not silently drop out of the
#: order analysis)
_LOCKISH = ("lock", "_lock")

_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition"})

#: import roots whose calls reach the device (DR002)
_DEVICE_ROOTS = ("torch", "triton")


def module_of(rel: str) -> str:
    """Repo-relative path -> import path (``disco_tpu_torch/serve/server.py`` ->
    ``disco_tpu_torch.serve.server``; ``chip_smoke.py`` -> ``chip_smoke``)."""
    mod = rel[:-3] if rel.endswith(".py") else rel
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


@dataclasses.dataclass
class CallSite:
    """One call expression inside a function body."""

    chain: tuple | None      # ("self", "tap", "offer") or None (computed)
    node: ast.Call
    held: frozenset          # lock ids held around the call
    n_args: int
    keywords: tuple          # keyword names (None for **kw)


@dataclasses.dataclass
class SpawnSite:
    """One thread/timer/executor/signal-handler registration site."""

    kind: str                # "thread" | "timer" | "executor" | "signal"
    target: ast.expr | None  # the callable expression (None: not given)
    node: ast.Call
    held: frozenset


@dataclasses.dataclass
class LockUse:
    """One ``with``-acquisition of a (possibly unresolved) lock."""

    lock: str | None         # registry id, or None when unresolvable
    text: str                # source text of the context expr (reports)
    node: ast.expr
    held_before: frozenset


@dataclasses.dataclass
class LockCreation:
    """One ``threading.Lock()``-family constructor assignment."""

    lock: str | None         # derived registry id, or None (anonymous)
    node: ast.expr


@dataclasses.dataclass
class AttrWrite:
    """One ``self.attr = ...`` / ``self.attr op= ...`` mutation."""

    attr: str
    held: frozenset
    node: ast.stmt


@dataclasses.dataclass
class FunctionInfo:
    """Everything the checks ask about one function."""

    qual: str                # "disco_tpu_torch.flywheel.tap:CorpusTap._run"
    module: str
    cls: str | None          # nearest enclosing class name, or None
    rel: str
    node: ast.AST
    calls: list = dataclasses.field(default_factory=list)
    spawns: list = dataclasses.field(default_factory=list)
    acquires: list = dataclasses.field(default_factory=list)
    creations: list = dataclasses.field(default_factory=list)
    writes: list = dataclasses.field(default_factory=list)
    local_types: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ClassInfo:
    """One class: its methods, bases and inferred attribute types."""

    qual: str                # "disco_tpu_torch.flywheel.tap:CorpusTap"
    name: str
    module: str
    methods: set = dataclasses.field(default_factory=set)
    bases: list = dataclasses.field(default_factory=list)   # attr chains
    attr_types: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModuleInfo:
    """One source module: imports, classes, module-level functions."""

    name: str
    rel: str
    imports: dict = dataclasses.field(default_factory=dict)  # alias -> path
    classes: dict = dataclasses.field(default_factory=dict)  # name -> ClassInfo
    functions: set = dataclasses.field(default_factory=set)  # module-level defs
    #: module-global name -> class qual, inferred from constructor assigns
    #: at module level or under a ``global`` declaration (``_PLAN =
    #: _Plan(...)``, ``_FLIGHT = FlightRecorder()``)
    var_types: dict = dataclasses.field(default_factory=dict)


class Index:
    """The whole-program model: modules + functions + resolution."""

    def __init__(self):
        self.modules: dict = {}    # module name -> ModuleInfo
        self.functions: dict = {}  # qual -> FunctionInfo
        self.classes: dict = {}    # "module:Class" -> ClassInfo
        #: explicit dynamic-dispatch fallbacks (roles.DYNAMIC_CALLS by
        #: default; tests inject their own)
        self.dynamic_calls: dict = dict(race_roles.DYNAMIC_CALLS)
        self.attr_types: dict = dict(race_roles.ATTR_TYPES)
        self.locks: dict = dict(race_registries.LOCKS)
        self.assumed_locks: dict = dict(race_registries.ASSUMED_LOCKS)

    # -- construction --------------------------------------------------------
    def add_module(self, rel: str, source: str) -> None:
        """Parse one file into the model."""
        mod = module_of(rel)
        tree = ast.parse(source)
        info = ModuleInfo(name=mod, rel=rel)
        self.modules[mod] = info
        _collect_imports(tree, info.imports)
        _ModuleWalker(self, info, rel).visit_module(tree)

    # -- lookups -------------------------------------------------------------
    def function(self, qual: str):
        return self.functions.get(qual)

    def class_info(self, qual: str):
        return self.classes.get(qual)

    def import_root(self, module: str, alias: str) -> str | None:
        """What ``alias`` refers to in ``module`` (an import path), or
        None for plain locals/builtins."""
        info = self.modules.get(module)
        return info.imports.get(alias) if info else None

    def is_torch_name(self, module: str, chain: tuple) -> bool:
        """Whether a call chain is rooted in a torch (or triton) import
        (``torch.x``, ``F.y`` via ``import torch.nn.functional as F``, a
        bare name imported ``from torch import ...``) — the device surface
        of DR002."""
        path = self.import_root(module, chain[0])
        return bool(path) and any(path == r or path.startswith(r + ".")
                                  for r in _DEVICE_ROOTS)

    # -- call resolution -----------------------------------------------------
    def resolve_callable(self, expr_chain: tuple | None, func: FunctionInfo):
        """Resolve a callable expression (a spawn target or a call's
        ``func``) to function quals.  Returns a tuple of quals (possibly
        empty: declared-dead dynamic site) or None (unresolvable)."""
        if expr_chain is None:
            return None
        key = f"{func.qual}::{'.'.join(expr_chain)}"
        if key in self.dynamic_calls:
            return tuple(self.dynamic_calls[key])
        mod = func.module
        if len(expr_chain) == 1:
            return self._resolve_name(expr_chain[0], func)
        head, rest = expr_chain[0], expr_chain[1:]
        if head in ("self", "cls") and func.cls is not None:
            cqual = f"{mod}:{func.cls}"
            if len(rest) == 1:
                return self._resolve_method(cqual, rest[0])
            # self.attr.m(): declared or inferred attribute type
            tqual = self._attr_type(cqual, rest[0])
            if tqual is not None and len(rest) == 2:
                return self._resolve_method(tqual, rest[1])
            return None
        # local variable with an inferred type: x = ClassName(...)
        tqual = func.local_types.get(head)
        if tqual is None:
            # module global with an inferred type (_FLIGHT, _PLAN)
            minfo = self.modules.get(mod)
            tqual = minfo.var_types.get(head) if minfo else None
        if tqual is not None and len(rest) == 1:
            return self._resolve_method(tqual, rest[0])
        # module alias: obs_events.record(...), disco-style imports
        path = self.import_root(mod, head)
        if path is not None:
            return self._resolve_dotted(path, rest)
        return None

    def _resolve_name(self, name: str, func: FunctionInfo):
        # nested def of this function, then enclosing functions outward
        scope = func.qual
        while True:
            cand = f"{scope}.{name}"
            if cand in self.functions:
                return (cand,)
            if "." not in scope.split(":", 1)[1]:
                break
            scope = scope.rsplit(".", 1)[0]
        minfo = self.modules.get(func.module)
        if minfo is None:
            return None
        if name in minfo.functions:
            return (f"{func.module}:{name}",)
        if name in minfo.classes:
            return self._resolve_method(f"{func.module}:{name}", "__init__")
        path = self.import_root(func.module, name)
        if path is not None:
            return self._resolve_dotted_symbol(path)
        return None

    def _resolve_method(self, class_qual: str, meth: str):
        cinfo = self.classes.get(class_qual)
        if cinfo is None:
            return None
        if meth in cinfo.methods:
            return (f"{class_qual}.{meth}",)
        # single-level base walk (same module or imported repo class)
        for base_chain in cinfo.bases:
            bqual = self._resolve_class_ref(cinfo.module, base_chain)
            if bqual is not None:
                got = self._resolve_method(bqual, meth)
                if got is not None:
                    return got
        return None

    def _resolve_class_ref(self, module: str, chain: tuple):
        if len(chain) == 1:
            minfo = self.modules.get(module)
            if minfo and chain[0] in minfo.classes:
                return f"{module}:{chain[0]}"
            path = self.import_root(module, chain[0])
            if path is not None:
                m, _, c = path.rpartition(".")
                if m in self.modules and c in self.modules[m].classes:
                    return f"{m}:{c}"
        elif len(chain) == 2:
            path = self.import_root(module, chain[0])
            if path in self.modules and chain[1] in self.modules[path].classes:
                return f"{path}:{chain[1]}"
        return None

    def _attr_type(self, class_qual: str, attr: str):
        declared = self.attr_types.get(f"{class_qual}.{attr}")
        if declared is not None:
            return declared
        cinfo = self.classes.get(class_qual)
        return cinfo.attr_types.get(attr) if cinfo else None

    def _resolve_dotted(self, path: str, rest: tuple):
        """``path`` is an import target; ``rest`` the remaining chain.
        Try ever-longer module prefixes (``pkg.sub`` imports)."""
        for i in range(len(rest), -1, -1):
            mod = ".".join((path, *rest[:i])) if i else path
            if mod in self.modules:
                tail = rest[i:]
                if len(tail) == 1:
                    minfo = self.modules[mod]
                    if tail[0] in minfo.functions:
                        return (f"{mod}:{tail[0]}",)
                    if tail[0] in minfo.classes:
                        return self._resolve_method(f"{mod}:{tail[0]}", "__init__")
                if len(tail) == 2 and tail[0] in self.modules[mod].classes:
                    return self._resolve_method(f"{mod}:{tail[0]}", tail[1])
                return None
        return self._resolve_dotted_symbol(path, rest)

    def _resolve_dotted_symbol(self, path: str, rest: tuple = ()):
        """``from m import f`` gives alias path ``m.f``: split the symbol
        off the tail and resolve inside module ``m``."""
        mod, _, sym = path.rpartition(".")
        if mod in self.modules and not rest:
            minfo = self.modules[mod]
            if sym in minfo.functions:
                return (f"{mod}:{sym}",)
            if sym in minfo.classes:
                return self._resolve_method(f"{mod}:{sym}", "__init__")
        if mod in self.modules and len(rest) == 1 and sym in self.modules[mod].classes:
            return self._resolve_method(f"{mod}:{sym}", rest[0])
        return None

    def resolve_lock(self, expr: ast.expr, func: FunctionInfo):
        """Resolve a ``with`` context expression to a registered lock id.
        Returns ``(lock_id_or_None, is_lockish)`` — ``is_lockish`` marks
        names that LOOK like locks so unregistered ones surface (DR005)."""
        chain = attr_chain(expr)
        if chain is None:
            return None, False
        leaf = chain[-1]
        lockish = (leaf.lower() in _LOCKISH or leaf.lower().endswith("_lock")
                   or "LOCK" in leaf)
        cand = None
        mod = func.module
        if len(chain) == 1:
            cand = f"{mod}::{leaf}"
        elif chain[0] in ("self", "cls") and func.cls is not None:
            if len(chain) == 2:
                cand = f"{mod}:{func.cls}::{leaf}"
            elif len(chain) == 3:
                tqual = self._attr_type(f"{mod}:{func.cls}", chain[1])
                if tqual is not None:
                    cand = f"{tqual}::{leaf}"
        elif len(chain) == 2:
            tqual = func.local_types.get(chain[0])
            if tqual is None:
                minfo = self.modules.get(mod)
                tqual = minfo.var_types.get(chain[0]) if minfo else None
            if tqual is not None:
                cand = f"{tqual}::{leaf}"
            else:
                path = self.import_root(mod, chain[0])
                if path in self.modules:
                    cand = f"{path}::{leaf}"
        if cand is not None and cand in self.locks:
            return cand, lockish
        return None, lockish


def _collect_imports(tree: ast.AST, out: dict) -> None:
    """alias -> import path, over the whole module INCLUDING function-local
    imports (the port's lazy-torch idiom makes those the ones that matter)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.partition(".")[0]] = (
                    alias.name if alias.asname else alias.name.partition(".")[0]
                )
                if alias.asname:
                    out[alias.asname] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                out[alias.asname or alias.name] = f"{node.module}.{alias.name}"


class _ModuleWalker:
    """Walk one module: register classes/functions, then collect each
    function's facts under tracked held-lock sets."""

    def __init__(self, index: Index, minfo: ModuleInfo, rel: str):
        self.index = index
        self.minfo = minfo
        self.rel = rel

    # -- declaration pass ----------------------------------------------------
    def visit_module(self, tree: ast.Module) -> None:
        self._declare(tree.body, scope=(), cls=None)
        self._infer_attr_types()
        self._infer_module_var_types(tree)
        for qual, fn in list(self.index.functions.items()):
            if fn.module == self.minfo.name and fn.rel == self.rel:
                self._analyze_function(fn)
        # module-level lock creations (the registry id has no class part)
        mod_fn = self._module_body_fn(tree)
        self._analyze_function(mod_fn)

    def _module_body_fn(self, tree: ast.Module) -> FunctionInfo:
        """A synthetic function for module-level statements (import-time
        code: lock creations, module-level spawns)."""
        qual = f"{self.minfo.name}:<module>"
        fn = FunctionInfo(qual=qual, module=self.minfo.name, cls=None,
                          rel=self.rel, node=tree)
        self.index.functions[qual] = fn
        return fn

    def _declare(self, body, scope: tuple, cls: str | None) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                path = (*scope, node.name)
                qual = f"{self.minfo.name}:{'.'.join(path)}"
                self.index.functions[qual] = FunctionInfo(
                    qual=qual, module=self.minfo.name, cls=cls,
                    rel=self.rel, node=node,
                )
                if not scope:
                    self.minfo.functions.add(node.name)
                if cls is not None and len(scope) == 1:
                    self.index.classes[f"{self.minfo.name}:{cls}"].methods.add(
                        node.name)
                self._declare(node.body, path, cls)
            elif isinstance(node, ast.ClassDef):
                if not scope:   # nested classes: not modeled
                    cqual = f"{self.minfo.name}:{node.name}"
                    cinfo = ClassInfo(qual=cqual, name=node.name,
                                      module=self.minfo.name)
                    cinfo.bases = [c for c in map(attr_chain, node.bases) if c]
                    self.index.classes[cqual] = cinfo
                    self.minfo.classes[node.name] = cinfo
                    self._declare(node.body, (node.name,), node.name)
            else:
                # descend EVERY nested statement list (if/try AND
                # with/for/while): a def declared inside a with or loop
                # body must enter the model, or code reached through it
                # would silently escape every reachability check
                for block in _stmt_blocks(node):
                    self._declare(block, scope, cls)

    def _infer_attr_types(self) -> None:
        """``self.attr = ClassName(...)`` anywhere in a class (including
        behind ``x or ClassName(...)``) types the attribute."""
        for cinfo in self.minfo.classes.values():
            for meth in cinfo.methods:
                fn = self.index.functions.get(f"{cinfo.qual}.{meth}")
                if fn is None:
                    continue
                for node in ast.walk(fn.node):
                    if not isinstance(node, ast.Assign):
                        continue
                    for tgt in node.targets:
                        chain = attr_chain(tgt)
                        if not (chain and len(chain) == 2 and chain[0] == "self"):
                            continue
                        tq = self._ctor_type(node.value, fn)
                        if tq is not None:
                            cinfo.attr_types.setdefault(chain[1], tq)

    def _infer_module_var_types(self, tree: ast.Module) -> None:
        """Type module globals from constructor assignments: at module
        level, and inside functions that declare the name ``global`` (the
        repo's ``configure()``-style rebinding idiom)."""
        probe = FunctionInfo(qual=f"{self.minfo.name}:<module>",
                             module=self.minfo.name, cls=None,
                             rel=self.rel, node=tree)
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tq = self._ctor_type(node.value, probe)
                if tq is not None:
                    self.minfo.var_types.setdefault(node.targets[0].id, tq)
        for fn in self.index.functions.values():
            if fn.module != self.minfo.name or isinstance(fn.node, ast.Module):
                continue
            globals_here = {
                n for sub in ast.walk(fn.node)
                if isinstance(sub, ast.Global) for n in sub.names
            }
            if not globals_here:
                continue
            for sub in ast.walk(fn.node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name) \
                        and sub.targets[0].id in globals_here:
                    tq = self._ctor_type(sub.value, fn)
                    if tq is not None:
                        self.minfo.var_types.setdefault(sub.targets[0].id, tq)

    def _ctor_type(self, value: ast.expr, fn: FunctionInfo):
        """The class qual a value expression constructs, if inferable."""
        if isinstance(value, ast.BoolOp):
            for v in value.values:
                got = self._ctor_type(v, fn)
                if got is not None:
                    return got
            return None
        if not isinstance(value, ast.Call):
            return None
        chain = attr_chain(value.func)
        if chain is None:
            return None
        # bare, module-alias (mod.Class(...)) or imported constructor
        got = self.index._resolve_class_ref(self.minfo.name, chain)
        if got is not None:
            return got
        # external marker for the one stdlib type spawn sites care about
        if chain[-1] == "ThreadPoolExecutor":
            return "<ThreadPoolExecutor>"
        return None

    # -- fact-collection pass ------------------------------------------------
    def _analyze_function(self, fn: FunctionInfo) -> None:
        body = fn.node.body if not isinstance(fn.node, ast.Module) else [
            n for n in fn.node.body
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
        ]
        # closures see the enclosing function's locals: seed nested defs
        # with the parent's inferred types (declaration order guarantees
        # the parent was analyzed first)
        tail = fn.qual.split(":", 1)[1]
        if "." in tail:
            parent = self.index.functions.get(fn.qual.rsplit(".", 1)[0])
            if parent is not None:
                fn.local_types.update(parent.local_types)
        self._infer_local_types(fn, body)
        # the _locked-suffix contract: registered helpers run with their
        # caller's lock held (registries.ASSUMED_LOCKS)
        self._walk_stmts(fn, body,
                         frozenset(self.index.assumed_locks.get(fn.qual, ())))

    def _infer_local_types(self, fn: FunctionInfo, body) -> None:
        if fn.cls is not None:
            fn.local_types["self"] = f"{fn.module}:{fn.cls}"
            fn.local_types["cls"] = f"{fn.module}:{fn.cls}"
        for node in body:
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    tgt = sub.targets[0]
                    if isinstance(tgt, ast.Name):
                        tq = self._ctor_type(sub.value, fn)
                        if tq is None and isinstance(sub.value, ast.Name):
                            # alias of a typed module global (plan = _PLAN)
                            tq = self.minfo.var_types.get(sub.value.id)
                        if tq is not None:
                            fn.local_types.setdefault(tgt.id, tq)
                elif isinstance(sub, (ast.With, ast.AsyncWith)):
                    for item in sub.items:
                        if isinstance(item.optional_vars, ast.Name):
                            tq = self._ctor_type(item.context_expr, fn)
                            if tq is not None:
                                fn.local_types.setdefault(
                                    item.optional_vars.id, tq)

    def _walk_stmts(self, fn: FunctionInfo, stmts, held: frozenset) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue   # separate FunctionInfo / not modeled
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = held
                for item in stmt.items:
                    self._visit_expr(fn, item.context_expr, held)
                    lid, lockish = self.index.resolve_lock(
                        item.context_expr, fn)
                    if lid is not None or lockish:
                        text = ".".join(attr_chain(item.context_expr) or ("?",))
                        fn.acquires.append(LockUse(
                            lock=lid, text=text, node=item.context_expr,
                            held_before=inner))
                        inner = inner | {lid or f"<unregistered:{text}>"}
                self._walk_stmts(fn, stmt.body, inner)
                continue
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                self._note_writes(fn, stmt, held)
            for expr in _stmt_exprs(stmt):
                self._visit_expr(fn, expr, held)
            for block in _stmt_blocks(stmt):
                self._walk_stmts(fn, block, held)

    def _note_writes(self, fn: FunctionInfo, stmt, held: frozenset) -> None:
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for tgt in targets:
            elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
            for t in elts:
                chain = attr_chain(t)
                if chain and len(chain) == 2 and chain[0] == "self":
                    fn.writes.append(AttrWrite(attr=chain[1], held=held,
                                               node=stmt))
        # lock creations: X = threading.Lock() / self._x = Lock()
        value = getattr(stmt, "value", None)
        if isinstance(value, ast.Call):
            cchain = attr_chain(value.func)
            if cchain and self._is_lock_ctor(cchain):
                tgt0 = targets[0] if targets else None
                tchain = attr_chain(tgt0) if tgt0 is not None else None
                lid = None
                if tchain is not None and len(tchain) == 1:
                    if fn.qual.endswith(":<module>"):
                        lid = f"{fn.module}::{tchain[0]}"
                elif (tchain is not None and len(tchain) == 2
                      and tchain[0] == "self" and fn.cls is not None):
                    lid = f"{fn.module}:{fn.cls}::{tchain[1]}"
                fn.creations.append(LockCreation(lock=lid, node=value))

    def _is_lock_ctor(self, chain: tuple) -> bool:
        if len(chain) == 2 and chain[1] in _LOCK_CTORS:
            return self.index.import_root(self.minfo.name, chain[0]) == "threading"
        if len(chain) == 1 and chain[0] in _LOCK_CTORS:
            path = self.index.import_root(self.minfo.name, chain[0])
            return bool(path) and path.startswith("threading.")
        return False

    def _visit_expr(self, fn: FunctionInfo, expr, held: frozenset) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._note_call(fn, node, held)

    def _note_call(self, fn: FunctionInfo, node: ast.Call, held) -> None:
        chain = attr_chain(node.func)
        fn.calls.append(CallSite(
            chain=chain, node=node, held=held, n_args=len(node.args),
            keywords=tuple(k.arg for k in node.keywords),
        ))
        if chain is None:
            return
        spawn = self._spawn_kind(fn, chain, node)
        if spawn is not None:
            kind, target = spawn
            fn.spawns.append(SpawnSite(kind=kind, target=target, node=node,
                                       held=held))

    def _spawn_kind(self, fn: FunctionInfo, chain: tuple, node: ast.Call):
        def kwarg(name):
            for k in node.keywords:
                if k.arg == name:
                    return k.value
            return None

        leaf = chain[-1]
        root_path = self.index.import_root(self.minfo.name, chain[0])
        if leaf == "Thread" and (
            (len(chain) == 2 and root_path == "threading")
            or (len(chain) == 1 and root_path == "threading.Thread")
        ):
            return "thread", kwarg("target")
        if leaf == "Timer" and (
            (len(chain) == 2 and root_path == "threading")
            or (len(chain) == 1 and root_path == "threading.Timer")
        ):
            target = node.args[1] if len(node.args) > 1 else kwarg("function")
            return "timer", target
        if leaf == "signal" and len(chain) == 2 and root_path == "signal":
            return "signal", (node.args[1] if len(node.args) > 1
                              else kwarg("handler"))
        if leaf in ("submit", "map") and len(chain) == 2:
            if fn.local_types.get(chain[0]) == "<ThreadPoolExecutor>":
                return "executor", (node.args[0] if node.args else None)
        if leaf == "run_in_executor" and len(chain) >= 2:
            return "executor", (node.args[1] if len(node.args) > 1 else None)
        return None


def _stmt_blocks(stmt) -> list:
    """The nested statement lists of one statement (bodies re-walked by
    the caller with the right held set)."""
    out = []
    for name in ("body", "orelse", "finalbody"):
        block = getattr(stmt, name, None)
        if isinstance(block, list) and block and isinstance(block[0], ast.stmt):
            out.append(block)
    for h in getattr(stmt, "handlers", ()):
        out.append(h.body)
    return out


def _stmt_exprs(stmt) -> list:
    """The expression children of one statement (bodies excluded)."""
    out = []
    for name, value in ast.iter_fields(stmt):
        if name in ("body", "orelse", "finalbody", "handlers"):
            continue
        vals = value if isinstance(value, list) else [value]
        out.extend(v for v in vals if isinstance(v, ast.expr))
    return out


def build_index(files) -> Index:
    """Build the program model from ``[(rel, source), ...]``."""
    index = Index()
    for rel, source in files:
        index.add_module(rel, source)
    return index
