"""The DRnnn thread-contract checks over the race call graph.

Check catalog (ids are stable; DR000 is the engine's suppression-hygiene
pseudo-rule, shared machinery with disco-torch-lint's DL000):

* DR001 ``unregistered-thread``   — every ``threading.Thread``/``Timer``,
  ``executor.submit``/``run_in_executor`` and ``signal.signal`` site must
  resolve to an entry point of a registered role (roles.py); an
  unresolvable target is a finding too (register it, declare a
  DYNAMIC_CALLS fallback, or justify a suppression).
* DR002 ``torch-outside-dispatch`` — calls rooted in a ``torch`` (or
  ``triton``) import reachable ONLY from roles declared ``torch_ok`` in
  roles.py: the one-device-thread contract, structural instead of
  conventional (the JAX package's ``jax-outside-dispatch``).
* DR003 ``signal-handler-unsafe`` — code reachable from a ``flag_only``
  role may not acquire locks, block, emit telemetry (``disco_tpu_torch.obs``)
  or do I/O (``disco_tpu_torch.io``, ``open``/``print``) — the
  handler-self-deadlock bug class.
* DR004 ``blocking-under-lock``   — no blocking call (zero-timeout
  ``join``/``get``/``put``/``wait``/``result``, ``recv``/``accept``/
  ``select``, ``time.sleep``) while ANY registered lock is held, directly
  or through the call graph.
* DR005 ``unregistered-lock``     — every ``Lock``/``RLock``/
  ``Condition`` creation must land on a registered id (registries.py);
  lock-looking ``with`` targets that resolve to nothing are findings, and
  so are registry entries with no surviving creation site (dead entries
  hide drift exactly like dead suppressions).
* DR006 ``lock-order-cycle``      — the global lock-acquisition graph
  (``with`` nesting propagated through calls) must be acyclic; a self-
  edge is a non-reentrant re-acquisition (instant deadlock).
* DR007 ``unlocked-shared-write`` — an instance attribute written from
  functions reachable from >= 2 roles needs one common lock held at every
  write site (``__init__`` writes are excluded: construction
  happens-before thread start).
* DR008 ``manifest-drift``        — the computed concurrency manifest
  must match the committed ``analysis/golden/threads.json``
  (:mod:`disco_tpu_torch.analysis.race.manifest`).

The port's copy of ``disco_tpu/analysis/race/checks.py``: DR001 and
DR003–DR008 unchanged, DR002 re-read for torch.

No reference counterpart: the reference repo is single-threaded.
"""
from __future__ import annotations

from disco_tpu_torch.analysis.findings import Finding
from disco_tpu_torch.analysis.race.callgraph import Index, attr_chain

#: id -> (name, one-line summary) — the ``--list-checks`` catalog
CHECKS = {
    "DR001": ("unregistered-thread",
              "thread/timer/executor/signal targets must resolve to a "
              "registered role entry point"),
    "DR002": ("torch-outside-dispatch",
              "torch-touching code reachable only from torch_ok roles "
              "(race/roles.py: dispatch/main + declared exceptions) — "
              "the one-device-thread contract"),
    "DR003": ("signal-handler-unsafe",
              "signal-handler-reachable code is flag-set only: no locks, "
              "no blocking, no obs, no I/O"),
    "DR004": ("blocking-under-lock",
              "no blocking call while holding a registered lock "
              "(directly or through the call graph)"),
    "DR005": ("unregistered-lock",
              "every Lock/RLock/Condition is a registered named attribute "
              "(race/registries.py)"),
    "DR006": ("lock-order-cycle",
              "the global lock-acquisition graph is acyclic "
              "(self-edge = non-reentrant re-acquire)"),
    "DR007": ("unlocked-shared-write",
              "attributes written from >= 2 roles need a common lock at "
              "every write site"),
    "DR008": ("manifest-drift",
              "the concurrency manifest matches the committed "
              "golden/threads.json"),
}

#: the engine's suppression-hygiene pseudo-rule (cannot be suppressed)
HYGIENE_RULE = ("DR000", "race-suppression")

#: where registry-level findings (stale entry points, dead lock entries)
#: anchor — the registries are source files too
ROLES_REL = "disco_tpu_torch/analysis/race/roles.py"
LOCKS_REL = "disco_tpu_torch/analysis/race/registries.py"

#: modules forbidden from signal handlers (telemetry + I/O layers)
_HANDLER_FORBIDDEN_MODULES = ("disco_tpu_torch.obs", "disco_tpu_torch.io")


def _finding(check_id: str, rel: str, node, message: str) -> Finding:
    return Finding(
        path=rel,
        line=getattr(node, "lineno", 1) if node is not None else 1,
        col=getattr(node, "col_offset", 0) if node is not None else 0,
        rule=check_id,
        name=CHECKS[check_id][0],
        message=message,
    )


def blocking_desc(site) -> str | None:
    """Classify one call site as a blocking primitive (DR003/DR004), or
    None.  Timeouts make a call bounded: ``q.get(timeout=0.05)`` and
    ``thread.join(t)`` pass; zero-argument forms block forever."""
    chain = site.chain
    if chain is None:
        return None
    leaf = chain[-1]
    kw = set(site.keywords)
    if leaf == "sleep" and chain[0] == "time":
        return "time.sleep"
    if leaf in ("recv", "accept", "select") and len(chain) >= 2:
        return f".{leaf}()"
    if leaf == "join" and site.n_args == 0 and not kw:
        return ".join() without timeout"
    if leaf == "get" and site.n_args == 0 and "timeout" not in kw:
        return ".get() without timeout"
    if (leaf == "put" and site.n_args == 1
            and not kw.intersection({"timeout", "block"})):
        return ".put() without timeout"
    if leaf == "wait" and site.n_args == 0 and "timeout" not in kw:
        return ".wait() without timeout"
    if leaf == "result" and site.n_args == 0 and "timeout" not in kw:
        return ".result() without timeout"
    return None


class Analysis:
    """Resolved call graph + role reachability, shared by the checks and
    the manifest's construction."""

    def __init__(self, index: Index, roles: dict):
        self.index = index
        self.roles = roles
        #: qual -> tuple of resolved target quals per call site (parallel
        #: to FunctionInfo.calls; None = unresolvable)
        self.call_targets: dict = {}
        #: qual -> set of callee quals
        self.edges: dict = {}
        for qual, fn in index.functions.items():
            targets = []
            out = set()
            for site in fn.calls:
                resolved = index.resolve_callable(site.chain, fn)
                targets.append(resolved)
                if resolved:
                    out.update(t for t in resolved if t in index.functions)
            self.call_targets[qual] = targets
            self.edges[qual] = out
        self.reach: dict = {}       # role -> {qual: parent qual or None}
        self.stale_entries: list = []
        for name, role in roles.items():
            tree: dict = {}
            queue = []
            for ep in role.entry_points:
                if ep in index.functions:
                    tree[ep] = None
                    queue.append(ep)
                else:
                    self.stale_entries.append((name, ep))
            while queue:
                cur = queue.pop()
                for nxt in self.edges.get(cur, ()):
                    if nxt not in tree:
                        tree[nxt] = cur
                        queue.append(nxt)
            self.reach[name] = tree

    def roles_reaching(self, qual: str) -> frozenset:
        return frozenset(n for n, tree in self.reach.items() if qual in tree)

    def path_to(self, role: str, qual: str) -> list:
        """Entry-point-to-function witness chain for one role."""
        tree = self.reach.get(role, {})
        out, cur = [], qual
        while cur is not None:
            out.append(cur)
            cur = tree.get(cur)
        return list(reversed(out))


# -- DR001 --------------------------------------------------------------------
def check_spawns(an: Analysis) -> list:
    """DR001: every spawn site resolves to a registered role entry point.

    No reference counterpart (module docstring)."""
    index, out = an.index, []
    entry_roles = {}
    for name, role in an.roles.items():
        for ep in role.entry_points:
            entry_roles[ep] = name
    for fn in index.functions.values():
        for spawn in fn.spawns:
            if spawn.target is None:
                out.append(_finding(
                    "DR001", fn.rel, spawn.node,
                    f"{spawn.kind} spawn without an explicit target "
                    "callable — the role cannot be inferred"))
                continue
            chain = attr_chain(spawn.target)
            resolved = index.resolve_callable(chain, fn)
            if not resolved:
                text = ".".join(chain) if chain else "<computed>"
                out.append(_finding(
                    "DR001", fn.rel, spawn.node,
                    f"{spawn.kind} target '{text}' does not resolve to a "
                    "known function — register the real target as a role "
                    "entry point (race/roles.py) or declare a "
                    "DYNAMIC_CALLS fallback"))
                continue
            for target in resolved:
                if target not in entry_roles:
                    out.append(_finding(
                        "DR001", fn.rel, spawn.node,
                        f"{spawn.kind} target '{target}' is not a "
                        "registered role entry point (race/roles.py) — "
                        "an unregistered thread is an unreviewed "
                        "concurrency surface"))
    for role_name, ep in an.stale_entries:
        out.append(_finding(
            "DR001", ROLES_REL, None,
            f"role '{role_name}' entry point '{ep}' not found in the "
            "program model — the function moved or was renamed; update "
            "race/roles.py"))
    return out


# -- DR002 --------------------------------------------------------------------
def check_torch_reachability(an: Analysis) -> list:
    """DR002: torch-touching calls reachable only from torch_ok roles.

    No reference counterpart (module docstring)."""
    index, out = an.index, []
    for role_name, role in an.roles.items():
        if role.torch_ok:
            continue
        for qual in an.reach[role_name]:
            fn = index.functions[qual]
            for site in fn.calls:
                if site.chain is None:
                    continue
                if index.is_torch_name(fn.module, site.chain):
                    path = " -> ".join(an.path_to(role_name, qual))
                    out.append(_finding(
                        "DR002", fn.rel, site.node,
                        f"torch call '{'.'.join(site.chain)}' is reachable "
                        f"from role '{role_name}' ({path}) — only torch_ok "
                        "roles (race/roles.py) may enter torch (one thread "
                        "queues the card's work)"))
    return out


# -- DR003 --------------------------------------------------------------------
def check_signal_safety(an: Analysis) -> list:
    """DR003: flag_only roles may not lock, block, emit obs or do I/O.

    No reference counterpart (module docstring)."""
    index, out = an.index, []
    for role_name, role in an.roles.items():
        if not role.flag_only:
            continue
        for qual in an.reach[role_name]:
            fn = index.functions[qual]
            via = " -> ".join(an.path_to(role_name, qual))
            for acq in fn.acquires:
                out.append(_finding(
                    "DR003", fn.rel, acq.node,
                    f"lock acquisition '{acq.text}' reachable from "
                    f"signal handler ({via}) — a handler interrupting the "
                    "lock's own holder self-deadlocks; handlers only set "
                    "flags"))
            for site, targets in zip(fn.calls, an.call_targets[qual]):
                desc = blocking_desc(site)
                if desc is not None:
                    out.append(_finding(
                        "DR003", fn.rel, site.node,
                        f"blocking call {desc} reachable from signal "
                        f"handler ({via})"))
                    continue
                if site.chain and site.chain[-1] in ("open", "print"):
                    out.append(_finding(
                        "DR003", fn.rel, site.node,
                        f"I/O call '{'.'.join(site.chain)}' reachable "
                        f"from signal handler ({via})"))
                    continue
                for target in targets or ():
                    tmod = target.partition(":")[0]
                    if tmod.startswith(_HANDLER_FORBIDDEN_MODULES):
                        out.append(_finding(
                            "DR003", fn.rel, site.node,
                            f"call into '{target}' reachable from signal "
                            f"handler ({via}) — telemetry/I-O layers "
                            "acquire non-reentrant locks (the handler "
                            "self-deadlock class); set a flag and emit from "
                            "the next poll instead"))
    return out


# -- DR004 --------------------------------------------------------------------
def check_blocking_under_lock(an: Analysis) -> list:
    """DR004: no blocking call while any registered lock is held.

    No reference counterpart (module docstring)."""
    index, out = an.index, []
    # transitive may-block, with one witness description per function
    witness: dict = {}
    for qual, fn in index.functions.items():
        for site in fn.calls:
            desc = blocking_desc(site)
            if desc is not None:
                witness.setdefault(qual, f"{desc} at {fn.rel}:{site.node.lineno}")
    changed = True
    while changed:
        changed = False
        for qual in index.functions:
            if qual in witness:
                continue
            for callee in an.edges.get(qual, ()):
                if callee in witness:
                    witness[qual] = f"via {callee} ({witness[callee]})"
                    changed = True
                    break
    for qual, fn in index.functions.items():
        for site, targets in zip(fn.calls, an.call_targets[qual]):
            if not site.held:
                continue
            held = ", ".join(sorted(site.held))
            desc = blocking_desc(site)
            if desc is not None:
                out.append(_finding(
                    "DR004", fn.rel, site.node,
                    f"blocking call {desc} while holding {held} — a "
                    "stalled peer wedges every thread contending for the "
                    "lock"))
                continue
            for target in targets or ():
                if target in witness:
                    out.append(_finding(
                        "DR004", fn.rel, site.node,
                        f"call to '{target}' may block ({witness[target]}) "
                        f"while holding {held}"))
                    break
    return out


# -- DR005 --------------------------------------------------------------------
def check_lock_registry(an: Analysis) -> list:
    """DR005: every lock creation lands on a registered id, and every
    registered id still has a creation site.

    No reference counterpart (module docstring)."""
    index, out = an.index, []
    created = set()
    for fn in index.functions.values():
        for creation in fn.creations:
            if creation.lock is None:
                out.append(_finding(
                    "DR005", fn.rel, creation.node,
                    "anonymous lock creation (not a module- or "
                    "instance-level named attribute) — it cannot "
                    "participate in the lock-order analysis"))
            elif creation.lock not in index.locks:
                out.append(_finding(
                    "DR005", fn.rel, creation.node,
                    f"lock '{creation.lock}' is not registered in "
                    "race/registries.py — register it with a one-line "
                    "statement of what it guards"))
            else:
                created.add(creation.lock)
        for acq in fn.acquires:
            if acq.lock is None:
                out.append(_finding(
                    "DR005", fn.rel, acq.node,
                    f"acquisition of unregistered/unresolvable lock "
                    f"'{acq.text}' — the order analysis cannot see it"))
    for lid in sorted(index.locks):
        if lid not in created:
            out.append(_finding(
                "DR005", LOCKS_REL, None,
                f"registered lock '{lid}' has no creation site in the "
                "program model — the lock moved or died; update "
                "race/registries.py"))
    return out


# -- DR006 --------------------------------------------------------------------
def lock_order_edges(an: Analysis) -> dict:
    """``(lockA, lockB) -> witness`` — A held while B is (transitively)
    acquired."""
    index = an.index
    # transitive lock-acquisition sets per function
    acq: dict = {q: {a.lock for a in fn.acquires if a.lock is not None}
                 for q, fn in index.functions.items()}
    changed = True
    while changed:
        changed = False
        for qual in index.functions:
            mine = acq[qual]
            before = len(mine)
            for callee in an.edges.get(qual, ()):
                mine |= acq[callee]
            if len(mine) != before:
                changed = True
    edges: dict = {}
    for qual, fn in index.functions.items():
        for a in fn.acquires:
            if a.lock is None:
                continue
            for h in a.held_before:
                edges.setdefault((h, a.lock),
                                 f"{fn.rel}:{a.node.lineno}")
        for site, targets in zip(fn.calls, an.call_targets[qual]):
            if not site.held:
                continue
            for target in targets or ():
                for t in acq.get(target, ()):
                    for h in site.held:
                        edges.setdefault(
                            (h, t),
                            f"{fn.rel}:{site.node.lineno} via {target}")
    return edges


def check_lock_order(an: Analysis) -> list:
    """DR006: the global lock-acquisition graph is acyclic.

    No reference counterpart (module docstring)."""
    edges = lock_order_edges(an)
    out = []
    adj: dict = {}
    for (a, b), wit in edges.items():
        if a == b:
            out.append(Finding(
                path=LOCKS_REL, line=1, col=0, rule="DR006",
                name=CHECKS["DR006"][0],
                message=f"non-reentrant re-acquisition of '{a}' ({wit}) — "
                        "instant self-deadlock"))
            continue
        adj.setdefault(a, set()).add(b)
    # cycle detection: iterative DFS with color marking
    color: dict = {}
    stack_path: list = []

    def visit(node):
        color[node] = 1
        stack_path.append(node)
        for nxt in sorted(adj.get(node, ())):
            if color.get(nxt, 0) == 1:
                cycle = stack_path[stack_path.index(nxt):] + [nxt]
                wits = "; ".join(
                    edges.get((cycle[i], cycle[i + 1]), "?")
                    for i in range(len(cycle) - 1))
                out.append(Finding(
                    path=LOCKS_REL, line=1, col=0, rule="DR006",
                    name=CHECKS["DR006"][0],
                    message=("lock-order cycle "
                             + " -> ".join(cycle)
                             + f" (witnesses: {wits}) — two threads taking "
                               "the cycle from different ends deadlock")))
            elif color.get(nxt, 0) == 0:
                visit(nxt)
        stack_path.pop()
        color[node] = 2

    for node in sorted(adj):
        if color.get(node, 0) == 0:
            visit(node)
    return out


# -- DR007 --------------------------------------------------------------------
def check_shared_writes(an: Analysis) -> list:
    """DR007: cross-role attribute writes need one common lock.

    No reference counterpart (module docstring)."""
    index, out = an.index, []
    grouped: dict = {}   # (class qual, attr) -> [(fn, write, roles)]
    for qual, fn in index.functions.items():
        if fn.cls is None or qual.endswith(".__init__"):
            continue
        roles = an.roles_reaching(qual)
        if not roles:
            continue
        for w in fn.writes:
            grouped.setdefault((f"{fn.module}:{fn.cls}", w.attr),
                               []).append((fn, w, roles))
    for (cqual, attr), sites in sorted(grouped.items()):
        all_roles = frozenset().union(*(r for _, _, r in sites))
        if len(all_roles) < 2:
            continue
        common = frozenset.intersection(
            *(frozenset(w.held) for _, w, _ in sites))
        if common:
            continue
        sites = sorted(sites, key=lambda s: (s[0].rel, s[1].node.lineno))
        where = ", ".join(f"{fn.rel}:{w.node.lineno}" for fn, w, _ in sites)
        # anchor at the first UNGUARDED site — that is where a fix (or a
        # justified suppression) belongs
        fn0, w0, _ = next(
            (s for s in sites if not s[1].held), sites[0])
        out.append(_finding(
            "DR007", fn0.rel, w0.node,
            f"'{cqual}.{attr}' is written from roles "
            f"{{{', '.join(sorted(all_roles))}}} with no common lock "
            f"(write sites: {where}) — guard it, or justify why the "
            "stores cannot race"))
    return out


def run_checks(an: Analysis) -> list:
    """All graph checks (DR008 manifest drift lives in
    :mod:`disco_tpu_torch.analysis.race.manifest`)."""
    out = []
    out.extend(check_spawns(an))
    out.extend(check_torch_reachability(an))
    out.extend(check_signal_safety(an))
    out.extend(check_blocking_under_lock(an))
    out.extend(check_lock_registry(an))
    out.extend(check_lock_order(an))
    out.extend(check_shared_writes(an))
    return out
