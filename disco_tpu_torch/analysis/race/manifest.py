"""The committed concurrency manifest: the port's threading topology as a
reviewable artifact (the port's copy of
``disco_tpu/analysis/race/manifest.py``; roles carry ``torch_ok`` where the
JAX manifest carries ``jax_ok``).

``analysis/golden/threads.json`` records, per role, the entry points and
the registered locks its reachable code acquires, plus the global spawn
map and the lock-order edges — a pure function of the program model
(canonical JSON: sorted keys, fixed indent, trailing newline), so
rebuilding unchanged code reproduces it bit-identically, exactly like the
trace goldens.  Any drift — a new thread, a role acquiring a lock it
never held, a new lock-order edge — fails DR008 until ``disco-torch-race
--update`` regenerates the file and the diff is reviewed in the PR.

Deliberately NOT in the manifest: line numbers, reachable-function counts,
source text — anything that churns under refactors that do not change the
threading topology.

No reference counterpart: the reference repo is single-threaded.
"""
from __future__ import annotations

import json

from disco_tpu_torch.analysis.findings import Finding
from disco_tpu_torch.analysis.race.callgraph import attr_chain
from disco_tpu_torch.analysis.race.checks import CHECKS, Analysis, lock_order_edges

#: bump on incompatible schema change — a mismatch reports "regenerate
#: with --update", not a topology drift
VERSION = 1

#: repo-relative home of the committed manifest
GOLDEN_REL = "disco_tpu_torch/analysis/golden/threads.json"


def build(an: Analysis) -> dict:
    """The manifest dict (module docstring) from one analysis."""
    roles = {}
    for name, role in an.roles.items():
        locks = set()
        for qual in an.reach[name]:
            fn = an.index.functions[qual]
            locks.update(a.lock for a in fn.acquires if a.lock is not None)
        roles[name] = {
            "entry_points": sorted(role.entry_points),
            "torch_ok": role.torch_ok,
            "flag_only": role.flag_only,
            "locks_held": sorted(locks),
        }
    entry_roles = {}
    for name, role in an.roles.items():
        for ep in role.entry_points:
            entry_roles[ep] = name
    spawns: dict = {}
    for qual, fn in an.index.functions.items():
        for spawn in fn.spawns:
            chain = attr_chain(spawn.target) if spawn.target is not None else None
            resolved = an.index.resolve_callable(chain, fn) or ()
            for target in resolved:
                spawns[target] = {
                    "kind": spawn.kind,
                    "role": entry_roles.get(target, "<unregistered>"),
                }
    return {
        "version": VERSION,
        "roles": roles,
        "locks": sorted(an.index.locks),
        "lock_order": sorted(f"{a} -> {b}" for a, b in lock_order_edges(an)),
        "spawns": spawns,
    }


def dumps(manifest: dict) -> str:
    """Canonical JSON text (the committed byte format)."""
    return json.dumps(manifest, indent=2, sort_keys=True) + "\n"


def diff(golden: dict, current: dict) -> list:
    """Readable drift messages, empty when identical."""
    out: list = []
    if golden.get("version") != current.get("version"):
        return [f"manifest schema version {golden.get('version')} != "
                f"{current.get('version')}: regenerate with "
                "`disco-torch-race --update`"]
    gr, cr = golden.get("roles", {}), current.get("roles", {})
    for name in sorted(set(gr) | set(cr)):
        if name not in cr:
            out.append(f"role '{name}' disappeared")
            continue
        if name not in gr:
            out.append(f"new role '{name}'")
            continue
        for key in ("entry_points", "torch_ok", "flag_only", "locks_held"):
            if gr[name].get(key) != cr[name].get(key):
                out.append(f"role '{name}' {key}: {gr[name].get(key)} -> "
                           f"{cr[name].get(key)}")
    for key in ("locks", "lock_order"):
        a, b = golden.get(key, []), current.get(key, [])
        if a != b:
            gone = sorted(set(a) - set(b))
            new = sorted(set(b) - set(a))
            out.append(f"{key}: {'removed ' + str(gone) if gone else ''}"
                       f"{' ' if gone and new else ''}"
                       f"{'added ' + str(new) if new else ''}".strip()
                       or f"{key} reordered")
    gs, cs = golden.get("spawns", {}), current.get("spawns", {})
    for target in sorted(set(gs) | set(cs)):
        if gs.get(target) != cs.get(target):
            out.append(f"spawn '{target}': {gs.get(target)} -> "
                       f"{cs.get(target)}")
    return out


def drift_findings(golden: dict | None, current: dict) -> list:
    """DR008 findings anchored at the committed golden."""
    if golden is None:
        return [Finding(
            path=GOLDEN_REL, line=1, col=0, rule="DR008",
            name=CHECKS["DR008"][0],
            message="no committed concurrency manifest — run "
                    "`disco-torch-race --update` and commit the result")]
    return [
        Finding(path=GOLDEN_REL, line=1, col=0, rule="DR008",
                name=CHECKS["DR008"][0],
                message=f"concurrency manifest drift: {msg} — review the "
                        "change, then `disco-torch-race --update`")
        for msg in diff(golden, current)
    ]
