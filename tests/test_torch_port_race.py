"""disco-torch-race (``disco_tpu_torch.analysis.race``) held against the JAX
package's disco-race (``disco_tpu.analysis.race``) on the same seeded
miniature programs.

* DR001 and DR003-DR008 (and the DR000 hygiene): the programs of
  ``tests/test_race.py``, analyzed by both engines with the same
  registries, give equal ``(rule, line, col)`` sets;
* DR002, re-read as ``torch-outside-dispatch``: a torch transliteration of
  each JAX program gives findings at the same lines (a flagged case and a
  near-miss case);
* the port tree analyzes clean against its committed manifest, which
  rebuilds bit for bit twice; every shipped waiver is load-bearing; the
  revert fixtures (a handler in a lock, torch on the tap thread, an
  unregistered spawn) fail the gate; the CLI's JSON is JAX's schema; and
  a fresh interpreter runs both gates without importing jax.
"""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from disco_tpu.analysis.race import analyze as jax_analyze
from disco_tpu.analysis.race.roles import Role as JaxRole
from disco_tpu_torch.analysis.race import analyze
from disco_tpu_torch.analysis.race import manifest as manifest_mod
from disco_tpu_torch.analysis.race import runner as race_runner
from disco_tpu_torch.analysis.race.checks import CHECKS, HYGIENE_RULE
from disco_tpu_torch.analysis.race.roles import ROLES, Role
from disco_tpu_torch.analysis.suppressions import parse

ROOT = Path(__file__).resolve().parents[1]


def _mini(engine, files, roles=(), locks=None, dynamic=None, marker="disco-torch-race"):
    """Analyze an in-memory program with its own registries; ``roles`` are
    ``(name, entry_points, device_ok, flag_only)``."""
    if engine == "jax":
        made = {n: JaxRole(n, tuple(eps), jax_ok=ok, flag_only=fo, summary="t")
                for n, eps, ok, fo in roles}
        run = jax_analyze
    else:
        made = {n: Role(n, tuple(eps), torch_ok=ok, flag_only=fo, summary="t")
                for n, eps, ok, fo in roles}
        run = analyze
    srcs = [(rel, textwrap.dedent(src).replace("# disco-race:", f"# {marker}:")
             if engine == "port" else textwrap.dedent(src)) for rel, src in files.items()]
    return run(files=srcs, roles=made, locks=dict(locks or {}),
               dynamic_calls=dict(dynamic or {}), attr_types={}, golden=False)


def _keys(res):
    return sorted((f.rule, f.line, f.col) for f in res.findings)


_SHARED = """
    import threading
    class C:
        def __init__(self):
            self.x = 0                      # construction: excluded
            self._lock = threading.Lock()
        def a(self):
            {a_body}
        def b(self):
            {b_body}
"""
_GUARDED = """
            with self._lock:
                self.x = 1"""

#: (program, roles, locks, dynamic) — the programs of tests/test_race.py
NEUTRAL = [
    ({"pkg/a.py": """
        import threading
        def run(): pass
        def rogue(): pass
        def main_():
            threading.Thread(target=run).start()
            threading.Thread(target=rogue).start()
    """}, [("worker", ["pkg.a:run"], False, False)], None, None),
    ({"pkg/a.py": """
        import signal
        import threading
        from concurrent.futures import ThreadPoolExecutor
        def fire(): pass
        def handler(signum, frame): pass
        def main_(cb):
            threading.Timer(2.0, fire).start()
            signal.signal(signal.SIGTERM, handler)
            with ThreadPoolExecutor() as ex:
                ex.submit(fire)
            signal.signal(signal.SIGTERM, cb)   # unresolvable target
    """}, [("watchdog", ["pkg.a:fire"], False, False),
           ("sig", ["pkg.a:handler"], False, True)], None, None),
    ({"pkg/a.py": "def run(): pass\n"}, [("worker", ["pkg.a:gone"], False, False)], None, None),
    ({"pkg/a.py": """
        import threading
        import time
        _lock = threading.Lock()
        def handler(signum, frame):
            deeper()
        def deeper():
            with _lock:
                pass
            time.sleep(0.1)
    """}, [("sig", ["pkg.a:handler"], False, True)], {"pkg.a::_lock": "test"}, None),
    ({"pkg/a.py": """
        class G:
            def handler(self, signum, frame):
                self.stopped = True
                self.reason = "sig"
    """}, [("sig", ["pkg.a:G.handler"], False, True)], None, None),
    ({"pkg/a.py": """
        import queue
        import threading
        import time
        _lock = threading.Lock()
        q = queue.Queue()
        def direct():
            with _lock:
                q.get()
        def indirect():
            with _lock:
                helper()
        def helper():
            time.sleep(1.0)
    """}, [], {"pkg.a::_lock": "test"}, None),
    ({"pkg/a.py": """
        import queue
        import threading
        _lock = threading.Lock()
        q = queue.Queue()
        def bounded(t):
            with _lock:
                q.get(timeout=0.05)
                q.put_nowait(1)
                t.join(5.0)
        def unlocked():
            q.get()
        def not_a_queue(d):
            with _lock:
                return d.get("key")   # dict.get takes args: not blocking
    """}, [], {"pkg.a::_lock": "test"}, None),
    ({"pkg/a.py": """
        import threading
        _lock = threading.Lock()
        _rogue = threading.Lock()
        def f(x):
            with x.some_lock:
                pass
    """}, [], {"pkg.a::_lock": "test", "pkg.a::_gone": "no creation site"}, None),
    ({"pkg/a.py": """
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
    """}, [], {"pkg.a:C::_lock": "test"}, None),
    ({"pkg/a.py": """
        import threading
        _A = threading.Lock()
        _B = threading.Lock()
        def f():
            with _A:
                with _B:
                    pass
        def g():
            with _B:
                helper()
        def helper():
            with _A:
                pass
    """}, [], {"pkg.a::_A": "a", "pkg.a::_B": "b"}, None),
    ({"pkg/a.py": """
        import threading
        _A = threading.Lock()
        def f():
            with _A:
                helper()
        def helper():
            with _A:
                pass
    """}, [], {"pkg.a::_A": "a"}, None),
    ({"pkg/a.py": """
        import threading
        _A = threading.Lock()
        _B = threading.Lock()
        def f():
            with _A:
                with _B:
                    pass
        def g():
            with _A:
                with _B:
                    pass
    """}, [], {"pkg.a::_A": "a", "pkg.a::_B": "b"}, None),
    ({"pkg/a.py": _SHARED.format(a_body="self.x = 1", b_body="self.x = 2")},
     [("r1", ["pkg.a:C.a"], False, False), ("r2", ["pkg.a:C.b"], False, False)],
     {"pkg.a:C::_lock": "test"}, None),
    ({"pkg/a.py": _SHARED.format(a_body=_GUARDED, b_body=_GUARDED.replace("= 1", "= 2"))},
     [("r1", ["pkg.a:C.a"], False, False), ("r2", ["pkg.a:C.b"], False, False)],
     {"pkg.a:C::_lock": "test"}, None),
    ({"pkg/a.py": _SHARED.format(a_body="self.x = 1", b_body="self.x = 2")},
     [("r1", ["pkg.a:C.a", "pkg.a:C.b"], False, False)], {"pkg.a:C::_lock": "test"}, None),
    # the shared suppression machinery and its DR000 hygiene
    ({"pkg/a.py": """
        import threading
        _rogue = threading.Lock()  # disco-race: disable=DR005 -- test fixture lock
    """}, [], {}, None),
    ({"pkg/a.py": """
        import threading
        _rogue = threading.Lock()  # disco-race: disable=DR005
        x = 1  # disco-race: disable=DR004 -- waives nothing
    """}, [], {}, None),
    ({"pkg/a.py": """
        import threading
        _rogue = threading.Lock()  # disco-race: disable=DR999 -- no such check
        y = 2  # disco-race: disable=DR000 -- nice try
    """}, [], {}, None),
]


@pytest.mark.parametrize("files,roles,locks,dynamic", NEUTRAL,
                         ids=[str(i) for i in range(len(NEUTRAL))])
def test_neutral_checks_match_the_jax_engine(files, roles, locks, dynamic):
    want = _keys(_mini("jax", files, roles, locks, dynamic))
    assert _keys(_mini("port", files, roles, locks, dynamic)) == want
    assert want or roles or locks is not None


def test_the_jax_marker_waives_nothing_in_the_port():
    files = {"pkg/a.py": """
        import threading
        _rogue = threading.Lock()  # disco-race: disable=DR005 -- the JAX gate's marker
    """}
    res = _mini("port", files, marker="disco-race")
    assert [f.rule for f in res.findings] == ["DR005"]
    res = _mini("port", files)
    assert res.findings == [] and [f.rule for f, _ in res.suppressed] == ["DR005"]


# -- DR002 re-read for torch ---------------------------------------------------
#: (JAX program, torch transliteration, roles, dynamic)
TORCH_READ = [
    ("""
        import jax.numpy as jnp
        import numpy as np
        def worker():
            helper()
            return np.zeros(3)        # numpy is fine anywhere
        def helper():
            return jnp.zeros(3)
    """, """
        import torch
        import numpy as np
        def worker():
            helper()
            return np.zeros(3)        # numpy is fine anywhere
        def helper():
            return torch.zeros(3)
    """, [("loader", ["pkg.a:worker"], False, False)], None),
    ("""
        import jax.numpy as jnp
        def worker():
            return jnp.zeros(3)
    """, """
        import torch.nn.functional as F
        def worker():
            return F.relu(x)
    """, [("driver", ["pkg.a:worker"], True, False)], None),
    ("""
        import jax.numpy as jnp
        def worker():
            return 1
        def helper():
            return jnp.zeros(3)
    """, """
        import torch
        def worker():
            return 1
        def helper():
            return torch.zeros(3)
    """, [("loader", ["pkg.a:worker"], False, False)], None),
    ("""
        import jax.numpy as jnp
        def worker():
            for _ in range(1):
                def helper():
                    return jnp.zeros(3)
                helper()
    """, """
        from torch import cuda
        def worker():
            for _ in range(1):
                def helper():
                    return cuda.synchronize()
                helper()
    """, [("loader", ["pkg.a:worker"], False, False)], None),
    ("""
        import jax
        class P:
            def __init__(self, cb):
                self._cb = cb
            def loop(self):
                self._cb()
        def jaxy():
            return jax.device_get(1)
    """, """
        import torch
        class P:
            def __init__(self, cb):
                self._cb = cb
            def loop(self):
                self._cb()
        def jaxy():
            return torch.ops.disco_torch.stft(1)
    """, [("loader", ["pkg.a:P.loop"], False, False)], None),
    ("""
        import jax
        class P:
            def __init__(self, cb):
                self._cb = cb
            def loop(self):
                self._cb()
        def jaxy():
            return jax.device_get(1)
    """, """
        import torch
        class P:
            def __init__(self, cb):
                self._cb = cb
            def loop(self):
                self._cb()
        def jaxy():
            return torch.ops.disco_torch.stft(1)
    """, [("loader", ["pkg.a:P.loop"], False, False)], {"pkg.a:P.loop::self._cb": ("pkg.a:jaxy",)}),
    ("""
        import numpy as np
        import jaxtyping
        def worker():
            return np.asarray(jaxtyping.x)
    """, """
        import numpy as np
        import torchaudio_like
        def worker(t):
            return np.asarray(torchaudio_like.x), t.numpy()
    """, [("loader", ["pkg.a:worker"], False, False)], None),
]


def _lines(res):
    return sorted(f.line for f in res.findings)


@pytest.mark.parametrize("jsrc,tsrc,roles,dynamic", TORCH_READ,
                         ids=[str(i) for i in range(len(TORCH_READ))])
def test_dr002_flags_the_same_lines(jsrc, tsrc, roles, dynamic):
    want = _lines(_mini("jax", {"pkg/a.py": jsrc}, roles, dynamic=dynamic))
    got = _mini("port", {"pkg/a.py": tsrc}, roles, dynamic=dynamic)
    assert _lines(got) == want
    assert all(f.rule == "DR002" and f.name == "torch-outside-dispatch" for f in got.findings)


def test_dr002_has_a_flagged_and_a_clean_case():
    counts = [len(_mini("port", {"pkg/a.py": t}, r, dynamic=d).findings)
              for _, t, r, d in TORCH_READ]
    assert any(counts) and not all(counts)


def test_catalog_matches_the_jax_catalog():
    from disco_tpu.analysis.race.checks import CHECKS as JAX_CHECKS

    assert list(CHECKS) == list(JAX_CHECKS)
    assert {k: v[0] for k, v in CHECKS.items() if k != "DR002"} == \
        {k: v[0] for k, v in JAX_CHECKS.items() if k != "DR002"}
    assert CHECKS["DR002"][0] == "torch-outside-dispatch"
    assert HYGIENE_RULE == ("DR000", "race-suppression")


def test_only_main_and_dispatch_may_enter_torch():
    assert {n for n, r in ROLES.items() if r.torch_ok} == {"main", "dispatch"}
    assert [n for n, r in ROLES.items() if r.flag_only] == ["signal_handler"]
    assert "launches no kernel" in ROLES["device_feeder"].summary


# -- the port tree ---------------------------------------------------------------
@pytest.fixture(scope="module")
def clean():
    return analyze()


def test_port_tree_analyzes_clean(clean):
    assert clean.findings == [], "\n".join(f.render() for f in clean.findings)
    assert clean.n_files > 150
    assert all(just.strip() for _, just in clean.suppressed)


@pytest.fixture(scope="module")
def audit():
    """The port tree with every waiver ignored (a second, independent build
    of the manifest)."""
    return analyze(use_suppressions=False, golden=False)


def test_committed_manifest_rebuilds_bit_identically_twice(clean, audit):
    committed = (ROOT / manifest_mod.GOLDEN_REL).read_text()
    assert manifest_mod.dumps(clean.manifest) == manifest_mod.dumps(audit.manifest) == committed, (
        "concurrency manifest drift vs the committed golden — review the topology change "
        "and run `disco-torch-race --update`")
    m = json.loads(committed)
    assert set(m["roles"]) == set(ROLES)
    assert all("torch_ok" in r for r in m["roles"].values())


def test_every_shipped_race_suppression_is_load_bearing(audit):
    at_line = {(f.path, f.rule, f.line) for f in audit.findings}
    known = race_runner.known_check_ids()
    waivers = []
    for path in sorted((ROOT / "disco_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        rel = path.relative_to(ROOT).as_posix()
        sups, problems = parse(rel, path.read_text(), known, tool="disco-torch-race",
                               hygiene_rule=HYGIENE_RULE)
        assert problems == []
        waivers += [(rel, s) for s in sups]
    assert {(rel, s.rule_id) for rel, s in waivers} == {
        ("disco_tpu_torch/runs/interrupt.py", "DR001"),
        ("disco_tpu_torch/runs/interrupt.py", "DR007"),
        ("disco_tpu_torch/serve/server.py", "DR007"),
        ("disco_tpu_torch/utils/resilience.py", "DR007"),
    }
    for rel, s in waivers:
        assert (rel, s.rule_id, s.line) in at_line, f"{rel}:{s.comment_line} waives nothing"


#: the revert fixtures: (file, anchor, its buggy replacement, the check
#: that must fire, a word of its message)
REVERTS = {
    # the handler routed through _trip, whose telemetry flush takes obs's locks
    "handler-in-lock": ("disco_tpu_torch/runs/interrupt.py",
                        "        self.stopped = True\n        self.reason = self.reason or name\n",
                        "        self._trip(name)\n", "DR003", "signal handler"),
    # a torch call reachable from the tap-writer thread
    "torch-on-tap-thread": ("disco_tpu_torch/flywheel/tap.py", "self._buf.append(item)",
                            "import torch\n                self._buf.append(torch.as_tensor(item))",
                            "DR002", "tap_writer"),
    # an unregistered thread
    "unregistered-spawn": ("disco_tpu_torch/flywheel/tap.py",
                           "    def close(self, timeout_s: float = 30.0) -> dict:",
                           "    def _rogue(self):\n"
                           "        threading.Thread(target=self._rogue_worker).start()\n\n"
                           "    def _rogue_worker(self):\n        pass\n\n"
                           "    def close(self, timeout_s: float = 30.0) -> dict:",
                           "DR001", "_rogue_worker"),
    # a kernel fence from the promotion controller's thread
    "torch-on-controller": ("disco_tpu_torch/promote/controller.py",
                            "    def _gate_checks(self) -> list:",
                            "    def _gate_checks(self) -> list:\n        import torch\n"
                            "        torch.cuda.synchronize()", "DR002", "promote_controller"),
}


@pytest.fixture(scope="module")
def reverted():
    """The port tree with every revert applied at once (each in its own
    file region, so each check fires on its own)."""
    sources = {}
    for rel, old, new, _, _ in REVERTS.values():
        src = sources.get(rel) or (ROOT / rel).read_text()
        assert old in src, f"revert fixture anchor gone from {rel}: {old!r}"
        sources[rel] = src.replace(old, new)
    return analyze(overrides=sources, golden=False)


@pytest.mark.parametrize("name", list(REVERTS))
def test_reverts_fail_the_gate(reverted, clean, name):
    _, _, _, rule, needle = REVERTS[name]
    assert not any(f.rule == rule and needle in f.message for f in clean.findings)
    hits = [f for f in reverted.findings if f.rule == rule and needle in f.message]
    assert hits, "\n".join(f.render() for f in reverted.findings)


def test_cli_json_schema_and_exit_codes(capsys, monkeypatch):
    from disco_tpu_torch.analysis.findings import Finding
    from disco_tpu_torch.analysis.race import cli

    assert cli.main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    assert "DR000" in out and "DR008" in out and "torch-outside-dispatch" in out
    dirty = race_runner.RaceResult(
        findings=[Finding(path="x.py", line=1, col=0, rule="DR001",
                          name="unregistered-thread", message="boom")],
        suppressed=[], n_files=1, manifest={})
    monkeypatch.setattr(race_runner, "analyze", lambda **kw: dirty)
    assert cli.main(["--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {"clean", "counts", "findings", "suppressed"}   # disco-race's keys
    assert set(doc["counts"]) == {"findings", "suppressed", "files", "by_rule"}
    assert set(doc["findings"][0]) == {"path", "line", "col", "rule", "name", "message"}
    assert doc["counts"]["by_rule"] == {"DR001": 1}


def test_both_gates_run_in_a_fresh_interpreter_without_jax():
    """Both commands exit 0 in a fresh interpreter that never loads jax
    (the gates are hermetic: stdlib-only, no device)."""
    code = (
        "import sys\n"
        "from disco_tpu_torch.analysis import cli\n"
        "from disco_tpu_torch.analysis.race import cli as race_cli\n"
        "rc = cli.main([]) or race_cli.main([])\n"
        "assert 'jax' not in sys.modules, 'a gate imported jax'\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "disco-torch-lint: 0 finding(s)" in proc.stdout
    assert "disco-torch-race: 0 finding(s)" in proc.stdout
