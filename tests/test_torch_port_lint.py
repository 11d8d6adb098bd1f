"""disco-torch-lint (``disco_tpu_torch.analysis``) held against the JAX
package's disco-lint (``disco_tpu.analysis``) on the same seeded sources.

* the framework-neutral rules (DL000, DL004, DL006-DL010, DL013-DL015):
  the snippet bodies of ``tests/test_lint.py``, linted by the JAX engine at
  their ``disco_tpu/...`` path and by the port's at the ``disco_tpu_torch/
  ...`` path (imports renamed alike), give equal ``(rule, line, col)`` sets;
* the rules re-read for torch (DL001-DL003, DL012, DL016): a torch
  transliteration of each JAX snippet gives findings at the same lines,
  with a flagged case and a near-miss case each;
* DL011 has no counterpart: the JAX rule's snippets give no port finding;
* the port tree lints clean, every shipped suppression is load-bearing,
  the report schema is JAX's, ``SEAMS`` is JAX's set and covers every
  ``tick`` literal of the port, and no linter module imports torch, jax,
  triton or the JAX package.
"""
from __future__ import annotations

import ast
import json
import re
import textwrap
from pathlib import Path

import pytest

from disco_tpu import analysis as jax_analysis
from disco_tpu.analysis import registries as jax_registries
from disco_tpu.analysis import report as jax_report
from disco_tpu_torch import analysis
from disco_tpu_torch.analysis import registries, report
from disco_tpu_torch.analysis import suppressions as sup
from disco_tpu_torch.analysis.registry import known_rule_ids

ROOT = Path(__file__).resolve().parents[1]


def _port_text(text: str) -> str:
    """A JAX snippet or path as the port's: ``disco_tpu`` names become
    ``disco_tpu_torch`` and the JAX gate's marker the port's."""
    text = re.sub(r"\bdisco_tpu\b", "disco_tpu_torch", text)
    return text.replace("# disco-lint:", "# disco-torch-lint:")


def _keys(res, only=None):
    return sorted((f.rule, f.line, f.col) for f in res.findings
                  if only is None or f.rule in only)


def _jax(src, rel, rules=None):
    return jax_analysis.lint_source(textwrap.dedent(src), rel, rules=rules)


def _port(src, rel, rules=None, suppress=True):
    return analysis.lint_source(textwrap.dedent(src), rel, rules=rules,
                                use_suppressions=suppress)


# -- the framework-neutral rules: JAX's snippets, equal findings ---------------
#: (rule, snippet body of tests/test_lint.py, its disco_tpu path)
NEUTRAL = [
    ("DL004", """
    import numpy as np, pickle, soundfile as sf
    def persist(path, arr, obj, sig):
        np.save(path, arr)
        with open(path, "w") as fh:
            fh.write("x")
        with pickle_path.open(mode="wb") as fh:
            pickle.dump(obj, fh)
        sf.write(path, sig, 16000)
        path.write_bytes(b"x")
    """, "disco_tpu/datagen/foo.py"),
    ("DL004", "import gzip, io\ngzip.open(p, 'wb')\nio.open(p, 'w')\n", "disco_tpu/runs/foo.py"),
    ("DL004", "import gzip\ngzip.open(p)\ngzip.open(p, 'rb')\n", "disco_tpu/runs/foo.py"),
    ("DL004", """
    import numpy as np
    from disco_tpu.io.atomic import save_npy_atomic, atomic_write
    def ok(path, arr):
        save_npy_atomic(path, arr)          # the sanctioned writer
        with open(path) as fh:              # read mode
            fh.read()
        with open(path, "a") as fh:         # append: the ledger protocol
            fh.write("line")
        with open(path, mode) as fh:        # non-literal mode: skipped
            fh.write("x")
        np.save_other(path, arr)            # not a numpy writer
    """, "disco_tpu/runs/foo.py"),
    ("DL004", "import numpy as np\nnp.save(p, a)\n", "disco_tpu/core/foo.py"),
    ("DL004", "import numpy as np\nfor k in range(4):\n    np.save(p, arr[k])\n",
     "disco_tpu/enhance/zexport.py"),
    ("DL006", '''
    """Module docstring with no citation."""
    def undocumented():
        return 1
    def uncited():
        """Does things."""
        return 2
    ''', "disco_tpu/core/foo.py"),
    ("DL006", '''
    """Module docstring with no citation."""
    def cited():
        """Twin of the reference loop (tango.py:528-639)."""
    def declared():
        """No reference counterpart: invented here."""
    def _private():
        pass
    ''', "disco_tpu/core/foo.py"),
    ("DL006", '''
    """Helpers for the reference main (tango.py:1-100)."""
    def helper():
        """Small helper."""
    ''', "disco_tpu/core/foo.py"),
    ("DL006", '''
    """Module docstring with no citation."""
    def f():
        """Sorts by user preference."""
    ''', "disco_tpu/core/foo.py"),
    ("DL007", "streaming_tango(Y, m, m, mu=1)\ntango(Y, lambda_cor=0)\n", "disco_tpu/enhance/foo.py"),
    ("DL007", "f(mu=1.0)\nf(lambda_cor=0.99)\nf(mu=mu)\nf(nu=1)\nf(1)\n", "disco_tpu/enhance/foo.py"),
    ("DL008", """
    import os, signal
    os.kill(pid, signal.SIGTERM)
    proc.kill()
    proc.terminate()
    sig = signal.SIGKILL
    """, "disco_tpu/runs/foo.py"),
    ("DL008", """
    def kill(session):      # a local function named kill is not os.kill
        drop(session)
    kill(s)
    state = proc.terminated  # attribute access, not the call
    msg = "never SIGKILL"    # strings/docstrings are not references
    """, "disco_tpu/runs/foo.py"),
    ("DL009", "from disco_tpu.obs import events as obs_events\nobs_events.record('clipz', rir=1)\n",
     "disco_tpu/enhance/foo.py"),
    ("DL009", """
    from disco_tpu.obs import events as obs_events
    obs_events.record("clip", rir=1)      # registered kind
    obs_events.record(kind_var, rir=1)    # non-literal: skipped
    ledger.record(unit, "done")           # a DIFFERENT record() API
    plan.record(mode="offline")
    """, "disco_tpu/enhance/foo.py"),
    ("DL010", "from disco_tpu.runs import chaos\nchaos.tick('mid_wrote')\n", "disco_tpu/enhance/foo.py"),
    ("DL010", """
    from disco_tpu.runs import chaos
    chaos.tick("mid_write")          # registered seam
    clock.tick(5)                    # non-string first arg: skipped
    accounting.fence_tick()          # different function
    """, "disco_tpu/enhance/foo.py"),
    ("DL013", """
    def fetch(x):
        while True:
            try:
                return readback(x)
            except OSError:
                continue
    """, "disco_tpu/enhance/foo.py"),
    ("DL013", """
    def fetch(x):
        for attempt in range(5):
            try:
                return readback(x)
            except (ConnectionError, TimeoutError):
                time.sleep(0.1)
    """, "disco_tpu/serve/foo.py"),
    ("DL013", """
    def fetch(x):
        while not done:
            try:
                step(x)
            except socket.error:
                pass
    """, "disco_tpu/io/foo.py"),
    ("DL013", """
    def fetch(x):
        while True:
            try:
                return readback(x)
            except OSError as e:
                raise RuntimeError("dead tunnel") from e
    """, "disco_tpu/enhance/foo.py"),
    ("DL013", """
    def load_all(paths):
        out = []
        for p in paths:
            try:
                out.append(read(p))
            except OSError:
                continue
        return out
    """, "disco_tpu/enhance/foo.py"),
    ("DL013", """
    def drain(q):
        try:
            while q:
                send(q.pop())
        except OSError:
            pass
    """, "disco_tpu/enhance/foo.py"),
    ("DL013", """
    def connect(addr):
        while True:
            try:
                return dial(addr)
            except OSError:
                time.sleep(0.05)
    """, "disco_tpu/utils/resilience.py"),
    ("DL013", """
    def connect(addr):
        while True:
            try:
                return dial(addr)
            except OSError:
                time.sleep(0.05)
    """, "disco_tpu/serve/client.py"),
    ("DL014", "from disco_tpu.obs import trace as obs_trace\nobs_trace.span('despatch', ctx)\n",
     "disco_tpu/serve/foo.py"),
    ("DL014", "from disco_tpu.obs import trace as obs_trace\nobs_trace.root(stage='client_blok')\n",
     "disco_tpu/serve/foo.py"),
    ("DL014", "from disco_tpu.obs import trace as obs_trace\n"
              "obs_trace.record_span('tapp', ctx, parent=p)\n", "disco_tpu/flywheel/foo.py"),
    ("DL014", "from disco_tpu.serve.status import status_section\n"
              "status_section(payload, 'counterz')\n", "disco_tpu/cli/foo.py"),
    ("DL014", """
    from disco_tpu.obs import trace as obs_trace
    from disco_tpu.serve.status import status_section
    obs_trace.span("dispatch", ctx)          # registered hop
    obs_trace.root("client_block", seq=1)    # registered root
    obs_trace.span(stage_var, ctx)           # non-literal: skipped
    status_section(payload, "counters")      # registered section
    status_section(payload, name_var)        # non-literal: skipped
    tree.span(3)                             # a DIFFERENT span() API
    math.root(x)                             # a DIFFERENT root()
    """, "disco_tpu/serve/foo.py"),
    ("DL015", """
    import threading
    _rogue_lock = threading.Lock()
    def nope(): pass
    t = threading.Thread(target=nope)
    threading.Timer(2.0, nope)
    """, "disco_tpu/foo.py"),
    ("DL015", "import threading\nlocks = [threading.Lock()]\n", "disco_tpu/foo.py"),
    ("DL015", """
    import threading
    class Tap:
        def _run(self): pass
        def start(self):
            threading.Thread(target=self._run).start()
    """, "disco_tpu/foo.py"),
    ("DL015", """
    import threading
    class CorpusTap:
        def __init__(self):
            self._lock = threading.Lock()
    """, "disco_tpu/flywheel/tap.py"),
    ("DL015", "from mylib import Lock\nx = Lock()\n", "disco_tpu/foo.py"),
    ("DL015", "def Thread(target): pass\nThread(target=1)\n", "disco_tpu/foo.py"),
    ("DL015", """
    import threading
    class DispatchDeadlineLike:
        def _fire(self): pass
        def arm(self):
            self._timer = threading.Timer(1.0, self._fire)
    """, "disco_tpu/foo.py"),
]


@pytest.mark.parametrize("rule,src,rel", NEUTRAL,
                         ids=[f"{r}-{i}" for i, (r, _, _) in enumerate(NEUTRAL)])
def test_neutral_rules_match_the_jax_engine(rule, src, rel):
    want = _keys(_jax(src, rel, rules={rule}))
    got = _keys(_port(_port_text(src), _port_text(rel), rules={rule}))
    assert got == want


#: DL000 hygiene: (snippet, rules) of tests/test_lint.py; only the DL000
#: findings are compared (DL001 itself is re-read for torch)
HYGIENE = [
    ("x = 1  # disco-lint: disable=DL999 -- no such rule\n", None),
    ("x = 1  # disco-lint: disable=DL000 -- nice try\n", None),
    ("x = 1  # disco-lint: disable=DL001 -- waives nothing\n", {"DL001"}),
    ("x = 1  # disco-lint: disable=DL001 -- waives nothing\n", {"DL005"}),
    ("import jax\njax.block_until_ready(x)  # disco-lint: disable=DL001\n", {"DL001"}),
    ("x = 1  # disco-lint: disable= -- names nothing\n", None),
]


@pytest.mark.parametrize("src,rules", HYGIENE, ids=[str(i) for i in range(len(HYGIENE))])
def test_dl000_hygiene_matches_the_jax_engine(src, rules):
    rel = "disco_tpu/enhance/foo.py"
    want = _keys(_jax(src, rel, rules=rules), only={"DL000"})
    got = _keys(_port(_port_text(src), _port_text(rel), rules=rules), only={"DL000"})
    assert got == want


def test_the_jax_marker_waives_nothing_in_the_port():
    src = "f(mu=1)  # disco-lint: disable=DL007 -- the JAX gate's marker\n"
    res = _port(src, "disco_tpu_torch/enhance/foo.py", rules={"DL007"})
    assert [f.rule for f in res.findings] == ["DL007"] and res.suppressed == []
    res = _port(_port_text(src), "disco_tpu_torch/enhance/foo.py", rules={"DL007"})
    assert res.findings == [] and len(res.suppressed) == 1


# -- the rules re-read for torch: transliterations, same lines ----------------
#: (rule, JAX snippet, its path, torch transliteration, its port path)
TORCH_READ = [
    # DL001: a bare fence in path code, the attribute and the bare form
    ("DL001", "import jax\njax.block_until_ready(x)\n", "disco_tpu/enhance/foo.py",
     "import torch\ntorch.cuda.synchronize(x)\n", "disco_tpu_torch/enhance/foo.py"),
    ("DL001", "from jax import block_until_ready\nblock_until_ready(x)\n",
     "disco_tpu/serve/foo.py",
     "from torch.cuda import synchronize\nsynchronize(x)\n", "disco_tpu_torch/serve/foo.py"),
    ("DL001", "import jax\njax.block_until_ready(x)\n", "disco_tpu/obs/foo.py",
     "import torch\ntorch.cuda.synchronize(x)\nend.synchronize()\n",
     "disco_tpu_torch/obs/foo.py"),
    ("DL001", "import jax\njax.block_until_ready(x)\n", "disco_tpu/milestones.py",
     "import torch\ntorch.cuda.current_stream().synchronize()\n",
     "disco_tpu_torch/milestones.py"),
    ("DL001", "import jax\nx = 1\n", "disco_tpu/utils/resilience.py",
     "import torch\ndef _fence_readback(x):\n    torch.cuda.synchronize(x.device)\n",
     "disco_tpu_torch/utils/resilience.py"),
    ("DL001", "import jax\nx = 1\njax.block_until_ready(x)\n", "disco_tpu/utils/resilience.py",
     "import torch\ndef other(x):\n    torch.cuda.synchronize(x.device)\n",
     "disco_tpu_torch/utils/resilience.py"),
    ("DL001", "from mylib import synchronize\nsynchronize(x)\n", "disco_tpu/enhance/foo.py",
     "from mylib import synchronize\nsynchronize(x)\n", "disco_tpu_torch/enhance/foo.py"),
    # DL002: per-item readbacks in a loop
    ("DL002", """
    from disco_tpu.utils import to_host
    def f(xs):
        return [to_host(x) for x in xs]
    def g(xs):
        out = []
        for x in xs:
            out.append(np.asarray(x))
        return out
    """, "disco_tpu/enhance/foo.py", """
    from disco_tpu_torch.device import to_host
    def f(xs):
        return [x.item() for x in xs]
    def g(xs):
        out = []
        for x in xs:
            out.append(x.detach().cpu().numpy())
        return out
    """, "disco_tpu_torch/enhance/foo.py"),
    ("DL002", """
    from disco_tpu.utils import to_host, device_get_tree
    def f(xs):
        host = device_get_tree(xs)     # sanctioned batched path, in no loop
        one = to_host(xs[0])           # outside any loop
        for x in host:
            use(x)
        return [device_get_tree_not_really for _ in host]
    """, "disco_tpu/enhance/foo.py", """
    from disco_tpu_torch.device import to_host
    def f(xs):
        host = to_host(xs)             # sanctioned batched path, in no loop
        one = xs[0].item()             # outside any loop
        for x in host:
            use(x)
        return [d.items() for d in host]
    """, "disco_tpu_torch/enhance/foo.py"),
    ("DL002", "def f(xs):\n    return [to_host(x) for x in xs]\n", "disco_tpu/core/foo.py",
     "def f(xs):\n    return [x.cpu() for x in xs]\n", "disco_tpu_torch/core/foo.py"),
    ("DL002", "def f(xs):\n    for x in to_host(xs):\n        use(x)\n", "disco_tpu/nn/foo.py",
     "def f(xs):\n    for x in xs.tolist():\n        use(x)\n", "disco_tpu_torch/nn/foo.py"),
    ("DL002", "def f(xs):\n    while to_host(xs).any():\n        step()\n", "disco_tpu/nn/foo.py",
     "def f(xs):\n    while xs.any().item():\n        step()\n", "disco_tpu_torch/nn/foo.py"),
    ("DL002", "def f(xs):\n    return [v for x in xs for v in to_host(x)]\n",
     "disco_tpu/nn/foo.py",
     "def f(xs):\n    return [v for x in xs for v in x.tolist()]\n", "disco_tpu_torch/nn/foo.py"),
    # DL003: raw crossings in the readback seam's scope
    ("DL003", "import jax\na = jax.device_get(x)\nb = jax.device_put(y)\n",
     "disco_tpu/serve/foo.py",
     "import torch\na = x.cpu()\nb = y.to('cpu')\n", "disco_tpu_torch/serve/foo.py"),
    ("DL003", "from jax import device_get\na = device_get(x)\n", "disco_tpu/serve/foo.py",
     "import torch\na = x.detach().numpy()\n", "disco_tpu_torch/enhance/streaming.py"),
    ("DL003", """
    from disco_tpu.utils import device_get_tree
    from mylib import device_get
    a = device_get_tree(x)
    b = device_get(x)
    """, "disco_tpu/serve/foo.py", """
    from disco_tpu_torch.device import to_host
    from mylib import device_get
    a = to_host([x])
    b = x.to(dev)
    """, "disco_tpu_torch/serve/foo.py"),
    ("DL003", "import jax\na = jax.device_get(x)\n", "disco_tpu/utils/transfer.py",
     "import torch\na = x.cpu()\n", "disco_tpu_torch/device.py"),
    ("DL003", "import jax\na = jax.device_get(x)\n", "disco_tpu/utils/transfer.py",
     "a = s.item()\n", "disco_tpu_torch/serve/protocol.py"),
    # DL012: abs of a fresh STFT, bf16 cast literals
    ("DL012", """
    import jax.numpy as jnp
    from disco_tpu.core.dsp import stft
    def features(y):
        return jnp.abs(stft(y))
    """, "disco_tpu/enhance/foo.py", """
    import torch
    from disco_tpu_torch.core.dsp import stft
    def features(y):
        return torch.abs(stft(y))
    """, "disco_tpu_torch/enhance/foo.py"),
    ("DL012", """
    import numpy as np
    from disco_tpu.ops.stft_ops import stft_matmul
    mag = np.abs(stft_matmul(y))
    """, "disco_tpu/nn/feats.py", """
    import torch
    from disco_tpu_torch.ops.stft_ops import stft_matmul
    mag = stft_matmul(y).abs()
    """, "disco_tpu_torch/nn/feats.py"),
    ("DL012", """
    import jax.numpy as jnp
    def f(x):
        return x.astype("bfloat16")
    """, "disco_tpu/enhance/foo.py", """
    import torch
    def f(x):
        return x.to(torch.bfloat16)
    """, "disco_tpu_torch/enhance/foo.py"),
    ("DL012", """
    import jax.numpy as jnp
    def f(x):
        y = x.astype(jnp.bfloat16)
        z = jnp.zeros((3,), dtype=jnp.bfloat16)
        return y, z
    """, "disco_tpu/serve/foo.py", """
    import torch
    def f(x):
        y = x.bfloat16()
        z = torch.zeros((3,), dtype=torch.bfloat16)
        return y, z
    """, "disco_tpu_torch/serve/foo.py"),
    ("DL012", """
    import jax.numpy as jnp
    from disco_tpu.core.dsp import stft
    def f(y):
        spec = stft(y)
        mag = jnp.abs(spec)
        g = mag.astype("float32")
        return tango(spec, precision="bf16")   # requesting the lane is the point
    """, "disco_tpu/enhance/foo.py", """
    import torch
    from disco_tpu_torch.core.dsp import stft
    def f(y):
        spec = stft(y)
        mag = spec.abs()
        g = mag.to(torch.float32)
        return g.dtype == torch.bfloat16 or tango(spec, precision="bf16")
    """, "disco_tpu_torch/enhance/foo.py"),
    ("DL012", """
    import jax.numpy as jnp
    from disco_tpu.core.dsp import stft
    def stft_with_mag(y):
        return jnp.abs(stft(y)), y.astype(jnp.bfloat16)
    """, "disco_tpu/ops/stft_ops.py", """
    import torch
    from disco_tpu_torch.core.dsp import stft
    def stft_with_mag(y):
        return torch.abs(stft(y)), y.to(torch.bfloat16)
    """, "disco_tpu_torch/ops/stft_ops.py"),
    # DL016: fused-solve selection and kernel routing
    ("DL016", """
    from disco_tpu.ops.mwf_ops import rank1_gevd_fused
    def solve(Rss, Rnn):
        return rank1_gevd_fused(Rss, Rnn, impl="pallas")
    """, "disco_tpu/enhance/foo.py", """
    from disco_tpu_torch.ops.mwf_ops import rank1_gevd_fused
    def solve(Rss, Rnn):
        return rank1_gevd_fused(Rss, Rnn, impl="kernel")
    """, "disco_tpu_torch/enhance/foo.py"),
    ("DL016", """
    from disco_tpu.ops import mwf_ops
    impl = mwf_ops.resolve_mwf_impl("auto")
    w, t1 = mwf_ops.fused_mwf_pallas(Rss, Rnn)
    """, "disco_tpu/serve/scheduler.py", """
    from disco_tpu_torch.ops import mwf_ops
    w0, _ = mwf_ops.fused_mwf_plain(Rss, Rnn)
    w, t1 = mwf_ops.fused_mwf_kernel(Rss, Rnn)
    """, "disco_tpu_torch/serve/scheduler.py"),
    ("DL016", """
    def pick(solver):
        if solver == "fused":
            return 1
        if solver in ("fused-pallas", "eigh"):
            return 2
        return 0
    """, "disco_tpu/cli/foo.py", """
    def pick(solver):
        if solver == "fused":
            return 1
        if solver in ("fused-pallas", "eigh"):
            return 2
        return 0
    """, "disco_tpu_torch/cli/foo.py"),
    ("DL016", """
    def pick(solver):
        if solver.startswith("fused"):
            return 1
        return 0
    """, "disco_tpu/enhance/foo.py", """
    def pick(solver):
        if solver.startswith("fused"):
            return 1
        return 0
    """, "disco_tpu_torch/enhance/foo.py"),
    ("DL016", """
    from disco_tpu.beam.filters import rank1_gevd
    def run(Rss, Rnn):
        w, _ = rank1_gevd(Rss, Rnn, solver="fused")
        mode = "offline"
        if mode == "streaming":
            pass
        return w
    """, "disco_tpu/enhance/foo.py", """
    from disco_tpu_torch.beam.filters import rank1_gevd
    from disco_tpu_torch.ops import _build
    def run(Rss, Rnn):
        w, _ = rank1_gevd(Rss, Rnn, solver="fused")
        mode = _build.build_dir()       # reading the build's path launches nothing
        if mode == "streaming":
            pass
        return w
    """, "disco_tpu_torch/enhance/foo.py"),
    ("DL016", """
    from disco_tpu.ops.mwf_ops import rank1_gevd_fused
    def dispatch(base):
        if base == "fused":
            return rank1_gevd_fused
    """, "disco_tpu/beam/filters.py", """
    from disco_tpu_torch.ops.mwf_ops import rank1_gevd_fused
    def dispatch(base):
        if base == "fused":
            return rank1_gevd_fused
    """, "disco_tpu_torch/beam/filters.py"),
]

#: DL016's kernel routing, which the JAX rule has no shape for: (source,
#: port path, the lines it must flag)
KERNEL_ROUTING = [
    ("import torch\nfrom disco_tpu_torch.ops import _build\n_build.load()\n"
     "torch.ops.disco_torch.fused_mwf(Rss, Rnn)\n", "disco_tpu_torch/cli/foo.py", [3, 4]),
    ("from disco_tpu_torch.ops._build import kernel_op as k\nop = k(schema, cuda, cpu, fake)\n",
     "disco_tpu_torch/enhance/foo.py", [2]),
    ("import disco_tpu_torch.ops._build as b\nb.build()\n", "chip_smoke.py", [2]),
    ("import torch\ntorch.ops.disco_torch.stft(x)\n", "disco_tpu_torch/beam/filters.py", [2]),
    # the wrappers are the sanctioned path; ops/ itself is the implementation;
    # reading the build's paths launches nothing
    ("from disco_tpu_torch.ops import stft_ops, _build\nstft_ops.stft_kernel(x)\n"
     "where = _build.build_dir()\nlog = _build.ptxas_log()\n",
     "disco_tpu_torch/enhance/foo.py", []),
    ("import torch\nfrom disco_tpu_torch.ops import _build\n_build.load()\n"
     "torch.ops.disco_torch.stft(x)\n", "disco_tpu_torch/ops/stft_ops.py", []),
]


@pytest.mark.parametrize("src,rel,lines", KERNEL_ROUTING,
                         ids=[str(i) for i in range(len(KERNEL_ROUTING))])
def test_dl016_kernel_routing(src, rel, lines):
    assert _lines(_port(src, rel, rules={"DL016"})) == lines


def _lines(res):
    return sorted(f.line for f in res.findings)


@pytest.mark.parametrize("rule,jsrc,jrel,tsrc,trel", TORCH_READ,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(TORCH_READ)])
def test_torch_read_rules_flag_the_same_lines(rule, jsrc, jrel, tsrc, trel):
    want = _lines(_jax(jsrc, jrel, rules={rule}))
    assert _lines(_port(tsrc, trel, rules={rule})) == want


def test_every_torch_read_rule_has_a_flagged_and_a_clean_case():
    for rule in ("DL001", "DL002", "DL003", "DL012", "DL016"):
        counts = [len(_port(t, r, rules={rule}).findings)
                  for rid, _, _, t, r in TORCH_READ if rid == rule]
        assert any(counts) and not all(counts), rule


@pytest.mark.parametrize("src,rel", [
    ("import jax\ndef f(xs):\n    return jax.lax.scan(body, init, xs)\n",
     "disco_tpu/enhance/streaming.py"),
    ("import jax\ndef f(xs):\n    return jax.lax.scan(body, init, xs)\n",
     "disco_tpu/serve/scheduler.py"),
    ("from jax.lax import scan\nscan(body, init, xs)\n", "disco_tpu/enhance/streaming.py"),
])
def test_dl011_has_no_counterpart(src, rel):
    assert _jax(src, rel, rules={"DL011"}).findings     # the JAX rule flags it...
    res = _port(src, _port_text(rel), rules={"DL011"})  # ...the port's never does
    assert res.findings == []
    rule = analysis.get_rules()["DL011"]
    assert "no counterpart" in rule.summary


def test_catalog_matches_the_jax_catalog():
    jax_rules, rules = jax_analysis.get_rules(), analysis.get_rules()
    assert list(rules) == list(jax_rules)
    assert [r.name for r in rules.values()] == [r.name for r in jax_rules.values()]


# -- the port tree -------------------------------------------------------------
@pytest.fixture(scope="module")
def audit():
    """The port tree linted with every waiver ignored."""
    return analysis.lint_paths(use_suppressions=False)


def test_port_tree_lints_clean():
    res = analysis.lint_paths()
    assert res.findings == [], "\n".join(f.render() for f in res.findings)
    assert res.n_files > 150
    assert all(just.strip() for _, just in res.suppressed)


def _shipped_waivers(tool, known, hygiene=None):
    for path in sorted((ROOT / "disco_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        rel = path.relative_to(ROOT).as_posix()
        sups, problems = sup.parse(rel, path.read_text(), known, tool=tool, hygiene_rule=hygiene)
        assert problems == []
        yield from ((rel, s) for s in sups)


def test_every_shipped_suppression_is_load_bearing(audit):
    """Removing any waiver brings its finding back: each names a rule that
    fires on its line (or, file-wide, in its file) when waivers are off."""
    at_line = {(f.path, f.rule, f.line) for f in audit.findings}
    in_file = {(f.path, f.rule) for f in audit.findings}
    waivers = list(_shipped_waivers("disco-torch-lint", known_rule_ids()))
    assert len(waivers) >= 12
    for rel, s in waivers:
        hit = (rel, s.rule_id) in in_file if s.line is None else (rel, s.rule_id, s.line) in at_line
        assert hit, f"{rel}:{s.comment_line} waives {s.rule_id}, which no longer fires"


def test_the_probe_findings_are_repaired_or_waived(audit):
    got = {(f.rule, f.path) for f in audit.findings}
    for rule, rel in [("DL001", "chip_smoke.py"), ("DL002", "disco_tpu_torch/nn/convert.py"),
                      ("DL002", "disco_tpu_torch/serve/scheduler.py"),
                      ("DL004", "disco_tpu_torch/flywheel/check.py"),
                      ("DL004", "disco_tpu_torch/runs/check.py"),
                      ("DL008", "chip_smoke.py"), ("DL012", "chip_smoke.py"),
                      ("DL016", "chip_smoke.py")]:
        assert (rule, rel) in got, (rule, rel)
    # repaired, not waived: gone even with the waivers off
    for rule, rel in [("DL002", "disco_tpu_torch/serve/check.py"),
                      ("DL015", "disco_tpu_torch/obs/accounting.py"),
                      ("DL016", "disco_tpu_torch/beam/filters.py")]:
        assert (rule, rel) not in got, (rule, rel)


def test_report_schema_matches_the_jax_report():
    src = "import jax\nf(mu=1)  # disco-lint: disable=DL007 -- pinned fixture\nf(lambda_cor=0)\n"
    j = json.loads(jax_report.format_json(_jax(src, "disco_tpu/enhance/foo.py", rules={"DL007"})))
    p = json.loads(report.format_json(_port(_port_text(src), "disco_tpu_torch/enhance/foo.py",
                                            rules={"DL007"})))
    assert set(p) == set(j) == {"clean", "counts", "findings", "suppressed"}
    assert set(p["counts"]) == set(j["counts"])
    assert [set(f) for f in p["findings"]] == [set(f) for f in j["findings"]]
    assert [set(f) for f in p["suppressed"]] == [set(f) for f in j["suppressed"]]
    assert p["counts"]["by_rule"] == j["counts"]["by_rule"] == {"DL007": 1}


def test_cli_exit_codes(tmp_path, capsys):
    from disco_tpu_torch.analysis import cli

    bad = tmp_path / "bad.py"
    bad.write_text("f(mu=1)\n")
    assert cli.main([str(bad), "--format", "json", "--rules", "DL007"]) == 1
    assert json.loads(capsys.readouterr().out)["counts"]["by_rule"] == {"DL007": 1}
    assert cli.main([str(bad), "--rules", "DL001"]) == 0
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "DL011" in out and "no counterpart" in out
    assert cli.main([str(bad), "--rules", "DLXXX"]) == 2
    assert cli.main([str(tmp_path / "missing.py")]) == 2
    assert cli.main([str(bad), "--no-suppressions", "--rules", "DL007"]) == 1


def test_seams_equal_the_jax_set_and_cover_every_tick():
    seams = registries.chaos_seams(ROOT)
    assert seams == jax_registries.chaos_seams(ROOT)
    assert len(seams) == 15
    ticked = set()
    for path in (ROOT / "disco_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "tick" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                ticked.add(node.args[0].value)
    assert ticked and ticked <= seams
    # DL010 reads it: a typo'd seam is a finding
    res = _port("from disco_tpu_torch.runs import chaos\nchaos.tick('serve_tock')\n",
                "disco_tpu_torch/serve/foo.py", rules={"DL010"})
    assert [f.rule for f in res.findings] == ["DL010"]


def test_registries_are_the_ports_and_a_missing_one_raises(tmp_path):
    assert {"clip", "fault", "span"} <= registries.event_kinds(ROOT)
    assert {"dispatch", "readback", "tap"} <= registries.span_stages(ROOT)
    assert {"counters", "sessions"} <= registries.status_sections(ROOT)
    fake = tmp_path / "disco_tpu_torch" / "runs"
    fake.mkdir(parents=True)
    (fake / "chaos.py").write_text("OTHER = frozenset({'x'})\n")
    with pytest.raises(registries.RegistryExtractionError):
        registries.chaos_seams(tmp_path)


def _analysis_modules():
    base = ROOT / "disco_tpu_torch" / "analysis"
    return sorted([*base.glob("*.py"), *(base / "rules").glob("*.py"), *(base / "race").glob("*.py")])


def test_linter_and_race_modules_import_only_the_stdlib_and_themselves():
    mods = _analysis_modules()
    assert len(mods) == 9 + 15 + 8
    for path in mods:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("torch", "jax", "jaxlib", "triton", "disco_tpu"), (path, name)
                if top == "disco_tpu_torch":
                    assert name.startswith("disco_tpu_torch.analysis"), (path, name)
                    assert not name.startswith(("disco_tpu_torch.analysis.trace",
                                                "disco_tpu_torch.analysis.meter")), (path, name)
