"""disco_tpu_torch.analysis.race — static thread-contract analysis (the
port's ``disco-torch-race``; counterpart of ``disco_tpu/analysis/race``).

The port's serve stack runs an asyncio I/O thread against a single device
dispatch thread, with the corpus prefetch loader, ``prefetch_to_device``'s
feeder, the corpus-tap writer, watchdog timers, the promotion controller,
client readers, loader pools and signal handlers around it — and every
invariant that keeps those from deadlocking or from queueing work on the
card out of turn ("ONE thread launches the kernels", "handlers only set
flags", "never block a tick holding the registry lock") is checked here
over a statically built call graph, with the JAX package's checks DR001 and
DR003–DR008 unchanged and DR002 re-read for torch.

Like :mod:`disco_tpu_torch.analysis` (disco-torch-lint) the analyzer is
stdlib-only: no torch or jax import anywhere under ``race/`` (pinned by
test), so the gate is hermetic, touches no device and takes no
``--device``.

* :mod:`.roles`      — the declared thread-role registry (every spawn site
  must resolve into it) + the explicit dynamic-dispatch fallbacks
* :mod:`.registries` — the named-lock registry (every ``threading.Lock``
  must be a registered module- or instance-level attribute)
* :mod:`.callgraph`  — AST index + module-qualified call resolution
* :mod:`.checks`     — the DRnnn contract checks (catalog in its docstring)
* :mod:`.manifest`   — the committed concurrency manifest
  (``analysis/golden/threads.json``) and its drift diff
* :mod:`.runner`     — the whole-program engine (:func:`analyze`)
* :mod:`.cli`        — the ``disco-torch-race`` console entry

Suppressions reuse the shared machinery of
:mod:`disco_tpu_torch.analysis.suppressions` with the ``disco-torch-race``
marker::

    self.expired = True  # disco-torch-race: disable=DR007 -- single bool store

No reference counterpart: the reference repo is single-threaded end to end
and has no static analysis of any kind.
"""
from disco_tpu_torch.analysis.race.runner import RaceResult, analyze

__all__ = ["RaceResult", "analyze"]
