"""Deterministic crash injection at configurable seams (the port's copy of
``disco_tpu/runs/chaos.py``).

A crash-safety claim is untestable without crashes, so the chaos harness
*simulates* the crash in-process: production code calls :func:`tick` at its
crash seams, and when a seam is armed the Nth hit raises
:class:`ChaosCrash` — a ``BaseException`` subclass, so it unwinds through
every ``except Exception`` guard exactly like a process death would.

Seams wired through the port (each a named :func:`tick` call):

* ``mid_write``      — inside :func:`disco_tpu_torch.io.atomic.atomic_write`,
  after the payload bytes but before the atomic rename.
* ``between_clips``  — after one RIR's artifacts are fully persisted
  (``enhance/driver.py``).
* ``pre_dispatch``   — before a batched chunk is dispatched to the device
  (``enhance/driver.py``).
* ``chunk_load``     — at the start of a corpus chunk's wav ingest, right
  after its ledger ``in_flight`` marks (``enhance/driver.py``).  Under the
  pipelined engine this seam runs on the PREFETCH thread; the injected
  ``ChaosCrash`` is re-delivered at the consuming dispatch loop
  (``enhance/pipeline.ChunkPrefetcher``).
* ``between_blocks`` — on every chunk-continuation call of the streaming
  entry points (``enhance/streaming.py``: a call that carries a state).
* ``serve_tick``     — at the top of every serve scheduler tick, on the
  dispatch thread (``serve/scheduler.py``).
* ``pre_fence``      — before the milestone harness's one-element fence
  (``milestones.py::_fence_readback``).
* ``mid_epoch``      — in ``nn/training.py::fit``, after an epoch's
  training pass and before its validation, losses and checkpoint: nothing
  of the epoch is persisted, so a resume redoes the whole epoch.
* ``between_scenes`` — after one generated scene is saved
  (``datagen/disco.py``, both drivers).
* ``between_scene_batches`` — after one simulated scene batch's training
  windows are fully yielded (``scenes/stream.py``) and after one chunk of
  the batched datagen driver is fully saved (``datagen/disco.py``): the
  scene factory's clean boundary.
* ``pre_swap``       — on the serve dispatch thread, before a model
  session moves to another weight generation (``serve/scheduler.py``).
* ``mid_canary`` / ``post_gate`` — on the promotion controller's thread,
  while a canary window is judged and after its verdict, before the ledger
  records it (``promote/controller.py``).
* ``pre_publish`` / ``between_generations`` — in the co-resident trainer,
  after an epoch's checkpoint and before its generation is staged, and
  after a generation lands (``flywheel/resident.py``).

Injection is armed either programmatically (:func:`configure`) or via the
``DISCO_TPU_CHAOS`` environment variable (``"seam"`` or ``"seam:N"`` —
crash at the Nth hit, default 1), read once at first :func:`tick`; the same
variable arms both packages.  The plan is deterministic: same seam, same
N, same run → same crash point.

A seam that fires ticks ``chaos_crashes``, records a ``fault`` event
(``fault="chaos_crash"``, the hit and the seam's attributes) and dumps the
armed flight recorder before it raises.

Disabled cost: one module-level ``is None`` check per tick.
"""
from __future__ import annotations

import os
import threading

#: The closed set of production crash seams (each documented in the module
#: docstring above; the JAX package's ``disco_tpu/runs/chaos.py:92-110``
#: declares the same fifteen).  ``disco-torch-lint`` rule DL010 checks every
#: ``tick("<seam>")`` string literal in the port against this registry — a
#: typo'd seam name would otherwise arm nothing and a chaos experiment
#: would silently test nothing.  Runtime stays permissive (tests arm
#: synthetic seams); registration is a lint-time contract.
SEAMS = frozenset(
    {
        "mid_write",       # io/atomic.py::atomic_write, bytes written, not renamed
        "between_clips",   # enhance/driver.py, after one RIR persisted
        "mid_epoch",       # nn/training.py::fit and flywheel/resident.py, post-train pre-checkpoint
        "between_scenes",  # datagen/disco.py, after one scene saved
        "pre_fence",       # milestones.py::_fence_readback, before the 1-element readback
        "pre_dispatch",    # enhance/driver.py, chunk about to dispatch
        "chunk_load",      # enhance/driver.py, on the prefetch thread
        "between_blocks",  # enhance/streaming.py, streaming block loop
        "serve_tick",      # serve/scheduler.py, top of a scheduler tick
        "pre_swap",        # serve/scheduler.py, swap decided but not yet applied
        "mid_canary",      # promote/controller.py, canary window open, scores partial
        "post_gate",       # promote/controller.py, verdict reached, ledger not yet final
        "pre_publish",     # flywheel/resident.py, checkpoint done, generation not staged
        "between_generations",  # flywheel/resident.py, one generation fully published
        "between_scene_batches",  # scenes/stream.py + datagen/disco.py, one scene batch complete
    }
)


class ChaosCrash(BaseException):
    """An injected crash.  Inherits ``BaseException`` (like
    ``KeyboardInterrupt``) so pipeline-internal ``except Exception``
    recovery cannot swallow it: a simulated process death must kill the
    run, that is its job."""

    def __init__(self, seam: str, hit: int):
        super().__init__(f"injected chaos crash at seam {seam!r} (hit {hit})")
        self.seam = seam
        self.hit = hit


class _Plan:
    __slots__ = ("seam", "after", "hits", "lock")

    def __init__(self, seam: str, after: int):
        if after < 1:
            raise ValueError(f"chaos 'after' must be >= 1, got {after}")
        self.seam = seam
        self.after = after
        self.hits = 0
        self.lock = threading.Lock()


_PLAN: _Plan | None = None
_ENV_READ = False

#: Environment switch: ``DISCO_TPU_CHAOS="between_clips"`` or
#: ``DISCO_TPU_CHAOS="mid_write:3"`` (crash at the 3rd hit).
ENV_VAR = "DISCO_TPU_CHAOS"


def configure(seam: str, after: int = 1) -> None:
    """Arm the chaos plan: raise :class:`ChaosCrash` at the ``after``-th
    :func:`tick` of ``seam``.  One seam at a time."""
    global _PLAN, _ENV_READ
    _PLAN = _Plan(seam, after)
    _ENV_READ = True  # explicit configuration wins over the env var


def disable() -> None:
    """Disarm injection (the resume half of an interrupt-resume test)."""
    global _PLAN, _ENV_READ
    _PLAN = None
    _ENV_READ = True


def active() -> bool:
    """True when a chaos plan is armed."""
    return _PLAN is not None


def _maybe_read_env() -> None:
    global _ENV_READ, _PLAN
    if _ENV_READ:
        return
    _ENV_READ = True
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return
    seam, _, n = spec.partition(":")
    _PLAN = _Plan(seam.strip(), int(n) if n else 1)


def tick(seam: str, **attrs) -> None:
    """Production crash seam: no-op unless chaos is armed for ``seam``, in
    which case the configured hit raises :class:`ChaosCrash` after
    recording a ``fault`` event (``fault="chaos_crash"``) with ``attrs``."""
    if _PLAN is None:
        _maybe_read_env()
        if _PLAN is None:
            return
    plan = _PLAN
    if plan is None or plan.seam != seam:
        return
    with plan.lock:
        plan.hits += 1
        hit = plan.hits
    if hit != plan.after:
        return
    from disco_tpu_torch.obs import events as _events
    from disco_tpu_torch.obs import flight as _flight
    from disco_tpu_torch.obs.metrics import REGISTRY as _REGISTRY

    _REGISTRY.counter("chaos_crashes").inc()
    _events.record("fault", stage=seam, fault="chaos_crash", hit=hit, **attrs)
    # the flight ring's last act before the simulated death (no-op unless
    # armed; the dump is atomic)
    _flight.auto_dump("chaos_crash", reason=f"seam {seam!r} hit {hit}")
    raise ChaosCrash(seam, hit)


def _reset_for_tests() -> None:
    """Re-arm env reading (test isolation; never called in production)."""
    global _PLAN, _ENV_READ
    _PLAN = None
    _ENV_READ = False
