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
* ``mid_epoch``      — in ``nn/training.py::fit``, after an epoch's
  training pass and before its validation, losses and checkpoint: nothing
  of the epoch is persisted, so a resume redoes the whole epoch.
* ``between_scenes`` — after one generated scene is saved
  (``datagen/disco.py``, both drivers).
* ``between_scene_batches`` — after one simulated scene batch's training
  windows are fully yielded (``scenes/stream.py``) and after one chunk of
  the batched datagen driver is fully saved (``datagen/disco.py``): the
  scene factory's clean boundary.

Injection is armed either programmatically (:func:`configure`) or via the
``DISCO_TPU_CHAOS`` environment variable (``"seam"`` or ``"seam:N"`` —
crash at the Nth hit, default 1), read once at first :func:`tick`; the same
variable arms both packages.  The plan is deterministic: same seam, same
N, same run → same crash point.

The JAX package also records a ``fault`` event and dumps its flight
recorder when a seam fires; the port has no event log yet, so it only
raises.

Disabled cost: one module-level ``is None`` check per tick.
"""
from __future__ import annotations

import os
import threading


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


def tick(seam: str) -> None:
    """Production crash seam: no-op unless chaos is armed for ``seam``, in
    which case the configured hit raises :class:`ChaosCrash`."""
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
    raise ChaosCrash(seam, hit)


def _reset_for_tests() -> None:
    """Re-arm env reading (test isolation; never called in production)."""
    global _PLAN, _ENV_READ
    _PLAN = None
    _ENV_READ = False
