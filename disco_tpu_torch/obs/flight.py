"""The flight recorder: a bounded in-memory ring of recent telemetry,
dumped atomically when something goes wrong (the port's copy of
``disco_tpu/obs/flight.py``).

When armed, every obs event and causal span is also appended to a bounded
per-subsystem ring (one deque append, no I/O), and the trigger sites —
session quarantine, park, dispatch-deadline watchdog trips,
degradation-ladder step-ups — dump the ring through
:func:`disco_tpu_torch.io.atomic.atomic_write`, so the final dump path is
either complete or absent.

Dumps are byte-stable: the JSON payload is a pure function of the ring
contents (sorted keys, fixed separators), so dumping the same state twice
yields identical bytes, and the dump is the JAX package's format.  Like the
event recorder and the tracer, the process-global :class:`FlightRecorder`
is a strict no-op while disabled, and :func:`auto_dump` swallows I/O
errors into a counter: no flight failure breaks the pipeline it observes.
"""
from __future__ import annotations

import collections
import json
import threading
import time

from disco_tpu_torch.obs import events as _events
from disco_tpu_torch.obs import metrics as _metrics

#: Default per-subsystem ring depth (entries, not bytes).
DEFAULT_CAPACITY = 256

#: The dump triggers wired through the stack (documentation + the
#: ``flight`` event's ``trigger`` attr; runtime stays permissive so tests
#: can dump under synthetic triggers).
TRIGGERS = frozenset(
    {
        "quarantine",    # serve/scheduler.py: transport budget exhausted
        "park",          # serve/scheduler.py: session parked
        "watchdog",      # serve/scheduler.py: tick blew its dispatch deadline
        "ladder_step_up",  # serve/ladder.py: the overload controller degraded
        "sentinel",      # obs/sentinels.py: non-finite tensor detected
        "chaos_crash",   # runs/chaos.py: injected in-process death
        "demotion",      # promote/controller.py: canary gate failed, rollback issued
        "manual",        # explicit dump() calls (CLI / tests)
    }
)


class FlightRecorder:
    """Bounded per-subsystem rings + atomic dump-on-trigger.

    ``enable(dump_dir=...)`` arms collection; events flow in through
    :meth:`add` (the obs recorder fans every event here — see
    ``events.Recorder.record``) keyed by their stage (falling back to the
    kind), each ring bounded at ``capacity``.  :meth:`dump` serializes a
    deterministic snapshot through ``io.atomic``; :meth:`auto_dump` is the
    trigger-site entry point — a no-op unless armed *with* a dump dir, and
    exception-free by contract.
    """

    def __init__(self):
        self.enabled = False
        self.dump_dir = None
        self.capacity = DEFAULT_CAPACITY
        self._rings: dict = {}
        self._lock = threading.Lock()
        self._dump_seq = 0
        self.entries_added = 0
        self.dumps_written = 0

    def enable(self, dump_dir=None, capacity: int = DEFAULT_CAPACITY) -> None:
        from pathlib import Path

        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        with self._lock:
            self._rings.clear()
            self.capacity = capacity
            self.dump_dir = Path(dump_dir) if dump_dir is not None else None
            self._dump_seq = 0
            self.enabled = True
        _events.refresh_sinks()

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self._rings.clear()
            self.dump_dir = None
        _events.refresh_sinks()

    # -- collection (hot path) -----------------------------------------------
    def add(self, subsystem: str, kind: str, attrs: dict,
            t_wall: float | None = None) -> None:
        """Append one entry to a subsystem's ring (bounded: the deque drops
        the oldest).  Called by the obs recorder for every event while
        armed; safe from any thread.  ``flight`` events themselves are NOT
        collected — a ring that ingests its own dump notices would never
        dump the same bytes twice (the byte-stability contract)."""
        if not self.enabled or kind == "flight":
            return
        entry = {"t": time.time() if t_wall is None else t_wall,
                 "kind": kind, "attrs": attrs}
        with self._lock:
            ring = self._rings.get(subsystem)
            if ring is None:
                ring = self._rings[subsystem] = collections.deque(
                    maxlen=self.capacity)
            ring.append(entry)
            self.entries_added += 1

    # -- snapshot / dump -----------------------------------------------------
    def snapshot(self) -> dict:
        """{subsystem: [entry, ...]} — oldest first, a deep-enough copy that
        a dump cannot race later appends."""
        with self._lock:
            return {k: [dict(e) for e in ring] for k, ring in self._rings.items()}

    def dump_bytes(self, trigger: str, reason: str | None = None,
                   snapshot: dict | None = None) -> bytes:
        """The deterministic dump payload: a pure function of the ring
        contents (sorted keys, fixed separators) — dumping unchanged state
        twice yields identical bytes (the byte-stability contract).
        ``snapshot``: reuse an already-taken :meth:`snapshot` (the dump
        path takes exactly one, so the written bytes and the dump notice
        can never disagree)."""
        payload = {
            "flight_recorder": 1,
            "trigger": trigger,
            "reason": reason,
            "capacity": self.capacity,
            "entries_added": self.entries_added,
            "subsystems": self.snapshot() if snapshot is None else snapshot,
        }
        return (json.dumps(payload, sort_keys=True, default=_events._jsonable,
                           separators=(",", ":")) + "\n").encode()

    def dump(self, path=None, *, trigger: str = "manual",
             reason: str | None = None):
        """Write the ring snapshot atomically; returns the final path (or
        None when no path could be derived).  ``path`` defaults to
        ``<dump_dir>/flight-<seq:04d>-<trigger>.json`` — the sequence
        number keeps repeated triggers from overwriting each other."""
        from pathlib import Path

        from disco_tpu_torch.io.atomic import atomic_write

        if path is None:
            if self.dump_dir is None:
                return None
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
            path = Path(self.dump_dir) / f"flight-{seq:04d}-{trigger}.json"
        snap = self.snapshot()
        data = self.dump_bytes(trigger, reason, snapshot=snap)
        path = Path(path)
        with atomic_write(path) as fh:
            fh.write(data)
        with self._lock:
            # any role's trigger site may dump (scheduler quarantine on the
            # dispatch thread, chaos seams anywhere, manual CLI calls):
            # the bump shares the ring lock like every other counter here
            self.dumps_written += 1
        _metrics.REGISTRY.counter("flight_dumps").inc()
        _events.record("flight", stage=None, trigger=trigger, reason=reason,
                       path=str(path),
                       n_entries=sum(len(v) for v in snap.values()))
        return path

    def auto_dump(self, trigger: str, reason: str | None = None):
        """The trigger-site seam: dump if armed with a dump dir, swallow
        any failure into ``flight_dump_errors`` — a post-mortem aid must
        never break the pipeline it observes (obs package contract)."""
        if not self.enabled or self.dump_dir is None:
            return None
        try:
            return self.dump(trigger=trigger, reason=reason)
        except BaseException as e:  # ChaosCrash included: a dump during a
            # simulated death must not mask the death itself
            from disco_tpu_torch.runs.chaos import ChaosCrash

            if isinstance(e, ChaosCrash):
                raise
            _metrics.REGISTRY.counter("flight_dump_errors").inc()
            return None


_FLIGHT = FlightRecorder()


def flight() -> FlightRecorder:
    """The process-global :class:`FlightRecorder`."""
    return _FLIGHT


def enabled() -> bool:
    """True while the flight recorder is collecting."""
    return _FLIGHT.enabled


def enable(dump_dir=None, capacity: int = DEFAULT_CAPACITY) -> None:
    """Arm the process-global flight recorder (``disco-serve
    --flight-dir``)."""
    _FLIGHT.enable(dump_dir=dump_dir, capacity=capacity)


def disable() -> None:
    """Disarm and clear the process-global flight recorder."""
    _FLIGHT.disable()


def auto_dump(trigger: str, reason: str | None = None):
    """Module-level :meth:`FlightRecorder.auto_dump` on the process-global
    recorder — the one-liner the trigger sites call."""
    return _FLIGHT.auto_dump(trigger, reason=reason)


def dump(path=None, *, trigger: str = "manual", reason: str | None = None):
    """Module-level :meth:`FlightRecorder.dump` on the process-global
    recorder."""
    return _FLIGHT.dump(path, trigger=trigger, reason=reason)
