"""Graceful interruption: SIGTERM/SIGINT → finish the unit, flush, exit
resumable (the port's copy of ``disco_tpu/runs/interrupt.py``).

* the **first** SIGTERM/SIGINT sets a flag and returns — nothing else: no
  exception into the pipeline, so the in-flight chunk completes and
  persists (atomically, ``disco_tpu_torch.io.atomic``);
* the long-running loops (the batched corpus driver's chunks) poll
  :func:`stop_requested` between units and wind down: drain scoring, flush
  the run ledger, return partial results — the run is then resumable with
  ``resume=True``;
* a **second** SIGINT raises ``KeyboardInterrupt`` — the operator insists.

Handlers install only in the main thread (Python's signal rule); from
worker threads :class:`GracefulInterrupt` degrades to a pure poll flag that
:func:`request_stop` can set programmatically (tests, embedders).

The first poll after a stop ticks ``interrupts`` and records one
``interrupted`` event (the signal handler itself only sets flags).
"""
from __future__ import annotations

import contextlib
import signal
import threading

_lock = threading.Lock()
_active: list["GracefulInterrupt"] = []


def stop_requested() -> bool:
    """True once a graceful stop was requested anywhere in the process.
    The poll the long-running loops call between work units; False when no
    :class:`GracefulInterrupt` scope is active.  Polling also records the
    telemetry a signal handler deferred."""
    with _lock:
        scopes = list(_active)
    for g in scopes:
        g._flush_telemetry()
    return any(g.stopped for g in scopes)


def request_stop(reason: str = "programmatic") -> bool:
    """Programmatically request a graceful stop on the innermost active
    scope.  Returns False when no scope is active."""
    with _lock:
        if not _active:
            return False
        scope = _active[-1]
    scope._trip(reason)
    return True


class GracefulInterrupt(contextlib.AbstractContextManager):
    """Scoped SIGTERM/SIGINT handler implementing the drain-and-exit
    protocol.

    >>> with GracefulInterrupt() as stop:
    ...     for unit in work:
    ...         if stop():          # or runs.interrupt.stop_requested()
    ...             break           # ledger flushed by the caller; resumable
    ...         process(unit)

    ``as``-binds a zero-argument callable returning the stop flag, so deep
    call sites can also poll the module-level :func:`stop_requested`.
    """

    def __init__(self, signals=(signal.SIGINT, signal.SIGTERM)):
        self.signals = tuple(signals)
        self.stopped = False
        self.reason: str | None = None
        self._prev: dict[int, object] = {}
        self._installed = False
        self._sigint_count = 0
        self._telemetry_sent = False

    def _trip(self, reason: str) -> None:
        """Programmatic stop (``request_stop``, tests): set the flags and
        record at once."""
        # disco-torch-race: disable=DR007 -- monotonic one-way flag: _trip (main) and the handler both only ever store True; a racing pair of stores is idempotent
        self.stopped = True
        self.reason = self.reason or reason  # disco-torch-race: disable=DR007 -- first-writer-wins string; both writers guard with `or`, and a torn outcome only affects the human-readable reason label
        self._flush_telemetry()

    def _flush_telemetry(self) -> None:
        """Record the one ``interrupted`` event and ``interrupts`` tick of a
        stop, once, from normal code (never from the handler).  The sent
        flag flips under the lock; the event is recorded outside it."""
        if not self.stopped or self._telemetry_sent:
            return
        with _lock:
            if self._telemetry_sent:
                return
            self._telemetry_sent = True
        from disco_tpu_torch.obs import events as _events
        from disco_tpu_torch.obs.metrics import REGISTRY as _REGISTRY

        _REGISTRY.counter("interrupts").inc()
        _events.record("interrupted", reason=self.reason)

    def _handler(self, signum, frame):
        # flag-only: a signal handler runs at an arbitrary bytecode boundary,
        # possibly inside a lock; it stores the flags and returns
        name = signal.Signals(signum).name
        if signum == signal.SIGINT:
            self._sigint_count += 1
            if self._sigint_count >= 2:
                raise KeyboardInterrupt(f"second {name}")
        self.stopped = True
        self.reason = self.reason or name

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in self.signals:
                self._prev[sig] = signal.getsignal(sig)
                signal.signal(sig, self._handler)
            self._installed = True
        with _lock:
            _active.append(self)

        def stopped():
            self._flush_telemetry()
            return self.stopped

        return stopped

    def __exit__(self, *exc):
        with _lock:
            with contextlib.suppress(ValueError):
                _active.remove(self)
        if self._installed:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)  # disco-torch-race: disable=DR001 -- restores the handler SAVED at __enter__ (whatever was installed before this scope); there is no static target to register
            self._installed = False
        self._flush_telemetry()  # a trip no poll observed still records
        return False
