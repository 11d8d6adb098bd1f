"""The degradation ladder: a deterministic overload/distress controller
(the port's copy of ``disco_tpu/serve/ladder.py``: the same metric trace
walks the same rungs in either package).

Between "serve normally" and "reject at the door" the server previously had
nothing: sustained admission past capacity just grew queue waits until
clients timed out, and a distressed device (dispatch-deadline hits) kept
being fed full-width super-ticks.  The ladder gives overload a graded
answer — a small pure controller stepped once per scheduler tick from two
inputs (recent queue-wait p95 and the tick's dispatch-deadline hits), fully
deterministic given that metric trace:

* **rung 0** ``full``      — normal serving, nothing shed.
* **rung 1** ``per_block`` — super-ticks shrink to the per-block path
  (``blocks_per_super_tick`` → 1): smallest dispatch units, lowest
  per-block admission wait.
* **rung 2** ``no_tap``    — the flywheel corpus tap is disabled (the
  port's server has no tap yet, so the rung changes nothing there).
* **rung 3** ``shed``      — newest non-priority sessions are parked with a
  resume token (one per tick while the rung holds): the client backs off
  and reattaches when load drops, instead of every session timing out.

Steps UP happen immediately when a tick's metrics breach the high
thresholds (overload must be answered now); steps DOWN require
``recover_ticks`` consecutive calm ticks (hysteresis — no rung flapping).
Every transition is first-class telemetry: a ``degraded`` obs event on the
way up, a ``recovery`` event on the way down, and the ``ladder_rung``
gauge.

The controller itself never touches the device, sessions or sockets: it
returns the target rung and the scheduler applies the effects.
"""
from __future__ import annotations

from disco_tpu_torch.obs import events as obs_events
from disco_tpu_torch.obs.metrics import REGISTRY as obs_registry

#: Rung names, index == rung number (rendered in events and the docs).
RUNGS = ("full", "per_block", "no_tap", "shed")


class DegradationLadder:
    """Deterministic rung controller (module docstring has the rung map).

    Args:
      p95_high_ms / p95_low_ms: queue-wait p95 thresholds — a tick with
        p95 above ``high`` steps up; only ticks with p95 below ``low``
        count toward recovery (the gap is the hysteresis band).
      deadline_hits_high: dispatch-deadline hits in one tick that step up
        regardless of queue waits (device distress, not load).
      recover_ticks: consecutive calm ticks required per step DOWN.
      max_rung: highest rung this ladder may reach (the overload drill of
        ``serve.check`` caps at 2 so no parity client is ever shed).
    """

    def __init__(self, *, p95_high_ms: float = 500.0, p95_low_ms: float = 100.0,
                 deadline_hits_high: int = 1, recover_ticks: int = 25,
                 max_rung: int = 3):
        if not 0 < p95_low_ms <= p95_high_ms:
            raise ValueError(
                f"need 0 < p95_low_ms <= p95_high_ms, got "
                f"{p95_low_ms}/{p95_high_ms}"
            )
        if not 0 <= max_rung < len(RUNGS):
            raise ValueError(f"max_rung must be in [0, {len(RUNGS) - 1}], got {max_rung}")
        if recover_ticks < 1 or deadline_hits_high < 1:
            raise ValueError("recover_ticks and deadline_hits_high must be >= 1")
        self.p95_high_ms = p95_high_ms
        self.p95_low_ms = p95_low_ms
        self.deadline_hits_high = deadline_hits_high
        self.recover_ticks = recover_ticks
        self.max_rung = max_rung
        self.rung = 0
        self._calm = 0
        #: (tick, from_rung, to_rung, reason) transition history (the soak
        #: gate asserts recovery; bounded by construction — each entry is a
        #: real transition)
        self.transitions: list = []

    def observe(self, *, queue_wait_p95_ms: float, deadline_hits: int,
                tick: int) -> int:
        """One controller step: fold this tick's metrics, return the rung.

        Pure given its inputs — same metric trace, same rung trace."""
        hot = (queue_wait_p95_ms > self.p95_high_ms
               or deadline_hits >= self.deadline_hits_high)
        calm = queue_wait_p95_ms < self.p95_low_ms and deadline_hits == 0
        if hot and self.rung < self.max_rung:
            self._calm = 0
            self._step(tick, self.rung + 1,
                       f"queue_wait_p95_ms={queue_wait_p95_ms:.1f} "
                       f"deadline_hits={deadline_hits}")
        elif hot:
            self._calm = 0
        elif calm and self.rung > 0:
            self._calm += 1
            if self._calm >= self.recover_ticks:
                self._calm = 0
                self._step(tick, self.rung - 1,
                           f"calm for {self.recover_ticks} ticks "
                           f"(p95={queue_wait_p95_ms:.1f}ms)")
        else:
            self._calm = 0
        return self.rung

    def _step(self, tick: int, to_rung: int, reason: str) -> None:
        frm, self.rung = self.rung, to_rung
        self.transitions.append((tick, frm, to_rung, reason))
        obs_registry.gauge("ladder_rung").set(to_rung)
        kind = "degraded" if to_rung > frm else "recovery"
        obs_events.record(
            kind, stage="serve", controller="ladder", tick=tick,
            from_rung=frm, rung=to_rung,
            from_mode=RUNGS[frm], mode=RUNGS[to_rung], reason=reason,
        )
        if to_rung > frm:
            obs_registry.counter("ladder_degrades").inc()
            from disco_tpu_torch.obs import flight as obs_flight

            # a step-up is distress: dump the flight ring so the post-
            # mortem has the ticks/spans that led here (no-op unless armed)
            obs_flight.auto_dump(
                "ladder_step_up",
                reason=f"rung {frm}->{to_rung} ({RUNGS[to_rung]}): {reason}",
            )
        else:
            obs_registry.counter("ladder_recoveries").inc()
